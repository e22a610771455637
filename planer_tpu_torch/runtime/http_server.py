"""HTTP serving front end: /predict, /stats, /health — the port's
counterpart of ``planer_tpu/runtime/http_server.py``, stdlib
``ThreadingHTTPServer`` around a ``ServingEngine``:

  POST /predict   body: .npy bytes of ONE example (no batch dim)
                  resp: .npy bytes of the model output for that example
                        (.npz of the outputs for a multi-output model)
  GET  /stats     serving stats JSON (occupancy, p50/p99, pad fraction,
                  fused-stage fall-offs)
  GET  /health    device liveness probe JSON (``multihost.health_check``)

Requests batch continuously across connections via the engine's
dispatcher.  Status codes: 200, 400 for a body that is not an .npy array,
404 for an unknown path, 500 when the engine's future fails.
"""
from __future__ import annotations

import io
import json
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np

__all__ = ["serve", "PlanerHTTPServer"]


def _make_handler(engine, timeout_s: float):
    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):  # quiet by default
            pass

        def _send(self, code, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def _send_json(self, obj, code=200):
            self._send(code, json.dumps(obj).encode(), "application/json")

        def do_GET(self):
            if self.path == "/stats":
                self._send_json(engine.stats())
            elif self.path == "/health":
                from ..parallel.multihost import health_check
                self._send_json(health_check(deadline_s=10))
            else:
                self._send_json({"error": f"unknown path {self.path}"}, 404)

        def do_POST(self):
            if self.path != "/predict":
                self._send_json({"error": f"unknown path {self.path}"}, 404)
                return
            try:
                n = int(self.headers.get("Content-Length", 0))
                x = np.load(io.BytesIO(self.rfile.read(n)), allow_pickle=False)
            except Exception as e:
                self._send_json({"error": f"bad .npy payload: {e}"}, 400)
                return
            try:
                out = engine.submit(x).result(timeout=timeout_s)
            except Exception as e:
                self._send_json({"error": repr(e)[:300]}, 500)
                return
            buf = io.BytesIO()
            if isinstance(out, tuple):
                np.savez(buf, *[np.asarray(o) for o in out])
            else:
                np.save(buf, np.asarray(out))
            self._send(200, buf.getvalue(), "application/octet-stream")

    return Handler


class PlanerHTTPServer:
    """Threaded HTTP server wrapping a ServingEngine."""

    def __init__(self, engine, host: str = "127.0.0.1", port: int = 0,
                 timeout_s: float = 60.0):
        self.engine = engine
        self.httpd = ThreadingHTTPServer(
            (host, port), _make_handler(engine, timeout_s))
        self.port = self.httpd.server_address[1]
        self._thread = threading.Thread(target=self.httpd.serve_forever,
                                        daemon=True)

    def start(self):
        self._thread.start()
        return self

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()
        self._thread.join(timeout=5)

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


def serve(net, host: str = "127.0.0.1", port: int = 8000,
          buckets=(1, 2, 4, 8, 16, 32), max_delay_ms: float = 5.0):
    """Blocking convenience entry point: serve a Net over HTTP."""
    from .serving import ServingEngine
    with ServingEngine(net, buckets=buckets,
                       max_delay_ms=max_delay_ms) as engine:
        with PlanerHTTPServer(engine, host, port) as srv:
            print(f"serving on http://{host}:{srv.port} "
                  f"(POST /predict, GET /stats, GET /health)")
            try:
                threading.Event().wait()
            except KeyboardInterrupt:
                pass
