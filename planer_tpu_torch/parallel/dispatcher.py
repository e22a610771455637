"""Multi-host serving: a host-0 dispatcher feeding per-host workers over
the hosts' network — the port's copy of
``planer_tpu/parallel/dispatcher.py`` (which the port may not import).

The device collectives of a sharded program stay within a host
(parallel.sharding); the *request plane* rides the hosts' ordinary
network.  This module is that request plane:

  * ``Dispatcher`` — runs on host 0.  Accepts worker registrations over TCP,
    assembles request batches (same bucketing policy as
    runtime.serving.ServingEngine) and round-robins them across the healthy
    workers: the cross-host **data-parallel axis**.  Each host runs its own
    single-host (possibly device-sharded) program on its local devices, so
    no global lockstep is needed — the right topology for inference
    serving.
  * ``run_worker`` — per-host loop: receive batch, run the local net (a
    port ``Net``, whose ``__call__`` returns numpy), return the result;
    answer health pings with parallel.multihost.health_check.
  * **Failure detection is automatic**: the dispatcher pings every worker on
    an interval; a missed pong deadline, a dead socket, an unhealthy
    health_check payload, or repeated batch errors **evicts the host from
    the DP group** and re-enqueues its in-flight requests to the survivors.

The wire format is length-prefixed pickle (trusted intra-cluster links, the
same trust model as torch.distributed's own TCP store).  The module is
self-contained (stdlib + numpy only at import time) so worker subprocesses
can bootstrap it by file path without importing torch or the package —
see ``dryrun`` and tests/test_torch_dispatcher.py.
"""
from __future__ import annotations

import io
import os
import pickle
import queue
import socket
import struct
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field

import numpy as np

__all__ = ["Dispatcher", "run_worker", "dryrun"]

_LEN = struct.Struct(">Q")


def _send_msg(sock: socket.socket, obj) -> None:
    payload = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    sock.sendall(_LEN.pack(len(payload)) + payload)


def _recv_msg(sock: socket.socket):
    head = _recv_exact(sock, _LEN.size)
    (n,) = _LEN.unpack(head)
    return pickle.loads(_recv_exact(sock, n))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    buf = io.BytesIO()
    while buf.tell() < n:
        chunk = sock.recv(n - buf.tell())
        if not chunk:
            raise ConnectionError("peer closed")
        buf.write(chunk)
    return buf.getvalue()


# --------------------------------------------------------------------------
# dispatcher (host 0)
# --------------------------------------------------------------------------

@dataclass
class _Worker:
    host_id: str
    sock: socket.socket
    info: dict
    lock: threading.Lock = field(default_factory=threading.Lock)
    alive: bool = True
    strikes: int = 0
    batches: int = 0
    last_pong: float = field(default_factory=time.monotonic)
    pending_ping: int | None = None


class Dispatcher:
    """Host-0 request-plane dispatcher over a dynamic DP group of workers.

    Parameters mirror runtime.serving.ServingEngine where they overlap;
    ``ping_interval_s``/``ping_timeout_s`` control failure detection and
    ``max_strikes`` the eviction threshold for batch-level errors.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 buckets=(1, 2, 4, 8, 16, 32), max_delay_ms: float = 5.0,
                 ping_interval_s: float = 2.0, ping_timeout_s: float = 5.0,
                 max_strikes: int = 3, retries: int = 1):
        self.buckets = tuple(sorted(buckets))
        self.max_delay = max_delay_ms / 1e3
        self.ping_interval = ping_interval_s
        self.ping_timeout = ping_timeout_s
        self.max_strikes = max_strikes
        self.retries = retries

        self._workers: dict[str, _Worker] = {}
        self._wlock = threading.Lock()
        self._rr = 0
        self._q: queue.Queue = queue.Queue()
        self._inflight: dict[int, tuple[_Worker, list]] = {}
        self._iflock = threading.Lock()
        self._next_batch = 0
        self._stop = threading.Event()
        self._evictions: list[dict] = []
        self._stats = {"requests": 0, "batches": 0}

        self._server = socket.create_server((host, port))
        self.address = ("127.0.0.1" if host in ("", "0.0.0.0") else host,
                        self._server.getsockname()[1])
        self._threads = [
            threading.Thread(target=self._accept_loop, daemon=True),
            threading.Thread(target=self._dispatch_loop, daemon=True),
            threading.Thread(target=self._health_loop, daemon=True),
        ]
        for t in self._threads:
            t.start()

    # ------------------------------------------------------------------ API
    def submit(self, x: np.ndarray) -> Future:
        """Enqueue one example (no batch dim); resolves to its output."""
        fut: Future = Future()
        self._q.put([np.asarray(x), fut, self.retries])
        return fut

    def wait_for_workers(self, n: int, timeout_s: float = 30.0) -> None:
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            if len(self.workers()) >= n:
                return
            time.sleep(0.02)
        raise TimeoutError(f"{n} workers did not register within {timeout_s}s")

    def workers(self) -> list[str]:
        with self._wlock:
            return [w.host_id for w in self._workers.values() if w.alive]

    def stats(self) -> dict:
        with self._wlock:
            per = {w.host_id: {"batches": w.batches, "alive": w.alive,
                               "strikes": w.strikes}
                   for w in self._workers.values()}
        return {**self._stats, "workers": per, "dp_size": len(self.workers()),
                "evictions": list(self._evictions)}

    def close(self):
        self._stop.set()
        try:
            self._server.close()
        except OSError:
            pass
        with self._wlock:
            workers = list(self._workers.values())
        for w in workers:
            try:
                with w.lock:
                    _send_msg(w.sock, ("stop",))
                w.sock.close()
            except OSError:
                pass
        while True:
            try:
                item = self._q.get_nowait()
            except queue.Empty:
                break
            if not item[1].done():
                item[1].set_exception(RuntimeError("dispatcher closed"))

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ------------------------------------------------------- worker plumbing
    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                sock, _ = self._server.accept()
            except OSError:
                return
            try:
                msg = _recv_msg(sock)
                if msg[0] != "register":
                    sock.close()
                    continue
                w = _Worker(host_id=msg[1], sock=sock, info=msg[2])
                with self._wlock:
                    self._workers[w.host_id] = w
                threading.Thread(target=self._recv_loop, args=(w,),
                                 daemon=True).start()
            except (ConnectionError, pickle.UnpicklingError, OSError):
                sock.close()

    def _recv_loop(self, w: _Worker):
        try:
            while not self._stop.is_set():
                msg = _recv_msg(w.sock)
                kind = msg[0]
                if kind == "result":
                    self._finish_batch(msg[1], msg[2], None)
                    w.batches += 1
                elif kind == "error":
                    w.strikes += 1
                    self._finish_batch(msg[1], None, msg[2])
                    if w.strikes >= self.max_strikes:
                        self._evict(w, f"{w.strikes} batch errors")
                        return
                elif kind == "pong":
                    w.last_pong = time.monotonic()
                    w.pending_ping = None
                    health = msg[2]
                    if health and not health.get("healthy", True):
                        self._evict(w, "health_check reported unhealthy")
                        return
        except (ConnectionError, OSError, EOFError, pickle.UnpicklingError):
            if not self._stop.is_set():
                self._evict(w, "connection lost")

    def _evict(self, w: _Worker, reason: str):
        """Drop a worker out of the DP group; re-enqueue its in-flight work."""
        with self._wlock:
            if not w.alive:
                return
            w.alive = False
        self._evictions.append({"host": w.host_id, "reason": reason,
                                "t": time.time()})
        try:
            w.sock.close()
        except OSError:
            pass
        with self._iflock:
            orphans = [bid for bid, (ww, _) in self._inflight.items()
                       if ww is w]
            items = []
            for bid in orphans:
                items.extend(self._inflight.pop(bid)[1])
        for it in items:  # retry on the surviving DP group
            if it[2] > 0:
                it[2] -= 1
                self._q.put(it)
            elif not it[1].done():
                it[1].set_exception(
                    RuntimeError(f"host {w.host_id} evicted: {reason}"))

    def _finish_batch(self, batch_id: int, out, err: str | None):
        with self._iflock:
            entry = self._inflight.pop(batch_id, None)
        if entry is None:
            return  # already re-dispatched after an eviction
        _, items = entry
        if err is not None:
            for it in items:
                if it[2] > 0:
                    it[2] -= 1
                    self._q.put(it)
                elif not it[1].done():
                    it[1].set_exception(RuntimeError(f"worker error: {err}"))
            return
        outs = out if isinstance(out, tuple) else (out,)
        for i, it in enumerate(items):
            per = tuple(np.asarray(o)[i] for o in outs)
            if not it[1].done():
                it[1].set_result(per[0] if len(per) == 1 else per)

    # -------------------------------------------------------------- dispatch
    def _pick_worker(self) -> _Worker | None:
        with self._wlock:
            alive = [w for w in self._workers.values() if w.alive]
            if not alive:
                return None
            self._rr = (self._rr + 1) % len(alive)
            return alive[self._rr]

    def _dispatch_loop(self):
        max_bucket = self.buckets[-1]
        while not self._stop.is_set():
            try:
                first = self._q.get(timeout=0.05)
            except queue.Empty:
                continue
            batch = [first]
            deadline = time.monotonic() + self.max_delay
            while len(batch) < max_bucket:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    batch.append(self._q.get(timeout=left))
                except queue.Empty:
                    break
            groups: dict = {}
            for item in batch:
                groups.setdefault(
                    (item[0].shape, str(item[0].dtype)), []).append(item)
            for g in groups.values():
                self._send_batch(g)

    def _send_batch(self, items: list):
        n = len(items)
        bucket = next((b for b in self.buckets if b >= n), self.buckets[-1])
        x = np.stack([it[0] for it in items], axis=0)
        if bucket > n:
            x = np.concatenate(
                [x, np.zeros((bucket - n,) + x.shape[1:], x.dtype)], axis=0)
        for _ in range(8):  # a send-time eviction retries on the next worker
            w = self._pick_worker()
            if w is None:
                break
            batch_id = self._next_batch
            self._next_batch += 1
            with self._iflock:
                self._inflight[batch_id] = (w, items)
                # count before the send: the worker can reply (and resolve
                # futures) before this thread resumes after sendall
                self._stats["requests"] += n
                self._stats["batches"] += 1
            try:
                with w.lock:
                    _send_msg(w.sock, ("batch", batch_id, x))
                return
            except (ConnectionError, OSError):
                with self._iflock:
                    self._inflight.pop(batch_id, None)
                    self._stats["requests"] -= n
                    self._stats["batches"] -= 1
                self._evict(w, "send failed")
        for it in items:
            if not it[1].done():
                it[1].set_exception(RuntimeError("no healthy workers"))

    def _health_loop(self):
        seq = 0
        while not self._stop.is_set():
            time.sleep(self.ping_interval)
            with self._wlock:
                workers = [w for w in self._workers.values() if w.alive]
            now = time.monotonic()
            for w in workers:
                if (w.pending_ping is not None
                        and now - w.last_pong > self.ping_timeout):
                    self._evict(w, "ping timeout")
                    continue
                seq += 1
                w.pending_ping = seq
                try:
                    with w.lock:
                        _send_msg(w.sock, ("ping", seq))
                except (ConnectionError, OSError):
                    self._evict(w, "ping send failed")


# --------------------------------------------------------------------------
# worker (each serving host)
# --------------------------------------------------------------------------

def run_worker(address: tuple[str, int], net, host_id: str | None = None,
               health_fn=None, info: dict | None = None,
               stop_event: threading.Event | None = None) -> None:
    """Per-host worker loop: register, then serve batches until "stop".

    ``net`` is any callable of a batched array that returns arrays (a
    runtime.net.Net, a Net with a sharded program from
    parallel.sharding.shard_program, or a plain function).
    ``health_fn`` defaults to parallel.multihost.health_check when the
    package is importable, else a trivial always-healthy probe — so the
    dispatcher's automatic health consumption works in both real and
    bootstrap-by-file-path deployments.
    """
    if health_fn is None:
        try:
            from .multihost import health_check as health_fn  # type: ignore
        except ImportError:
            def health_fn(deadline_s=5.0):
                return {"healthy": True, "devices": {}}
    host_id = host_id or f"{socket.gethostname()}:{os.getpid()}"
    sock = socket.create_connection(address)
    slock = threading.Lock()
    _send_msg(sock, ("register", host_id, info or {"pid": os.getpid()}))
    try:
        while not (stop_event and stop_event.is_set()):
            msg = _recv_msg(sock)
            kind = msg[0]
            if kind == "stop":
                return
            if kind == "ping":
                try:
                    health = health_fn(deadline_s=2.0)
                except Exception:
                    health = {"healthy": False}
                with slock:
                    _send_msg(sock, ("pong", msg[1], health))
            elif kind == "batch":
                batch_id, x = msg[1], msg[2]
                try:
                    out = net(x)
                    out = (tuple(np.asarray(o) for o in out)
                           if isinstance(out, tuple) else np.asarray(out))
                    with slock:
                        _send_msg(sock, ("result", batch_id, out))
                except Exception as e:  # noqa: BLE001 — report, don't die
                    with slock:
                        _send_msg(sock, ("error", batch_id, repr(e)[:300]))
    except (ConnectionError, OSError):
        return
    finally:
        sock.close()


# --------------------------------------------------------------------------
# 2-process CPU dryrun: requests flow + a killed host is evicted
# --------------------------------------------------------------------------

_WORKER_BOOTSTRAP = r"""
import importlib.util, sys
spec = importlib.util.spec_from_file_location("_planer_dispatcher", sys.argv[1])
mod = importlib.util.module_from_spec(spec)
sys.modules["_planer_dispatcher"] = mod  # dataclass needs the module findable
spec.loader.exec_module(mod)
import numpy as np
def toy_net(x):
    return x.astype(np.float32) * 2.0 + 1.0
mod.run_worker(("127.0.0.1", int(sys.argv[2])), toy_net, host_id=sys.argv[3])
"""


def spawn_toy_worker(port: int, host_id: str):
    """Spawn a subprocess worker running a toy numpy net (no torch import —
    workers bootstrap this module by file path, so the dryrun is fast)."""
    import subprocess
    import sys
    return subprocess.Popen(
        [sys.executable, "-c", _WORKER_BOOTSTRAP, os.path.abspath(__file__),
         str(port), host_id],
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def dryrun(n_workers: int = 2, n_requests: int = 24) -> dict:
    """Prove the multi-host mechanism without a cluster: spawn ``n_workers``
    subprocess hosts, flow requests across the DP group, kill one host by
    exact PID mid-stream, and verify it is evicted while every remaining
    request still completes on the survivors."""
    procs = []
    report: dict = {"ok": False}
    with Dispatcher(max_delay_ms=2.0, ping_interval_s=0.2,
                    ping_timeout_s=1.0) as disp:
        try:
            for i in range(n_workers):
                procs.append(spawn_toy_worker(disp.address[1], f"host{i}"))
            disp.wait_for_workers(n_workers, timeout_s=30)
            x = np.arange(4, dtype=np.float32)

            # waves force separate batches so the DP round-robin is visible
            for wave in range(0, n_requests, 4):
                futs = [disp.submit(x + wave + i) for i in range(4)]
                for i, f in enumerate(futs):
                    np.testing.assert_allclose(
                        f.result(timeout=30), (x + wave + i) * 2 + 1)
            spread = {h: s["batches"]
                      for h, s in disp.stats()["workers"].items()}

            procs[0].kill()  # exact child PID — never kill by pattern
            procs[0].wait(timeout=10)
            futs = [disp.submit(x + 100 + i) for i in range(n_requests)]
            outs = [f.result(timeout=30) for f in futs]
            for i, o in enumerate(outs):
                np.testing.assert_allclose(o, (x + 100 + i) * 2 + 1)
            deadline = time.monotonic() + 10
            while "host0" in disp.workers() and time.monotonic() < deadline:
                time.sleep(0.05)
            st = disp.stats()
            report = {
                "ok": "host0" not in disp.workers()
                      and len(disp.workers()) == n_workers - 1,
                "requests_before_kill": n_requests,
                "requests_after_kill": n_requests,
                "batch_spread": spread,
                "evictions": st["evictions"],
                "dp_size_after": st["dp_size"],
            }
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait(timeout=5)
    return report


if __name__ == "__main__":
    import json
    print(json.dumps(dryrun(), indent=1, default=str))
