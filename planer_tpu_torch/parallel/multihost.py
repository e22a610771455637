"""Host-level device health: ``health_check`` — the port's counterpart of
``planer_tpu/parallel/multihost.py:health_check``."""
from __future__ import annotations

import queue as _queue
import threading
import time

import torch

__all__ = ["health_check"]


def health_check(deadline_s: float = 10.0) -> dict:
    """Probe every local device with a tiny computation under a deadline:
    each CUDA device, or on a machine without one the CPU (named ``cpu``
    in the report).  Each probe runs on a daemon thread, so a wedged device
    cannot block the caller; a device that has not answered by the
    deadline is reported unhealthy."""
    n = torch.cuda.device_count()
    devices = ([torch.device("cuda", i) for i in range(n)] if n
               else [torch.device("cpu")])
    results = {}
    out: _queue.Queue = _queue.Queue()

    def probe(dev):
        try:
            t0 = time.perf_counter()
            x = torch.ones((8, 8), dtype=torch.float32, device=dev)
            float((x + 1).sum())             # waits for the device
            out.put((str(dev), {"ok": True,
                                "latency_s": time.perf_counter() - t0}))
        except Exception as e:  # a failed probe is the report, not a crash
            out.put((str(dev), {"ok": False, "error": repr(e)[:200]}))

    for d in devices:
        threading.Thread(target=probe, args=(d,), daemon=True).start()
    deadline = time.monotonic() + deadline_s
    for _ in devices:
        left = deadline - time.monotonic()
        try:
            name, res = out.get(timeout=max(left, 0.001))
            results[name] = res
        except _queue.Empty:
            break
    for d in devices:
        results.setdefault(str(d), {"ok": False, "error": "probe timed out"})
    healthy = all(v["ok"] for v in results.values())
    return {"healthy": healthy, "devices": results}
