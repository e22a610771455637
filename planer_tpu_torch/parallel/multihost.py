"""Multi-host bring-up and device health — the port's counterpart of
``planer_tpu/parallel/multihost.py``:

  * :func:`initialize` — ``torch.distributed.init_process_group`` with a
    hard timeout and a clear error (a hung coordinator is the most common
    multi-host bring-up failure), its arguments defaulting to torch's
    environment variables;
  * :func:`health_check` — a device liveness probe under a deadline, which
    ``dispatcher.run_worker`` answers the dispatcher's pings with.
"""
from __future__ import annotations

import atexit
import datetime
import os
import queue as _queue
import threading
import time

import torch

from ..device import resolve_device

__all__ = ["initialize", "health_check"]


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None,
               timeout_s: float = 120.0, *, device="cuda"):
    """``torch.distributed.init_process_group`` with a hard timeout.

    ``coordinator_address`` ("host:port" of process 0, which serves the
    rendezvous), ``num_processes`` and ``process_id`` default to torch's
    environment variables (``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``,
    ``RANK``); the world defaults to one process of rank 0.  The group
    speaks ``nccl`` on the CUDA card, or ``gloo`` where the caller asks for
    ``device="cpu"``.  Raises TimeoutError, naming the address, instead of
    hanging when the coordinator does not answer within ``timeout_s``.
    Returns the process's index, the process count and the number of local
    devices.

    The rendezvous runs on a daemon thread under a timeout of its own, a
    third of ``timeout_s`` (a connection attempt, the store's retry delay
    and a second attempt each take up to that), so that it has given up by
    about the time the caller is told.  A process that exits after the
    TimeoutError waits at most ``timeout_s`` more for that thread (a
    daemon thread stopped inside torch's C++ frames aborts the process);
    in practice it has ended already."""
    import torch.distributed as dist

    dev = resolve_device(device)
    env = os.environ
    if coordinator_address is None and env.get("MASTER_ADDR"):
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if coordinator_address is None:
        raise ValueError("initialize: no coordinator address (pass one or "
                         "set MASTER_ADDR and MASTER_PORT)")
    if num_processes is None:
        num_processes = int(env.get("WORLD_SIZE", 1))
    if process_id is None:
        process_id = int(env.get("RANK", 0))
    host, port = coordinator_address.rsplit(":", 1)
    world, rank = int(num_processes), int(process_id)
    rendezvous = datetime.timedelta(seconds=timeout_s / 3)
    timed_out = TimeoutError(
        f"torch.distributed.init_process_group did not complete within "
        f"{timeout_s}s (coordinator {coordinator_address} unreachable?)")

    # daemon thread + queue: a hung rendezvous must not block our return
    # (a ThreadPoolExecutor context manager would join the stuck worker)
    done: _queue.Queue = _queue.Queue()

    def _run():
        t0 = time.monotonic()
        try:
            store = dist.TCPStore(host, int(port), world,
                                  is_master=rank == 0, timeout=rendezvous)
        except dist.DistError as e:
            # given up by its own timeout: the coordinator did not answer
            gave_up = time.monotonic() - t0 >= rendezvous.total_seconds()
            done.put((False, e, gave_up))
            return
        try:
            dist.init_process_group(
                "nccl" if dev.type == "cuda" else "gloo", store=store,
                world_size=world, rank=rank)
            done.put((True, None, False))
        except Exception as e:  # surfaced to the caller below
            done.put((False, e, False))

    thread = threading.Thread(target=_run, daemon=True)
    thread.start()
    try:
        ok, err, gave_up = done.get(timeout=timeout_s)
    except _queue.Empty:
        atexit.register(thread.join, timeout_s)
        raise timed_out from None
    if gave_up:
        raise timed_out from err
    if not ok:
        raise err
    return {"process_index": dist.get_rank(),
            "process_count": dist.get_world_size(),
            "local_devices": (torch.cuda.device_count()
                              if dev.type == "cuda" else 1)}


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
