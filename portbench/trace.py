"""The traced window: torch.profiler (CPU and CUDA activities, CUPTI)
around the calls the window makes, so around the program's graph replays,
reduced to what the per-layer metrics read.

Every device operation (kernel, copy, fill) is an interval on the device's
timeline.  ``busy_s`` is the length of their union inside the window;
each gap between busy intervals is charged to the innermost host operation
running when it began (the harness's own ``portbench.call`` span around
each call, where no operation of the program is; "host: untraced" between
calls), which is what the
breakdown's ``idle_gaps`` sums by name.  Hand kernels are told apart by the
configuration's plan (``kernels`` in its file: which kernel names each of
the port's kernel modules launches) and checked against the modules'
``LAUNCHES`` counters over the same window.
"""
from __future__ import annotations

import bisect
import contextlib
import dataclasses
import re

import torch

WINDOW = "portbench.window"
CALL = "portbench.call"
# host events looked back over for the one running at a gap's start
_SCAN = 256


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    device_ops: dict            # name -> seconds of device time
    launches: dict              # kernel module -> device launches seen
    module_s: dict              # kernel module -> seconds of device time
    idle_by_host: dict          # host op name -> seconds of device idle

    def breakdown(self, n=10):
        def top(d):
            return [[k[:120], v] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:n]]
        return {"device_ops": top(self.device_ops),
                "idle_gaps": top(self.idle_by_host)}


@contextlib.contextmanager
def profiled():
    """Profile the block; yields a holder whose ``prof`` is set."""
    from torch.profiler import ProfilerActivity, profile
    holder = type("Holder", (), {})()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        yield holder
    holder.prof = prof


def _events(prof):
    """(device intervals [(start, end, name)], host intervals, window
    span) in nanoseconds of the trace's clock."""
    dev, host, window = [], [], None
    for e in prof.profiler.kineto_results.events():
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == torch.autograd.DeviceType.CUDA:
            # a host span's shadow on the device timeline is no operation
            if not e.is_user_annotation() and e.name() not in (WINDOW, CALL):
                dev.append((s, s + d, e.name()))
        else:
            if e.name() == WINDOW:
                window = (s, s + d)
            host.append((s, s + d, e.name()))
    return dev, host, window


def reduce(prof, kernels: dict) -> Trace:
    """The trace of the window: ``kernels`` maps a kernel module to the
    kernel names it launches (a name matches as a whole word)."""
    return reduce_events(*_events(prof), kernels)


def reduce_events(dev, host, window, kernels: dict) -> Trace:
    """``reduce`` of the device and host intervals ((start, end, name), in
    ns) and the window's span."""
    if window is None:
        raise RuntimeError(f"no {WINDOW} span in the trace")
    w0, w1 = window
    dev = sorted((max(s, w0), min(e, w1), n) for s, e, n in dev
                 if e > w0 and s < w1)
    ops, launches, module_s = {}, {m: 0 for m in kernels}, {m: 0.0
                                                             for m in kernels}
    pats = {m: re.compile(r"\b(" + "|".join(map(re.escape, names)) + r")\b")
            for m, names in kernels.items()}
    for s, e, n in dev:
        ops[n] = ops.get(n, 0.0) + (e - s) * 1e-9
        for m, p in pats.items():
            if p.search(n):
                launches[m] += 1
                module_s[m] += (e - s) * 1e-9
                break
    # the union of the device intervals, and the gaps between
    busy, gaps, cur = 0, [], w0
    for s, e, _ in dev:
        if s > cur:
            gaps.append((cur, s))
        if e > cur:
            busy += e - max(s, cur)
            cur = e
    if w1 > cur:
        gaps.append((cur, w1))
    host.sort()
    starts = [h[0] for h in host]
    idle = {}
    for g0, g1 in gaps:
        name = "host: untraced"
        i = bisect.bisect_right(starts, g0) - 1
        for j in range(i, max(i - _SCAN, -1), -1):
            if host[j][1] > g0 and host[j][2] != WINDOW:
                name = host[j][2]
                break
        idle[name] = idle.get(name, 0.0) + (g1 - g0) * 1e-9
    return Trace((w1 - w0) * 1e-9, busy * 1e-9, ops, launches, module_s,
                 idle)
