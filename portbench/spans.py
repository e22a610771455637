"""The span window: the program's own spans (``profiler.record`` of
``planer_tpu_torch``) beside the device's operations of a CUDA-only
torch.profiler trace (``profiler.trace(None, layers=False)``), on one clock
(``time.time_ns``, which kineto stamps both host and device events with),
reduced to where the device idles by what the host was doing.

One clock in name only: on the H100's machine the device timestamps of a
profile can drift against the host's (in some profiles by up to ~1.3 ms
a second, in others not at all), while kineto's host events keep to
``time.time_ns``.  So ``align`` puts the device operations on the spans'
clock first, anchored at every request's replay: under the CUDA-only
profile a b1 graph's first kernel starts as ``graph.replay()`` returns
(within ~15 us, ~60 us at worst, on the H100; not at b64, where no
alignment is found).  Two copies anchored by
nothing then check the alignment: each request's host-to-device copy has
to start inside its ``program.copy_in`` span, and the answer's
device-to-host copy has to end inside ``net.to_numpy``, which waits for
it.

The profiler's own cost sits at the launch: CUPTI's tracing of each
graph node makes ``graph.replay()`` take ~0.4-0.8 ms in place of ~0.02,
with the device idle until it returns.  So the idle inside
``program.replay`` is mostly the profiler's, and ``per_request`` gives it
apart (``replay_idle_ms``); the windows with recording on and no profiler
give each span's own time.

``span_study.py`` at the checkout's root runs a cell's windows through
this reduction on a card.
"""
from __future__ import annotations

import bisect
import dataclasses
import heapq
import itertools
import statistics
import time

from . import trace

OUTSIDE = "outside"
COPY_IN = ("program.copy_in",)
COPY_OUT = ("program.copy_out", "net.to_numpy")
ROOTS = ("net.call", "program.call")
ANCHOR = "program.replay"
# an anchor matches within this (ns), and 2% of the time since the last
# anchor: the launch's own spread (~15 us) and the drift (<= ~1%)
MATCH = 100_000
COPY_BACK = "net.to_numpy"


@dataclasses.dataclass
class SpanWindow:
    window_s: float
    busy_s: float
    requests: int           # outermost net.call / program.call spans
    idle_by_span: dict      # span name (or OUTSIDE) -> seconds of idle
    span_s: dict            # span name -> seconds inside it
    self_s: dict            # span name -> seconds not in a child span
    spans: dict             # span name -> spans in the window
    counters: dict          # the recording's counters
    dropped: int            # spans the recording dropped past its cap
    htod: list              # (device start - its program.copy_in start,
    #                          or None outside one) per host-to-device copy
    dtoh: list              # (device end - its net.to_numpy start, or
    #                          None outside one) per device-to-host copy
    shift: list = dataclasses.field(default_factory=list)
    #                          (device time, device - host ns) of each anchor

    def per_request(self) -> dict:
        """Idle per request (ms) in ``program.copy_in``, in the copies out
        (``program.copy_out``, ``net.to_numpy``), in every other span of
        the call path (and of that, in ``program.replay``) and outside
        any, and the caller's input bytes over the time inside
        ``program.copy_in`` (GB/s)."""
        if not self.requests:
            return {}
        idle = self.idle_by_span

        def ms(names):
            return 1e3 * sum(idle.get(n, 0.0) for n in names) / self.requests
        other = [n for n in idle if n not in COPY_IN + COPY_OUT + (OUTSIDE,)]
        out = {"copy_in_idle_ms": ms(COPY_IN),
               "copy_out_idle_ms": ms(COPY_OUT),
               "dispatch_idle_ms": ms(other),
               "replay_idle_ms": ms([ANCHOR]),
               "outside_idle_ms": ms([OUTSIDE]),
               "device_idle_ms": 1e3 * (self.window_s - self.busy_s)
               / self.requests}
        moved = sum(v for k, v in self.counters.items()
                    if k.startswith("in_bytes."))
        if self.span_s.get(COPY_IN[0]):
            out["copy_in_gbps"] = moved / self.span_s[COPY_IN[0]] / 1e9
        return out

    def summary(self) -> dict:
        def r(d):
            return {k: round(v, 6) for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])}

        def held(v):
            inside = [h for h in v if h is not None]
            return {"copies": len(v), "inside": len(inside),
                    "offset_us": [1e-3 * min(inside), 1e-3 * max(inside)]
                    if inside else []}
        return {"window_s": self.window_s, "busy_s": self.busy_s,
                "requests": self.requests,
                "per_request": self.per_request(),
                "idle_by_span_s": r(self.idle_by_span),
                "span_s": r(self.span_s), "self_s": r(self.self_s),
                "spans": self.spans, "counters": self.counters,
                "dropped": self.dropped,
                "htod_in_copy_in": held(self.htod),
                "dtoh_in_to_numpy": held(self.dtoh),
                "aligned": {"anchors": len(self.shift),
                            "shift_us": [1e-3 * min(p[1] for p in self.shift),
                                         1e-3 * max(p[1] for p in self.shift)]
                            if self.shift else []}}


def innermost(spans, window):
    """The window cut into (start, end, name) pieces, each named after the
    innermost span open through it (``OUTSIDE`` where none is)."""
    w0, w1 = window
    edges = []
    for i, s in enumerate(spans):
        end = w1 if s.end_ns is None else s.end_ns
        if end > w0 and s.start_ns < w1:
            edges.append((max(s.start_ns, w0), 1, i))
            edges.append((min(end, w1), 0, i))
    edges.sort()
    pieces, heap, done, cur = [], [], set(), w0

    def top():
        while heap and heap[0][2] in done:
            heapq.heappop(heap)
        return spans[heap[0][2]].name if heap else OUTSIDE

    for t, opens, i in edges:
        if t > cur:
            pieces.append((cur, t, top()))
            cur = t
        if opens:
            # latest start first; of two opened at one instant, the later
            heapq.heappush(heap, (-spans[i].start_ns, -i, i))
        else:
            done.add(i)
    if w1 > cur:
        pieces.append((cur, w1, top()))
    return pieces


def reduce_events(dev, spans, counters, window, dropped=0) -> SpanWindow:
    """The span window of the device intervals ((start, end, name), ns),
    the recording's spans (``profiler.Span``) and counters, and the
    window's (start, end) on the same clock."""
    w0, w1 = window
    pieces = innermost(spans, window)
    # the harness's reduction (``trace.reduce_events``) unions the device
    # intervals and charges each gap whole to the host interval open at its
    # start: with the pieces as those intervals, and a mark of no length
    # at each piece's start cutting every gap there, each instant of idle
    # goes to the piece it lies in
    marks = [(p[0], p[0], "") for p in pieces[1:]]
    t = trace.reduce_events([d[:3] for d in dev] + marks, pieces, window,
                            {})
    inside = [i for i, s in enumerate(spans) if w0 <= s.start_ns < w1]
    span_s: dict[str, float] = {}
    self_s: dict[str, float] = {}
    count: dict[str, int] = {}
    for i in inside:
        s = spans[i]
        d = ((w1 if s.end_ns is None else s.end_ns) - s.start_ns) * 1e-9
        span_s[s.name] = span_s.get(s.name, 0.0) + d
        self_s[s.name] = self_s.get(s.name, 0.0) + d
        count[s.name] = count.get(s.name, 0) + 1
        if s.parent >= 0 and w0 <= spans[s.parent].start_ns < w1:
            p = spans[s.parent].name
            self_s[p] = self_s.get(p, 0.0) - d
    requests = sum(spans[i].parent < 0 and spans[i].name in ROOTS
                   for i in inside)
    return SpanWindow(t.window_s, t.busy_s, requests, t.idle_by_host,
                      span_s, self_s, count, dict(counters), dropped,
                      _within(dev, spans, "HtoD", COPY_IN[0], (w0, w1)),
                      _within(dev, spans, "DtoH", COPY_BACK, (w0, w1),
                              end=True))


def _within(dev, spans, kind, name, window, end=False):
    """For each device copy of ``kind`` in the window: its start (with
    ``end``, its end) less the start of the span ``name`` it falls in, or
    None where it falls in none."""
    w0, w1 = window
    box = sorted((s.start_ns, s.end_ns or w1) for s in spans
                 if s.name == name)
    starts = [b[0] for b in box]
    out = []
    for d in dev:
        t = d[1] if end else d[0]
        if kind in d[2] and w0 <= d[0] < w1:
            i = bisect.bisect_right(starts, t) - 1
            out.append(t - box[i][0] if i >= 0 and t <= box[i][1] else None)
    return out


def device_events(prof):
    """The profile's device operations as (start, end, name, correlation
    id), ns: the operations of one graph replay share the id of its
    launch."""
    import torch
    return [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name(),
             e.correlation_id())
            for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CUDA
            and not e.is_user_annotation()]


def align(dev, spans):
    """The device operations ((start, end, name, correlation id), ns) on
    the spans' clock, and the anchors [(device time, device - host)].

    Under a CUDA-only profile a b1 replay's first kernel starts as
    ``graph.replay()`` returns (the profiler's work at the launch holds
    the launch back; at b64 it starts early in the launch, and this
    alignment does not hold there): each ``program.replay`` span's end is
    matched, in order, with the first operation of a launch (the
    operations sharing a correlation id) that starts nearest where the
    last anchor's shift puts it, within ``MATCH`` (a launch the profiler
    dropped matches nothing); the shift is interpolated between anchors.
    With no anchor the operations stay as they are."""
    hosts = sorted(s.end_ns for s in spans
                   if s.name == ANCHOR and s.end_ns is not None)
    first: dict = {}
    size: dict = {}
    for d in dev:
        c = d[3]
        size[c] = size.get(c, 0) + 1
        first[c] = min(first.get(c, d[0]), d[0])
    starts = sorted(t for c, t in first.items() if size[c] > 1)
    if not hosts or not starts:
        return list(dev), []
    k = min(5, len(hosts), len(starts))
    off = sorted(t - h for t, h in zip(starts[:k], hosts[:k]))[k // 2]
    pairs, last = [], hosts[0]
    for h in hosts:
        want = h + off
        i = bisect.bisect_left(starts, want)
        t = min((starts[j] for j in (i - 1, i) if 0 <= j < len(starts)),
                key=lambda t: abs(t - want))
        if abs(t - want) < MATCH + 0.02 * (h - last) and (
                not pairs or t > pairs[-1][0]):
            off, last = t - h, h
            pairs.append((t, off))
    # a launch held back now and then (~60-100 us) is one anchor's error:
    # each anchor takes the shift of a line through the nine anchors
    # nearest it (its slope the median of their pairs' slopes, its level
    # the median of their shifts carried to the anchor along it), which
    # follows a steady drift up to a window's edges
    ts = [p[0] for p in pairs]
    offs = [p[1] for p in pairs]
    smooth = []
    for i, t in enumerate(ts):
        lo = max(0, min(i - 4, len(ts) - 9))
        near = range(lo, min(len(ts), lo + 9))
        slope = statistics.median(
            [(offs[b] - offs[a]) / (ts[b] - ts[a])
             for a, b in itertools.combinations(near, 2)] or [0.0])
        smooth.append(statistics.median(offs[j] + slope * (t - ts[j])
                                        for j in near))
    pairs = list(zip(ts, smooth))

    def shift(t):
        i = bisect.bisect_right(ts, t)
        if i == 0:
            return pairs[0][1]
        if i == len(pairs):
            return pairs[-1][1]
        (x0, o0), (x1, o1) = pairs[i - 1], pairs[i]
        return o0 + (o1 - o0) * (t - x0) / (x1 - x0)
    return [(d[0] - shift(d[0]), d[1] - shift(d[1])) + tuple(d[2:])
            for d in dev], pairs


def reduce(prof, recording, window) -> SpanWindow:
    """``reduce_events`` of a ``profiler.trace(None, layers=False)``
    profile and its recording, the device intervals aligned first."""
    spans = recording.spans
    dev, pairs = align(device_events(prof), spans)
    sw = reduce_events(dev, spans, recording.counters, window,
                       recording.dropped)
    sw.shift = pairs
    return sw


def run_window(load, call, seconds, sync):
    """The span window: ``load.run(call, seconds)`` under
    ``profiler.trace(None, layers=False)``, its bounds on
    ``time.time_ns``.  Returns the load's window and its ``SpanWindow``."""
    from planer_tpu_torch.runtime import profiler
    with profiler.trace(None, layers=False) as prof:
        w0 = time.time_ns()
        win = load.run(call, seconds)
        sync()
        w1 = time.time_ns()
    return win, reduce(prof, prof.recording, (w0, w1))


def line(win, sw: SpanWindow) -> str:
    """The span window in one line: its calls, idle by span per request,
    the counters."""
    n = max(sw.requests, 1)
    idle = ", ".join(f"{k} {1e3 * v / n:.4f}" for k, v in
                     sorted(sw.idle_by_span.items(), key=lambda kv: -kv[1]))
    return (f"span window: {win.calls} calls in {win.seconds:.4f} s, device "
            f"idle {100 * (1 - sw.busy_s / sw.window_s):.2f}%; idle ms per "
            f"request by span: {idle}; counters {sw.counters}")
