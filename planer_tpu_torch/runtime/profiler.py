"""Profiling: cost analysis, a roofline report, tracing, spans — the
port's counterpart of ``planer_tpu/runtime/profiler.py``.

  * ``Net.timeit("start")`` then ``Net.forward(x, engine="oracle")`` fills
    ``net.timer`` with each opcode's time in the float32 executor (device
    time on the card: the executor drains the device around each op);
  * ``cost_report`` — FLOPs, bytes and arithmetic intensity of the program
    at given input shapes (``Program.cost_analysis``) against a card's
    peaks: the roofline bound of one call;
  * ``record`` — the span recorder, off by default: inside it every
    ``Net.__call__`` and ``Program.__call__`` records a span at each layer
    boundary of the call path (``net.call`` > ``net.to_numpy``;
    ``program.call`` > ``program.inputs``, ``.copy_in``, ``.replay``,
    ``.copy_out``, ``.finish``, ``.eager``, ``.compile`` > ``.capture``),
    stamped with ``time.time_ns()`` (the clock torch.profiler's kineto
    events and CUPTI's device timestamps are on), and counts bytes copied
    in and out, replays (and those whose inputs went through the entry's
    pinned buffers), eager runs, compiles and captures.  Off, a call
    reads one module flag (``RECORDING``) and no clock;
  * ``trace`` — a ``torch.profiler`` context that also records spans.
    With ``layers=True`` the program runs its compiled entry's list
    eagerly, each op under its IR layer name (no captured graph replays
    there); with ``layers=False`` it replays as a caller's call does, and
    only the device's activity is profiled (no host op is recorded), so
    the spans say what the host was doing between device operations;
  * ``op_histogram`` — static per-opcode counts of a graph.
"""
from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import threading
import time
from collections import Counter
from typing import NamedTuple

import torch

from ..ir import Graph

__all__ = ["cost_report", "trace", "record", "op_histogram", "CHIP_SPECS",
           "Recording", "Span"]

# peak (dense bf16 FLOP/s, dense int8 OP/s, memory bytes/s) per card, from
# the vendor's data sheet (SXM part, at its full power limit)
CHIP_SPECS = {
    "h100": (989e12, 1979e12, 3.35e12),
}

# the active Recording while ``record`` is entered, else None: read once
# at the top of every ``Net.__call__`` and ``Program.__call__``
RECORDING = None
# spans a recording keeps before it drops (and counts) the rest
SPAN_CAP = 1 << 20
# the call path's outermost span while no recording is active: entered, it
# yields None and reads no clock
NO_SPAN = contextlib.nullcontext()


class Span(NamedTuple):
    """One recorded span: ``time.time_ns()`` stamps (``end_ns`` None while
    it is open), the index of its parent span (-1 for an outermost one),
    its request id (shared by every span under one outermost span) and the
    thread it ran on."""

    name: str
    start_ns: int
    end_ns: int | None
    parent: int
    request: int
    thread: int


# each thread's native id, asked once per thread for the process: the
# query is a system call, slow on some hosts, and a recording can be short
_NATIVE = threading.local()


def _native_id() -> int:
    tid = getattr(_NATIVE, "id", None)
    if tid is None:
        tid = _NATIVE.id = threading.get_native_id()
    return tid


class _Open:
    """A span being recorded: the context manager ``Recording.span``
    returns; entered, it yields the span's row (None where the cap dropped
    it), the parent of ``Recording.step``."""

    __slots__ = ("rec", "name", "row")

    def __init__(self, rec, name):
        self.rec = rec
        self.name = name

    def __enter__(self):
        rec = self.rec
        local = rec._local
        stack = getattr(local, "stack", None)
        if stack is None:
            stack = local.stack = []
            local.thread = _native_id()
        if len(rec._rows) >= rec.cap:
            rec._drop()
            self.row = None
            return None
        parent = stack[-1] if stack else None
        # [name, start, end, parent row, request, thread]
        row = [self.name, time.time_ns(), None, parent,
               parent[4] if parent is not None else next(rec._requests),
               local.thread]
        rec._rows.append(row)
        stack.append(row)
        self.row = row
        return row

    def __exit__(self, *exc):
        if self.row is not None:
            self.row[2] = time.time_ns()
            self.rec._local.stack.pop()
        return False


class Recording:
    """The spans and counters of one ``record``: spans in memory, at most
    ``cap`` of them (``dropped`` counts those past it); counters per thread,
    summed when read."""

    def __init__(self, cap: int = SPAN_CAP):
        self.cap = cap
        self.dropped = 0
        self._rows: list = []
        self._local = threading.local()
        self._requests = itertools.count()
        self._lock = threading.Lock()
        self._tallies: list[dict] = []

    def span(self, name: str) -> _Open:
        """A context manager recording the span ``name`` on this thread,
        nested in the thread's innermost open span."""
        return _Open(self, name)

    def step(self, parent, name: str, start: int,
             end: int | None = None) -> int:
        """Record the span ``name`` from ``start`` to ``end`` (stamps of
        ``time.time_ns()``; ``end`` now where not given) inside ``parent``
        (the row an entered ``span`` yields), and return ``end``, the next
        step's start: the cheap form for the steps of a call, which open no
        span of their own, and which a call can record after the fact."""
        if end is None:
            end = time.time_ns()
        if parent is None or len(self._rows) >= self.cap:
            self._drop()
        else:
            self._rows.append([name, start, end, parent, parent[4],
                               parent[5]])
        return end

    def _drop(self):
        with self._lock:
            self.dropped += 1

    def count(self, name: str, n: int = 1):
        """Add ``n`` to the counter ``name`` (in this thread's tally)."""
        tally = getattr(self._local, "tally", None)
        if tally is None:
            tally = self._local.tally = {}
            with self._lock:
                self._tallies.append(tally)
        tally[name] = tally.get(name, 0) + n

    @property
    def counters(self) -> dict[str, int]:
        out: dict[str, int] = {}
        with self._lock:
            tallies = list(self._tallies)
        for t in tallies:
            for k, v in list(t.items()):
                out[k] = out.get(k, 0) + v
        return out

    @property
    def spans(self) -> list[Span]:
        """The spans in the order they were recorded (a ``span`` as it
        opens, a ``step`` as it ends); ``parent`` indexes this list."""
        rows = list(self._rows)
        index = {id(r): i for i, r in enumerate(rows)}
        return [Span(r[0], r[1], r[2],
                     -1 if r[3] is None else index[id(r[3])], r[4], r[5])
                for r in rows]

    def chrome_events(self, base_ns: int = 0) -> list[dict]:
        """The spans as Chrome trace complete events ("X", microseconds
        from ``base_ns``) and the counters as one counter event at the end
        of the last span."""
        pid = os.getpid()
        spans = self.spans
        out = [{"ph": "X", "cat": "planer_span", "name": s.name, "pid": pid,
                "tid": s.thread, "ts": (s.start_ns - base_ns) / 1e3,
                "dur": ((s.end_ns or s.start_ns) - s.start_ns) / 1e3,
                "args": {"index": i, "parent": s.parent,
                         "request": s.request}}
               for i, s in enumerate(spans)]
        end = max((s.end_ns or s.start_ns for s in spans), default=base_ns)
        out.append({"ph": "C", "cat": "planer_counter",
                    "name": "planer_counters", "pid": pid, "tid": 0,
                    "ts": (end - base_ns) / 1e3,
                    "args": {**self.counters, "spans_dropped": self.dropped}})
        return out


def where(x: torch.Tensor) -> str:
    """Where ``x`` lives: "device", or "pinned" or "pageable" host memory
    (a CUDA pointer query, ~25 us on the H100's host: a replayed call asks
    it while the replay runs)."""
    if x.device.type != "cpu":
        return "device"
    return "pinned" if x.is_pinned() else "pageable"


def spanned(name: str, counter: str):
    """Decorate a step of the call path that runs rarely (a compile, a
    capture): while a recording is active, each run counts ``counter``
    and is recorded as the span ``name``."""
    def wrap(fn):
        @functools.wraps(fn)
        def step(*args, **kw):
            rec = RECORDING
            if rec is None:
                return fn(*args, **kw)
            rec.count(counter)
            with rec.span(name):
                return fn(*args, **kw)
        return step
    return wrap


@contextlib.contextmanager
def record(cap: int = SPAN_CAP):
    """Record the call path's spans and counters in this process while
    the block runs; yields the ``Recording``."""
    global RECORDING
    rec = Recording(cap)
    prev, RECORDING = RECORDING, rec
    try:
        yield rec
    finally:
        RECORDING = prev


def op_histogram(graph: Graph) -> dict[str, int]:
    return dict(Counter(l.op for l in graph.layers))


def cost_report(net, *inputs, chip: str = "h100") -> dict:
    """Roofline analysis of the program for the given inputs.  A graph
    quantized with activations (int8 x int8 convs) is held to the card's
    int8 peak, any other to its bf16 peak."""
    if chip not in CHIP_SPECS:
        raise ValueError(f"unknown chip {chip!r} (known: {sorted(CHIP_SPECS)})")
    ca = net.program.cost_analysis(*inputs)
    flops = float(ca.get("flops", 0.0))
    bytes_accessed = float(ca.get("bytes accessed", 0.0))
    bf16, int8, peak_bw = CHIP_SPECS[chip]
    peak_flops = int8 if net.graph.meta.get("act_quant") else bf16
    intensity = flops / max(bytes_accessed, 1.0)
    ridge = peak_flops / peak_bw
    t_compute = flops / peak_flops
    t_memory = bytes_accessed / peak_bw
    bound = "compute" if t_compute >= t_memory else "memory"
    return {
        "flops": flops,
        "bytes_accessed": bytes_accessed,
        "arithmetic_intensity": intensity,
        "ridge_intensity": ridge,
        "bound": bound,
        "ideal_time_s": max(t_compute, t_memory),
        "peak_flops": peak_flops,
        "peak_bandwidth": peak_bw,
    }


@contextlib.contextmanager
def trace(log_dir: str | None, layers: bool = True):
    """``torch.profiler`` trace with the program's spans recorded; yields
    the profiler, whose ``recording`` is the ``Recording``.

    ``layers=True``: host and (on a card) device activity, the program's
    entry run eagerly with each op under its IR layer name, so the
    profiler's ``events()`` list them.  ``layers=False``: the entry
    replays as outside a trace, and only the device's activity is profiled
    (CUDA; the CPU's ops where there is no card), so the spans alone say
    what the host did.  Unless ``log_dir`` is None, ``log_dir/trace.json``
    (Chrome trace format) is written on exit: the profile with the spans
    and counters added on the file's own time base."""
    from torch.profiler import ProfilerActivity, profile

    from . import program as _program
    acts = [ProfilerActivity.CPU] if layers else []
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prev = _program.TRACING
    with record() as rec, profile(
            activities=acts or [ProfilerActivity.CPU]) as prof:
        prof.recording = rec
        _program.TRACING = layers
        try:
            yield prof
        finally:
            _program.TRACING = prev
    if log_dir is None:
        return
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += rec.chrome_events(
        int(doc.get("baseTimeNanoseconds", 0)))
    with open(path, "w") as f:
        json.dump(doc, f)
