"""The span recorder (``runtime/profiler.py`` ``record``) on the call path
of ``Net.__call__`` and ``Program.__call__``: off, a call reads no clock
and records nothing; on, one call is one request of nested spans with its
counters, threads get their own requests, the cap drops and counts, a
first call records its compile, a replay records its copies;
``profiler.trace`` writes the spans into its ``trace.json``; and
``span_study.py`` runs a benchmark cell's windows through them."""
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch

from planer_tpu_torch import models as tm
from planer_tpu_torch.runtime import profiler
from planer_tpu_torch.runtime.net import Net

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import span_study  # noqa: E402

CALL = ["net.call", "program.call", "program.inputs", "program.eager",
        "program.finish", "net.to_numpy"]
REPLAY = ["net.call", "program.call", "program.inputs", "program.copy_in",
          "program.replay", "program.copy_out", "program.finish",
          "net.to_numpy"]


def _x(seed=0, side=32):
    return np.random.default_rng(seed).standard_normal(
        (1, 3, side, side)).astype(np.float32)


@pytest.fixture(scope="module")
def net():
    n = tm.resnet18(num_classes=8, device="cpu")
    n(_x())
    return n


def _fresh_net(net):
    return Net(net.graph, net.weights, device="cpu")


def _contains(outer, inner):
    return outer.start_ns <= inner.start_ns <= inner.end_ns <= outer.end_ns


@pytest.mark.parametrize("entry", ["net", "program"])
@pytest.mark.parametrize("first", [True, False])
def test_recording_off_reads_no_clock_and_records_nothing(net, monkeypatch,
                                                           entry, first):
    """Off, ``Net.__call__`` and ``Program.__call__`` (a first call that
    compiles, and a later one) call no clock and add no span to a
    recording that has ended."""
    if first:
        net = _fresh_net(net)
    with profiler.record() as ended:
        pass
    assert profiler.RECORDING is None
    calls = []
    for clock in ("time_ns", "perf_counter", "perf_counter_ns", "monotonic",
                  "monotonic_ns", "time"):
        real = getattr(time, clock)
        monkeypatch.setattr(time, clock, lambda *a, _r=real, _c=clock:
                            calls.append(_c) or _r(*a))
    (net if entry == "net" else net.program)(_x())
    monkeypatch.undo()
    assert calls == []
    assert ended.spans == [] and ended.counters == {}


def test_one_call_is_one_request_of_nested_spans(net):
    with profiler.record() as rec:
        y = net(_x())
    spans = rec.spans
    assert [s.name for s in spans] == CALL
    assert {s.request for s in spans} == {spans[0].request}
    assert {s.thread for s in spans} == {threading.get_native_id()}
    parents = {s.name: spans[s.parent].name if s.parent >= 0 else None
               for s in spans}
    assert parents == {"net.call": None, "program.call": "net.call",
                       "program.inputs": "program.call",
                       "program.eager": "program.call",
                       "program.finish": "program.call",
                       "net.to_numpy": "net.call"}
    for s in spans[1:]:
        assert _contains(spans[s.parent], s)
    # children in order, one after the other
    kids = [s for s in spans if s.parent == 1]
    assert all(a.end_ns <= b.start_ns for a, b in zip(kids, kids[1:]))
    assert rec.counters == {"eager_runs": 1, "out_bytes": y.nbytes}
    assert rec.dropped == 0


def test_a_program_call_alone_is_its_own_request(net):
    with profiler.record() as rec:
        net.program(_x())
        net.program(_x(1))
    spans = rec.spans
    roots = [s for s in spans if s.parent == -1]
    assert [s.name for s in roots] == ["program.call"] * 2
    assert len({s.request for s in roots}) == 2
    assert [s.name for s in spans[:4]] == CALL[1:5]
    assert "out_bytes" not in rec.counters


def test_two_threads_get_their_own_requests(net):
    """Calls from two threads at once (as ``ServingEngine``'s workers make
    them) each form one request: distinct ids, every span of a request on
    its caller's thread, parents on the same request."""
    barrier = threading.Barrier(2)
    errors = []

    def caller(seed):
        try:
            barrier.wait(timeout=30)
            for i in range(3):
                net(_x(seed + i))
        except Exception as e:              # reported below
            errors.append(e)

    with profiler.record() as rec:
        threads = [threading.Thread(target=caller, args=(s,))
                   for s in (10, 20)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not errors and not any(t.is_alive() for t in threads)
    spans = rec.spans
    roots = [s for s in spans if s.name == "net.call"]
    assert len(roots) == 6 and len({s.request for s in roots}) == 6
    assert len({s.thread for s in roots}) == 2
    for s in spans:
        root = next(r for r in roots if r.request == s.request)
        assert s.thread == root.thread
        if s.parent >= 0:
            assert spans[s.parent].request == s.request
    assert rec.counters["eager_runs"] == 6


def test_the_cap_drops_spans_and_counts_them(net):
    with profiler.record(cap=4) as rec:
        net(_x())
        net(_x())
    assert [s.name for s in rec.spans] == CALL[:4]
    assert rec.dropped == 2 * len(CALL) - 4
    # the counters still count every call
    assert rec.counters["eager_runs"] == 2


def test_a_first_call_records_its_compile(net):
    fresh = _fresh_net(net)
    with profiler.record() as rec:
        fresh(_x())
        fresh(_x())
    names = [s.name for s in rec.spans]
    assert names == ["net.call", "program.call", "program.inputs",
                     "program.compile", "net.to_numpy"] + CALL
    compile_ = rec.spans[3]
    assert rec.spans[compile_.parent].name == "program.call"
    assert rec.counters["compiles"] == 1 and rec.counters["eager_runs"] == 1
    # a compile outside a call (``lowered_text``) is a request of its own
    other = _fresh_net(net)
    with profiler.record() as rec:
        other.program.lowered_text(_x())
    assert [(s.name, s.parent) for s in rec.spans] == [("program.compile", -1)]
    assert rec.counters == {"compiles": 1}


def test_a_replay_records_its_copies(net, monkeypatch):
    """The replayed path, on a stand-in graph that runs the entry's list
    into its static outputs (the CPU has no CUDA graph): its spans in the
    call's order, the caller's input bytes as pageable, one replay, one
    capture, and the answer of the eager loop."""
    fresh = _fresh_net(net)
    prog = fresh.program
    x = _x(3)
    want = prog._run(x)
    fresh(x)
    entry = prog._entry(x)

    events = []

    class Graph:
        def replay(self):
            events.append("replay")
            env = {n: prog._cast_graph_in(t.clone()) for n, t in
                   zip(prog.graph.inputs, entry.static_in)}
            env = prog._run_steps(entry, env)
            entry.static_out = {n: prog._cast_out(env[n])
                                for n in entry.needs}

    class Event:
        def synchronize(self):
            events.append("wait")

        def record(self, stream):
            events.append(("record", stream))

    # a host input's buffers, as ``_capture`` makes them: the caller's
    # dtype in the staging buffer and in the graph's input
    @profiler.spanned("program.capture", "captures")
    def capture(entry, inputs):
        entry.staging = [torch.empty_like(t) for t in inputs]
        entry.static_in = [torch.empty_like(t) for t in inputs]
        entry.staged = Event()
        entry.graph = Graph()

    monkeypatch.setattr(prog, "_captures", lambda: True)
    monkeypatch.setattr(prog, "_capture", capture)
    monkeypatch.setattr(prog, "_current_stream", lambda i: ("stream", i))
    with profiler.record() as first:
        fresh(x)
    assert [s.name for s in first.spans] == (
        REPLAY[:3] + ["program.capture"] + REPLAY[3:])
    assert first.counters["captures"] == 1
    events.clear()
    with profiler.record() as rec:
        y = fresh(x)
    assert [s.name for s in rec.spans] == REPLAY
    assert rec.counters == {"in_bytes.pageable": x.nbytes, "replays": 1,
                            "copy_in.staged": 1, "out_bytes": y.nbytes}
    np.testing.assert_array_equal(y, want.numpy())
    # the staged copy: wait for the last copy out, the caller's bytes as
    # they are, then the copy recorded on the program's stream
    assert events == ["wait", ("record", ("stream", -1)), "replay"]
    np.testing.assert_array_equal(entry.staging[0].numpy(), x)
    np.testing.assert_array_equal(entry.static_in[0].numpy(), x)
    # a caller's tensor on the host is pageable too, counted at its bytes
    with profiler.record() as rec:
        fresh.program(torch.from_numpy(x).double())
    assert rec.counters["in_bytes.pageable"] == x.nbytes


def test_trace_writes_the_spans_on_its_time_base(net, tmp_path):
    """``trace`` (layers on, the default) writes each span into its
    ``trace.json`` as a complete event inside the profile's own span of
    time, with its parent and request, and the counters beside them."""
    with profiler.trace(str(tmp_path)) as prof:
        net(_x())
    assert [s.name for s in prof.recording.spans] == CALL
    with open(tmp_path / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    ours = [e for e in events if e.get("cat") == "planer_span"]
    ops = [e for e in events if e.get("ph") == "X"
           and e.get("cat") != "planer_span"]
    assert [e["name"] for e in ours] == CALL
    assert [e["args"]["parent"] for e in ours] == [-1, 0, 1, 1, 1, 0]
    layer = next(e for e in ops if e["name"] == "layer2.0.conv1")
    call = ours[3]                           # program.eager
    assert call["ts"] <= layer["ts"] and \
        layer["ts"] + layer["dur"] <= call["ts"] + call["dur"] + 1
    counters = [e for e in events if e.get("cat") == "planer_counter"]
    assert counters[0]["args"]["eager_runs"] == 1


def test_a_trace_without_layers_keeps_the_calls_path(net, tmp_path,
                                                      monkeypatch):
    """``layers=False`` enters no layer scope (the entry runs as outside a
    trace), still records the spans, and with no ``log_dir`` writes
    nothing."""
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or real(name))
    with profiler.trace(None, layers=False) as prof:
        assert not profiler.TRACING
        net(_x())
    assert entered == []
    assert [s.name for s in prof.recording.spans] == CALL
    assert profiler.RECORDING is None and not profiler.TRACING
    with profiler.trace(str(tmp_path), layers=False):
        net(_x())
    assert (tmp_path / "trace.json").exists()


def test_the_span_study_runs_a_small_cell_on_the_cpu():
    """The study of ``r18-b1-closed`` at 64 px on the CPU: its four windows,
    the paired cost of recording with its off-against-off control, the
    span window's requests and counters, and the reference check."""
    ov = {"config": {"image_side": 64, "kernels": {}},
          "traffic": {"pool": 2, "sample": 2, "warmup_calls": 1,
                      "trace_seconds": 0.2}}
    out = span_study.study("r18-b1-closed", 2 ** 31 + 21, 0.2, pairs=4,
                           device="cpu", overrides=ov)
    json.dumps(out)
    assert out["correct"] is True
    assert [w["recording"] for w in out["windows"]] == ["off", "on", "on",
                                                        "off"]
    assert "program.eager" in out["windows"][1]["span_ms"]
    cost = out["recording_cost"]
    assert cost["pairs"] == 4 and cost["calls"] == 20
    assert set(cost) == {"pairs", "calls", "on against off",
                         "off against off"}
    sw = out["span_window"]
    assert sw["requests"] >= 1 and sw["counters"]["eager_runs"] >= 1
    assert sw["spans"]["net.call"] == sw["requests"]
