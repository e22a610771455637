"""The span window's reduction (``portbench/spans.py``) on synthetic
intervals."""
import json

import pytest

from planer_tpu_torch.runtime.profiler import Span
from portbench import spans

HTOD = "Memcpy HtoD (Pageable -> Device)"
DEV = [(30, 34, HTOD), (38, 60, "void kernel<1>(x)"),
       (75, 78, "Memcpy DtoH (Device -> Pageable)"), (95, 120, "kernel2")]


def _spans():
    rows = [("net.call", -20, 3, -1, 0), ("net.to_numpy", -5, 3, 0, 0),
            ("net.call", 5, 90, -1, 1), ("program.call", 10, 70, 2, 1),
            ("program.inputs", 10, 20, 3, 1),
            ("program.copy_in", 20, 35, 3, 1),
            ("program.replay", 35, 40, 3, 1),
            ("program.copy_out", 40, 45, 3, 1),
            ("program.finish", 45, 70, 3, 1), ("net.to_numpy", 70, 85, 2, 1)]
    return [Span(n, s, e, p, r, 7) for n, s, e, p, r in rows]


def test_idle_is_charged_to_the_innermost_span_open_through_it():
    """Gaps [0, 30], [34, 38], [60, 75] and [78, 95] of a (0, 100) window,
    each instant charged to the innermost span open through it: the
    previous request's ``net.to_numpy`` clipped at the window's start, the
    caller's loop ``outside``, a parent's own time between its children;
    the last device interval clipped at the window's end."""
    sw = spans.reduce_events(DEV, _spans(), {"in_bytes.pageable": 150,
                                             "replays": 1}, (0, 100))
    ns = {k: round(v * 1e9, 6) for k, v in sw.idle_by_span.items()}
    assert ns == {"net.to_numpy": 15, spans.OUTSIDE: 7, "net.call": 10,
                  "program.inputs": 10, "program.copy_in": 11,
                  "program.replay": 3, "program.finish": 10}
    assert sw.busy_s == pytest.approx(34e-9)
    assert sum(sw.idle_by_span.values()) == pytest.approx(
        sw.window_s - sw.busy_s)
    # one request starts in the window; spans counted where they start
    assert sw.requests == 1
    assert sw.spans["net.to_numpy"] == 1 and sw.spans["net.call"] == 1
    assert sw.span_s["program.copy_in"] == pytest.approx(15e-9)
    assert sw.self_s["program.call"] == pytest.approx(0.0)
    assert sw.self_s["net.call"] == pytest.approx(10e-9)
    assert sw.htod == [10] and sw.dtoh == [8]
    per = sw.per_request()
    assert per["copy_in_idle_ms"] == pytest.approx(11e-6)
    assert per["copy_out_idle_ms"] == pytest.approx(15e-6)
    assert per["dispatch_idle_ms"] == pytest.approx(33e-6)
    assert per["replay_idle_ms"] == pytest.approx(3e-6)
    assert per["outside_idle_ms"] == pytest.approx(7e-6)
    assert (per["copy_in_idle_ms"] + per["copy_out_idle_ms"]
            + per["dispatch_idle_ms"] + per["outside_idle_ms"]) == \
        pytest.approx(per["device_idle_ms"])
    assert per["copy_in_gbps"] == pytest.approx(10.0)
    s = sw.summary()
    assert s["htod_in_copy_in"] == {"copies": 1, "inside": 1,
                                    "offset_us": [pytest.approx(0.01)] * 2}
    json.dumps(s)


def test_an_open_span_a_copy_outside_and_an_empty_window():
    """A span still open runs to the window's end; a host-to-device copy
    that starts outside every ``program.copy_in`` is reported as such; a
    window with no request reads nothing per request."""
    rows = [Span("program.call", 10, None, -1, 0, 1),
            Span("program.copy_in", 20, 30, 0, 0, 1)]
    dev = [(5, 8, HTOD), (22, 26, HTOD)]
    sw = spans.reduce_events(dev, rows, {}, (0, 50))
    ns = {k: round(v * 1e9, 6) for k, v in sw.idle_by_span.items()}
    assert ns == {spans.OUTSIDE: 7, "program.call": 30,
                  "program.copy_in": 6}
    assert sw.htod == [None, 2]
    assert sw.summary()["htod_in_copy_in"]["inside"] == 1
    assert spans.reduce_events([], [], {}, (0, 10)).per_request() == {}


def test_the_device_timeline_is_anchored_at_each_replay():
    """Device timestamps that run 0.3% fast and start 745 us off are put
    back on the spans' clock at each replay's first kernel (its start at
    ``program.replay``'s end), a launch the profiler dropped skipped, one
    held back (one of them the window's last) and one queued behind device
    work smoothed over by their neighbours; the copy in then starts inside
    ``program.copy_in`` again and the answer's copy ends inside
    ``net.to_numpy``.  Times in us."""
    period, n, us = 1000, 20, 1000
    rows, dev = [], []
    for i in range(n):
        t = i * period

        def h(x):                              # the host's clock, in ns
            return (t + x) * us

        def d(x):                              # the device's clock
            return round(745000 + 1.003 * (t + x) * us)
        # the launches of requests 11 and 19, the last, return 60 us after
        # their kernels began
        rows += [Span("net.call", h(0), h(900), -1, i, 1),
                 Span("program.copy_in", h(100), h(300), 4 * i, i, 1),
                 Span("program.replay", h(300),
                      h(380 if i in (11, n - 1) else 320), 4 * i, i, 1),
                 Span("net.to_numpy", h(600), h(880), 4 * i, i, 1)]
        # request 15's copy in still runs as its graph's launch returns
        dev.append((d(250), d(340 if i == 15 else 290), HTOD, 3 * i))
        if i != 7:
            dev.append((d(340 if i == 15 else 320), d(500), "kernel",
                        3 * i + 1))
            dev.append((d(500), d(700), "kernel", 3 * i + 1))
        dev.append((d(852), d(870), "Memcpy DtoH (Device -> Pageable)",
                    3 * i + 2))
    window = (0, n * period * us)
    raw = spans.reduce_events(dev, rows, {}, window)
    assert raw.htod and raw.htod.count(None) == len(raw.htod)
    aligned, pairs = spans.align(dev, rows)
    assert len(pairs) == n - 1
    sw = spans.reduce_events(aligned, rows, {}, window)
    assert None not in sw.htod and None not in sw.dtoh
    # the drift followed within a few us, against the 60 the held-back
    # launch alone would move its request
    assert max(sw.htod) - min(sw.htod) <= 10 * us
    assert spans.align(dev, rows[:1]) == (dev, [])

