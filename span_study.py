"""What the program's spans see in one benchmark cell, and what recording
them costs.

    python3 span_study.py --workload <cell> --seed <n> --seconds <s> [--pairs 300]

runs, on a card, the cell's set-up as ``portbench`` runs it, then:

  * windows of ``--seconds`` with recording (``profiler.record``) off, on,
    on and off, with each span's own time per request in the "on" ones;
  * the cost of recording with no profiler: ``--pairs`` turns of 20 calls
    with recording on against 20 with it off (the order swapped each turn,
    so the host's noise, which moves over seconds, cancels within a turn),
    and as many turns of off against off, the control, which reads what
    the pairing leaves of that noise;
  * the CPU-op traced window a ``--trace 1`` run of the benchmark profiles,
    and the span window (``portbench.spans.run_window``), each of the
    traffic's ``trace_seconds``;

checks every window's sampled answers against the cell's reference, and
prints one JSON line of what each window read.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import time


def _ms_per_call(load, net, seconds, sync):
    w = load.run(net, seconds)
    sync()
    return w, 1e3 * w.seconds / w.calls


def recording_cost(net, pool, pairs, sync, calls=20) -> dict:
    """Turns of ``calls`` calls with recording on against off, then off
    against off: the median difference per call (us) and its share of the
    median time per call with it off."""
    from planer_tpu_torch.runtime import profiler
    out = {}
    for tag, ctx in (("on", profiler.record), ("off", contextlib.nullcontext)):
        d, base = [], []
        for i in range(pairs):
            per = {}
            for first in ((True, False) if i % 2 else (False, True)):
                with ctx() if first else contextlib.nullcontext():
                    t0 = time.perf_counter()
                    for j in range(calls):
                        net(pool[(i * calls + j) % len(pool)])
                    sync()
                    per[first] = (time.perf_counter() - t0) / calls
            d.append(1e6 * (per[True] - per[False]))
            base.append(1e6 * per[False])
        d.sort()
        base.sort()
        q = pairs // 4
        out[f"{tag} against off"] = {
            "us_quartiles": [d[q], d[2 * q], d[3 * q]],
            "off_us_median": base[2 * q],
            "share_pct": 100 * d[2 * q] / base[2 * q]}
    out["pairs"], out["calls"] = pairs, calls
    return out


def study(name: str, seed: int, seconds: float, *, pairs=300,
          device="cuda", overrides=None) -> dict:
    """The windows above, in one process; returns what each read."""
    import torch
    from torch.profiler import record_function

    from planer_tpu_torch.runtime import profiler
    from portbench import harness, spans
    from portbench import trace as tr
    c = harness.cell(harness.load_spec(), name)
    ov = overrides or {}
    cfg = {**c.cfg, **ov.get("config", {})}
    traffic = {**c.traffic, **ov.get("traffic", {})}
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    weights, calib, net, load = harness.setup(c, cfg, traffic, seed, dev)
    sync()
    gc.collect()
    gc.freeze()
    out = {"workload": name, "seed": seed,
           "card": harness._card_line() if cuda else "cpu", "windows": []}
    wins = []
    for tag in ("off", "on", "on", "off"):
        with profiler.record() if tag == "on" else \
                contextlib.nullcontext() as rec:
            w0 = time.time_ns()
            w, ms = _ms_per_call(load, net, seconds, sync)
            w1 = time.time_ns()
        wins.append(w)
        harness._log(harness._window_line(f"recording {tag}", w))
        row = {"recording": tag, "calls": w.calls, "seconds": w.seconds,
               "ms_per_call": ms}
        if rec is not None:
            # the spans' own times with no profiler, ms per request
            host = spans.reduce_events([], rec.spans, rec.counters, (w0, w1))
            row["span_ms"] = {k: 1e3 * v / max(host.requests, 1)
                              for k, v in host.span_s.items()}
        out["windows"].append(row)
    out["recording_cost"] = recording_cost(net, load.pool, pairs, sync)
    harness._log(f"recording cost: {out['recording_cost']}")
    ts = traffic["trace_seconds"]
    with tr.profiled() as holder:
        with record_function(tr.WINDOW):
            traced = load.run(net, ts, span=record_function)
            sync()
    t = tr.reduce(holder.prof, {m: k["names"]
                                for m, k in cfg["kernels"].items()})
    del holder
    harness._log(harness._window_line("CPU-op traced window", traced))
    spanned, sw = spans.run_window(load, net, ts, sync)
    harness._log(spans.line(spanned, sw))
    wins += [traced, spanned]
    out["cpu_op_window"] = {"calls": traced.calls, "seconds": traced.seconds,
                            "busy_s": t.busy_s, "window_s": t.window_s,
                            "idle_gaps": t.breakdown()["idle_gaps"]}
    out["span_window"] = {"calls": spanned.calls, "seconds": spanned.seconds,
                          **sw.summary()}
    del net
    gc.collect()
    ref = c.family.reference(cfg, weights, calib, dev)
    gaps, _ = c.family.compare(cfg, ref, load,
                               [a for w in wins for a in w.sample],
                               traffic["batch"])
    out["checks"] = {k: {"value": gaps.get(k), "limit": v}
                     for k, v in cfg["limit"].items()}
    out["failed"] = sum(w.failed for w in wins)
    out["correct"] = out["failed"] == 0 and all(
        v["value"] is not None and v["value"] <= v["limit"]
        for v in out["checks"].values())
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--pairs", type=int, default=300)
    args = ap.parse_args(argv)
    import torch

    from portbench import harness
    harness.use_cache_dirs()
    # one host thread for torch's CPU ops, as the benchmark's runs
    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("span_study.py: needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(study(args.workload, args.seed, args.seconds,
                           pairs=args.pairs)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
