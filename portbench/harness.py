"""The harness: runs one cell of ``BENCHMARK.json`` once and returns its
result line.

Everything that belongs to one configuration, traffic mix or metric is
found by name, and the harness reaches it only through that name:

  * the configuration's file is the one ``BENCHMARK.json`` gives; its
    ``family`` names ``configs/<family>.py``, which builds the system under
    test and holds the family's yardstick (seeded inputs, the work counted
    from the shapes, the plain reference, its comparison, the control);
  * a traffic mix is ``traffic/<mix>.json``; its ``generator`` names
    ``generators/<generator>.py``, which makes the load and drives it;
  * each metric is ``metrics/<name>.py``, whose ``read(run)`` returns its
    value or None where it finds nothing to read.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import importlib.util
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
CHECKOUT = ROOT.parent
CACHE = ROOT / ".cache"
# top-level module names no run may have loaded
FORBIDDEN = ("jax", "jaxlib", "flax", "planer_tpu")


def _log(msg):
    print(msg, file=sys.stderr, flush=True)


def use_cache_dirs():
    """Keep every build and kernel cache at a fixed path inside the
    checkout, so that only a cell's first run there builds."""
    os.environ["PLANER_TORCH_BUILD_DIR"] = str(CACHE / "build")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def process_age() -> float:
    """Seconds since this process started (Linux ``/proc``)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_spec(path=None) -> dict:
    with open(path or CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def _load_file(path: Path, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    cfg: dict
    traffic: dict
    end_to_end: list       # metric entries of BENCHMARK.json
    per_layer: list
    family: object         # configs/<family>.py
    generator: object      # generators/<generator>.py
    readers: dict          # metric name -> read(run)


def cell(spec: dict, name: str) -> Cell:
    """The cell ``name`` with its configuration, traffic and metric readers,
    each found by name; raises ``KeyError`` for a name it cannot find."""
    work = {w["name"]: w for w in spec["workloads"]}
    if name not in work:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = work[name]
    confs = {c["name"]: c for c in spec["configs"]}
    if w["config"] not in confs:
        raise KeyError(f"workload {name!r}: no config {w['config']!r}")
    with open(CHECKOUT / confs[w["config"]]["file"]) as f:
        cfg = json.load(f)
    tpath = ROOT / "traffic" / f"{w['traffic']}.json"
    if not tpath.exists():
        raise KeyError(f"workload {name!r}: no traffic file {tpath.name}")
    with open(tpath) as f:
        traffic = json.load(f)
    gen = str(traffic.get("generator"))
    if not gen.isidentifier() or not (
            ROOT / "generators" / f"{gen}.py").exists():
        raise KeyError(f"traffic {w['traffic']!r}: no generator {gen!r}")
    e2e = [m for m in spec["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if (name in m["workloads"] if "workloads" in m
                     else m["moves"] in reported)]
    readers = {}
    for m in e2e + per_layer:
        p = ROOT / "metrics" / f"{m['name']}.py"
        if not p.exists():
            raise KeyError(f"metric {m['name']!r}: no reader {p.name}")
        readers[m["name"]] = _load_file(
            p, "portbench.metrics." + m["name"].replace(".", "_")).read
    fam = str(cfg.get("family"))
    if not fam.isidentifier() or not (ROOT / "configs" / f"{fam}.py").exists():
        raise KeyError(f"config {w['config']!r}: no family {fam!r}")
    family = importlib.import_module(f"portbench.configs.{fam}")
    generator = importlib.import_module(f"portbench.generators.{gen}")
    return Cell(name, w["chips"], cfg, traffic, e2e, per_layer, family,
                generator, readers)


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cfg: dict
    traffic: dict
    setup_s: float
    window: object          # generators.Window of the measured window
    traced: object | None   # the traced window (--trace 1), after it
    trace: object | None    # trace.Trace of the traced window
    work: dict              # family.work(cfg, batch)
    peaks: dict | None      # peaks.of(the card)
    kernels_ok: bool        # the trace's hand kernels match LAUNCHES

    def step_s(self) -> float | None:
        """Seconds per call of the measured (untraced) window."""
        w = self.window
        return w.seconds / w.calls if w.calls else None


KERNELS = "planer_tpu_torch.ops.kernels."


def _counters(cfg) -> dict:
    """module -> its ``LAUNCHES``: every kernel module of the port that is
    loaded, and those the configuration names."""
    for m in cfg["kernels"]:
        importlib.import_module(KERNELS + m)
    return {n[len(KERNELS):]: mod.LAUNCHES
            for n, mod in list(sys.modules.items())
            if n.startswith(KERNELS) and hasattr(mod, "LAUNCHES")}


def _card_line() -> str:
    if shutil.which("nvidia-smi") is None:
        return "nvidia-smi not found"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()


def setup(c: Cell, cfg, traffic, seed, dev, control=False):
    """Weights, calibration batches, the system under test (the program, or
    with ``control`` the family's control in its place) and the load, warmed
    on the signatures the traffic uses."""
    t = [time.perf_counter()]
    weights = c.family.arrays(cfg, seed, dev)
    calib = c.family.calibration(cfg, seed, dev)
    t.append(time.perf_counter())
    make = c.family.control if control else c.family.build
    net = make(cfg, weights, calib, dev)
    t.append(time.perf_counter())
    load = c.generator.make(
        traffic, lambda n: c.family.inputs(cfg, n, seed, dev), seed)
    t.append(time.perf_counter())
    load.warm(net)
    t.append(time.perf_counter())
    _log("set-up: " + ", ".join(
        f"{k} {b - a:.3f} s" for k, a, b in zip(
            ("inputs", "build", "traffic", "warm-up"), t, t[1:]))
        + f"; process age {process_age():.3f} s")
    return weights, calib, net, load


def _window_line(tag, win):
    lat = sorted(win.latencies)
    if not lat:
        return f"{tag}: no calls"
    ms = [1e3 * v for v in (sum(lat) / len(lat), lat[len(lat) // 2],
                            lat[int(.95 * len(lat))], lat[-1])]
    return (f"{tag}: {win.calls} calls, {win.images} images in "
            f"{win.seconds:.4f} s; latency ms mean {ms[0]:.4f}, p50 "
            f"{ms[1]:.4f}, p95 {ms[2]:.4f}, max {ms[3]:.4f}")


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             device="cuda", spec=None, overrides=None, control=False):
    """Run the cell once: set-up, the measured window, with ``trace`` a
    traced window after it, then the checks.  Returns the result line (a
    dict, ``checks`` its last key).  ``overrides`` ({"config": {...},
    "traffic": {...}}) resize a cell for the CPU tests; ``device`` "cpu"
    runs the port's CPU path; ``control`` puts the family's control in the
    program's place, which launches none of the program's kernels."""
    import torch

    from . import peaks
    from . import trace as tr

    c = cell(spec or load_spec(), name)
    ov = overrides or {}
    cfg = {**c.cfg, **ov.get("config", {})}
    traffic = {**c.traffic, **ov.get("traffic", {})}
    dev = torch.device(device)
    cuda = dev.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(dev)

    weights, calib, net, load = setup(c, cfg, traffic, seed, dev, control)
    sync()
    setup_s = process_age()
    # what set-up made stays out of the window's garbage collections
    gc.collect()
    gc.freeze()
    counters = _counters(cfg)
    before = {m: dict(v) for m, v in counters.items()}
    win = load.run(net, seconds)
    sync()
    traced = prof = None
    if trace:
        from torch.profiler import record_function
        with tr.profiled() as holder:
            with record_function(tr.WINDOW):
                traced = load.run(net, min(seconds, traffic["trace_seconds"]),
                                  span=record_function)
                sync()
        prof = holder.prof
    memory_peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
    launched = {m: {k: v - before[m].get(k, 0) for k, v in cnt.items()
                    if v != before[m].get(k, 0)}
                for m, cnt in counters.items()}
    wins = [win] + ([traced] if traced else [])
    _log(_window_line("window", win) + f"; set-up {setup_s:.3f} s")
    if traced:
        _log(_window_line("traced window", traced))
    _log(f"launches {launched}")

    # the hand kernels must have run as the configuration says, every call
    calls = sum(w.calls for w in wins)
    done = calls - sum(w.failed for w in wins)
    want = {} if control else {
        m: {k: n * done for k, n in spec_k["launches"].items()}
        for m, spec_k in cfg["kernels"].items()}
    off = sum(launched.get(m, {}) != want.get(m, {})
              for m in set(launched) | set(want)
              if launched.get(m) or want.get(m))
    failed = calls - done + (done if off else 0)

    t = None
    kernels_ok = True
    if prof is not None:
        t = tr.reduce(prof, {m: k["names"] for m, k in cfg["kernels"].items()})
        # the hand kernels the trace saw: the configuration's per call
        ok_calls = traced.calls - traced.failed
        for m, k in cfg["kernels"].items():
            due = 0 if control else sum(k["launches"].values()) * ok_calls
            if t.launches[m] != due:
                kernels_ok = False
                _log(f"trace: {t.launches[m]} {m} kernels on the device, "
                     f"{due} due")
        del prof

    # free the system under test before the reference runs
    del net
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t0 = time.perf_counter()
    ref = c.family.reference(cfg, weights, calib, dev)
    gaps, n = c.family.compare(cfg, ref, load,
                               [a for w in wins for a in w.sample],
                               traffic["batch"])
    _log(f"compared {n} answers with the reference in "
         f"{time.perf_counter() - t0:.3f} s")
    checks = {k: {"value": gaps.get(k), "limit": v}
              for k, v in cfg["limit"].items()}
    checks["failed_calls"] = {"value": failed, "limit": 0}
    correct = all(v["value"] is not None and v["value"] <= v["limit"]
                  for v in checks.values())

    run = Run(cfg, traffic, setup_s, win, traced, t,
              c.family.work(cfg, traffic["batch"]),
              peaks.of(torch.cuda.get_device_name(dev) if cuda else "cpu"),
              kernels_ok)
    metrics = {}
    for m in (c.per_layer if trace else c.end_to_end):
        v = c.readers[m["name"]](run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {"platform": "gpu" if cuda else "cpu",
                "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
                "count": 1, "memory_peak_bytes": memory_peak}
    if t is not None:
        dev_info.update(busy_s=t.busy_s, window_s=t.window_s)
    out = {"correct": bool(correct), "attempted": calls,
           "failed": failed, "metrics": metrics, "device": dev_info}
    if t is not None:
        out["breakdown"] = t.breakdown()
    out["card"] = _card_line() if cuda else "cpu"
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_cache_dirs()
    spec = load_spec()
    need = cell(spec, args.workload).chips
    import torch
    # one host thread for torch's CPU ops: idle intra-op threads spin on
    # every core after a parallel region, so a b1 call's host part (the
    # input's dtype conversion before its copy) would race its own pool
    torch.set_num_threads(1)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: the cell needs {need} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    out = run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                   spec=spec)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: forbidden modules loaded: {bad}", file=sys.stderr)
        return 3
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
