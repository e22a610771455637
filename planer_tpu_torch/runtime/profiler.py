"""Profiling: cost analysis, a roofline report, tracing — the port's
counterpart of ``planer_tpu/runtime/profiler.py``.

  * ``Net.timeit("start")`` then ``Net.forward(x, engine="oracle")`` fills
    ``net.timer`` with each opcode's time in the float32 executor (device
    time on the card: the executor drains the device around each op);
  * ``cost_report`` — FLOPs, bytes and arithmetic intensity of the program
    at given input shapes (``Program.cost_analysis``) against a card's
    peaks: the roofline bound of one call;
  * ``trace`` — a ``torch.profiler`` context in which the program runs
    its compiled entry's list eagerly, each op under its IR layer name
    (no captured graph replays there);
  * ``op_histogram`` — static per-opcode counts of a graph.
"""
from __future__ import annotations

import contextlib
import os
from collections import Counter

import torch

from ..ir import Graph
from . import program as _program

__all__ = ["cost_report", "trace", "op_histogram", "CHIP_SPECS"]

# peak (dense bf16 FLOP/s, dense int8 OP/s, memory bytes/s) per card, from
# the vendor's data sheet (SXM part, at its full power limit)
CHIP_SPECS = {
    "h100": (989e12, 1979e12, 3.35e12),
}


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
def trace(log_dir: str):
    """``torch.profiler`` trace of the host and (on a card) the device,
    written to ``log_dir/trace.json`` (Chrome trace format) on exit; yields
    the profiler, whose ``events()`` list each program op under its IR
    layer name."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prev = _program.TRACING
    with profile(activities=acts) as prof:
        _program.TRACING = True
        try:
            yield prof
        finally:
            _program.TRACING = prev
    os.makedirs(log_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
