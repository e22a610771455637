"""Float32 flow interpreter — the port's counterpart of
``planer_tpu/runtime/executor.py`` (the JAX package's numpy oracle).

Straight-line evaluation of the flow program in a name -> tensor
environment, layer chains threading through the edge dst, eager freeing of
dead tensors.  Every op runs its registry ``oracle_fn``: float32 semantics
on dequantized weights, quantization annotations ignored.  It is the
correctness oracle of the quantized program and the engine of calibration.
``run`` and ``run_range`` hold float32 precision (``device.float32_exact``:
TF32 off for convolutions and matmuls, the caller's setting restored
after), so float32 means float32 on the card, ``trace_cb`` included.  Its
inputs are kept as they are, float64 included, as the JAX package's numpy
executor keeps them (``np.asarray``); only the program narrows them.

With ``timed`` set (``timeit("start")`` sets it), ``timer[op]``
accumulates the seconds each opcode took, the reference's per-op-type
profile.  On a CUDA device the device is drained before each op and after
it, so the dict holds each op's device time and not the time its launch
took the host; the untimed loop neither synchronises nor reads a clock.  Host values
that shape ops return (``shape``'s numpy array, ``range``'s host tensor)
move to the device where the next op takes them.
"""
from __future__ import annotations

import time
from typing import Any, Callable

import numpy as np
import torch

from ..device import float32_exact, resolve_device
from ..ir import Graph
from ..registry import get_op

__all__ = ["Executor"]


def _as_tensor(v, device):
    if v is None or isinstance(v, torch.Tensor):
        return v if v is None else v.to(device)
    return torch.as_tensor(np.asarray(v), device=device)


class Executor:
    def __init__(self, graph: Graph, weights: list, device="cuda"):
        self.graph = graph
        self.device = resolve_device(device)
        self.weights = [_as_tensor(w, self.device) for w in weights]
        self.life = graph.liveness()
        self._layers = graph.layer_map()
        self.timed = False
        self.timer: dict[str, float] = {}

    # ------------------------------------------------------------------ API
    @torch.no_grad()
    @float32_exact()
    def run(self, *inputs, debug: bool = False,
            trace_cb: Callable | None = None):
        env = self.initial_env(*inputs)
        self.run_range(env, 0, len(self.graph.flow), debug=debug,
                       trace_cb=trace_cb)
        last = self.graph.flow[-1]
        if last.dst_scalar:
            out = env[last.dst[0]]
            if isinstance(out, tuple) and len(out) == 1:
                return out[0]
            return out
        out = [env[n] for n in last.dst]
        return out[0] if len(out) == 1 else tuple(out)

    def initial_env(self, *inputs) -> dict[str, Any]:
        env: dict[str, Any] = {"None": None}
        for name, w in zip(self.graph.init_names(), self.weights):
            env[name] = w
        for name, x in zip(self.graph.inputs, inputs):
            env[name] = _as_tensor(x, self.device)
        return env

    # ------------------------------------------------------------- internals
    def _on_device(self, v):
        if isinstance(v, np.ndarray) or (isinstance(v, torch.Tensor)
                                         and v.device != self.device):
            return torch.as_tensor(v, device=self.device)
        return v

    @float32_exact()
    def run_range(self, env: dict[str, Any], start: int, stop: int,
                  debug: bool = False, free: bool = True,
                  trace_cb: Callable | None = None) -> dict[str, Any]:
        """Execute flow edges [start, stop) in place on ``env``; with
        ``free`` drop each value from ``env`` once no later edge reads
        it."""
        flow = self.graph.flow
        for i in range(start, stop):
            edge = flow[i]
            for li, lname in enumerate(edge.layers):
                layer = self._layers[lname]
                spec = get_op(layer.op)
                # chain semantics: the first layer reads edge.src, the rest
                # read the edge dst written by their predecessor
                src = edge.src if li == 0 else edge.dst
                args = [self._on_device(env.get(s)) for s in src]
                if free and li == len(edge.layers) - 1:
                    for s in set(edge.src):
                        if s in env and self.life.get(s, -1) <= i:
                            del env[s]
                if self.timed:
                    out = self._timed(layer, spec.oracle_fn, args)
                else:
                    out = spec.oracle_fn(*args, **layer.kwargs)
                if debug:
                    ish = [getattr(a, "shape", a) for a in args]
                    osh = (tuple(getattr(o, "shape", o) for o in out)
                           if isinstance(out, tuple)
                           else getattr(out, "shape", out))
                    print(f"{lname} [{layer.op}] {layer.kwargs} "
                          f"in={ish} out={osh}")
                if trace_cb is not None:
                    trace_cb(i, lname, layer, args, out)
                # a bare-string dst stores the WHOLE result (even a tuple)
                if edge.dst_scalar or not isinstance(out, tuple):
                    env[edge.dst[0]] = out
                else:
                    for name, v in zip(edge.dst, out):
                        env[name] = v
        return env

    def timeit(self, status: str = "start"):
        """The reference's per-opcode timer: ``"start"`` clears ``timer``
        and times every later run op by op; ``"end"`` stops and prints
        it."""
        if status == "start":
            self.timer, self.timed = {}, True
        if status == "end":
            self.timed = False
            for k, v in self.timer.items():
                print(k, v)

    def _timed(self, layer, fn, args):
        cuda = self.device.type == "cuda"
        if cuda:
            torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        out = fn(*args, **layer.kwargs)
        if cuda:
            torch.cuda.synchronize(self.device)
        dt = time.perf_counter() - t0
        self.timer[layer.op] = self.timer.get(layer.op, 0.0) + dt
        return out
