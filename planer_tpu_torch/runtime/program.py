"""IR -> straight-line torch program: the port's counterpart of
``planer_tpu/runtime/tracer.py``.

PyTorch runs eagerly, so there is nothing to trace or compile; the program
keeps the tracer's decisions and runs the flow on the device:

1. **Staticness analysis** (``analyze``, the tracer's own): every op
   application is *static* (all inputs derivable from weights and shapes),
   a *shape* read (``shape`` of any tensor: a host value, even where the
   tensor itself is dynamic) or *dynamic*.  Static and shape applications
   are folded on the host each call and never reach the device; the
   analysis is per application, not per name.
2. **Cut point**: the first application that cannot run with static shapes
   (a data-dependent op, a dynamic shape operand).  The flow from there on
   (the *tail*) runs in the float32 ``Executor`` on the program's device,
   as the JAX package runs it in its numpy executor: seeded with the
   prefix's values (compute-dtype outputs as float32), the static values
   and the weights.
3. **Run**: dynamic applications call the registry's ``fn`` on device
   tensors.  Weights consumed dynamically are materialized once
   (quantization layer hook), cast to the compute dtype where they are
   floating point, and kept on the device.

While ``profiler.trace`` is active (the module flag ``TRACING``, read once
per call), each dynamic application runs inside
``torch.profiler.record_function(<IR layer name>)``, the counterpart of the
tracer's ``jax.named_scope``; outside a trace the loop enters no scope.
``Program.cost_analysis`` counts the work of the graph at given input
shapes, the counterpart of XLA's cost analysis of the compiled program.

The compute-dtype policy is the tracer's: ``conv`` and ``add`` get the
program compute dtype injected (their int8 fast paths cannot infer it),
int8 graph inputs are lifted to float at the boundary (user values, never
activation codes), and outputs in the compute dtype leave as float32.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from ..device import resolve_device
from ..ir import Graph
from ..ops.qtypes import QTensor
from ..ops.torch_ops import to_dtype
from ..registry import get_op
from .executor import Executor

__all__ = ["Program", "analyze", "GraphPlan"]

# set by profiler.trace while a torch.profiler trace is active
TRACING = False


@dataclasses.dataclass(frozen=True)
class AppRecord:
    """Decision for one (edge, chain-position) op application."""

    edge: int
    li: int
    kind: str                      # 'shape' | 'static' | 'dyn'
    arg_static: tuple[bool, ...]   # per positional input: read from static env?


@dataclasses.dataclass
class GraphPlan:
    """Result of staticness analysis over a Graph."""

    records: list[AppRecord]
    dyn_weights: set[str]          # inits consumed as runtime data -> params
    cut: int                       # first non-runnable flow index
    cut_reason: str | None = None


def analyze(graph: Graph) -> GraphPlan:
    layers = graph.layer_map()
    static: set[str] = set(graph.init_names()) | {"None"}
    inits = set(graph.init_names())
    dyn_weights: set[str] = set()
    records: list[AppRecord] = []
    cut = len(graph.flow)
    reason = None

    for i, edge in enumerate(graph.flow):
        stop = False
        for li, lname in enumerate(edge.layers):
            layer = layers[lname]
            spec = get_op(layer.op)
            src = edge.src if li == 0 else edge.dst
            in_static = tuple(s in static for s in src)
            if layer.op == "shape":
                # a tensor's shape is known without its values: static
                records.append(AppRecord(i, li, "shape", in_static))
                static.update(edge.dst)
                continue
            if all(in_static):
                records.append(AppRecord(i, li, "static", in_static))
                static.update(edge.dst)
                continue
            if spec.data_dependent:
                stop = True
                reason = f"{lname}[{layer.op}] is data-dependent"
                break
            bad = [p for p in spec.static_args
                   if p < len(src) and not in_static[p]]
            if bad:
                stop = True
                reason = (f"{lname}[{layer.op}] needs static operand(s) "
                          f"{bad} but they are input-dependent")
                break
            records.append(AppRecord(i, li, "dyn", in_static))
            for p, s in enumerate(src):
                if in_static[p] and s in inits and p not in spec.static_args:
                    dyn_weights.add(s)
            for d in edge.dst:
                static.discard(d)
        if stop:
            cut = i
            break

    return GraphPlan(records, dyn_weights, cut, reason)


def _store(env_tgt, env_other, edge, out):
    """Write an op result to the destination env, honoring the scalar-dst
    convention (a bare-string dst holds the WHOLE result, even a tuple)."""
    if edge.dst_scalar:
        env_tgt[edge.dst[0]] = out
        env_other.pop(edge.dst[0], None)
    elif isinstance(out, tuple):
        for n, v in zip(edge.dst, out):
            env_tgt[n] = v
            env_other.pop(n, None)
    else:
        env_tgt[edge.dst[0]] = out
        env_other.pop(edge.dst[0], None)


_UNSET = object()


def _to_device(v, device):
    if isinstance(v, QTensor):
        return QTensor(_to_device(v.q, device), _to_device(v.scale, device),
                       act_dynamic=v.act_dynamic, act_scale=v.act_scale)
    if isinstance(v, torch.Tensor):
        return v.to(device)
    return torch.as_tensor(np.asarray(v), device=device)


def _host(v):
    """A static value as a host tensor (numpy arrays and scalars wrap)."""
    if v is None or isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v))


class Program:
    """Straight-line execution of a Graph on one device.

    ``weight_materializer(name, leaf, op)`` lets the quantization layer
    override how a params leaf is turned into what an op consumes;
    ``param_transform`` turns the raw weights into params (e.g. QTensors).
    ``op_overrides`` injects per-opcode kwargs, e.g.
    ``{"stage64": {"force_decomposed": True}}`` or ``{"conv": {"plain":
    True}}`` (the kernels' plain versions, see the registry).
    """

    def __init__(self, graph: Graph, weights: list,
                 weight_materializer: Callable | None = None,
                 param_transform: Callable | None = None,
                 compute_dtype: str | None = None, device="cuda"):
        graph.validate()
        self.graph = graph
        self.weights = weights
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self.op_overrides: dict[str, dict] = {}
        self.plan = analyze(graph)
        self._tail: Executor | None = None
        self._layers = graph.layer_map()
        self._cdt = to_dtype(compute_dtype)

        name_to_w = dict(zip(graph.init_names(), weights))
        self._senv0 = {"None": None, **name_to_w}
        params = {n: name_to_w[n] for n in sorted(self.plan.dyn_weights)}
        if param_transform is not None:
            params = param_transform(params)
        self.params = {n: _to_device(v, self.device)
                       for n, v in params.items()}
        # materialize every dynamically consumed weight once, per consumer
        self._wargs: dict[tuple[int, int], Any] = {}
        self._caches: dict[int, dict] = {}
        for ri, rec in enumerate(self.plan.records):
            if rec.kind != "dyn":
                continue
            edge = graph.flow[rec.edge]
            layer = self._layers[edge.layers[rec.li]]
            spec = get_op(layer.op)
            src = edge.src if rec.li == 0 else edge.dst
            for p, s in enumerate(src):
                if rec.arg_static[p] and p not in spec.static_args \
                        and s in self.params:
                    leaf = self.params[s]
                    if weight_materializer is not None:
                        leaf = weight_materializer(s, leaf, layer.op)
                    self._wargs[(ri, p)] = self._cast_in(leaf)
            if spec.cached:
                self._caches[ri] = {}

    # ------------------------------------------------------------- casting
    def _cast_in(self, v):
        if self._cdt is not None and isinstance(v, torch.Tensor) \
                and v.is_floating_point():
            return v.to(self._cdt)
        return v

    def _cast_graph_in(self, v):
        # int8 GRAPH INPUTS are user values, never activation codes: the
        # pre-quantized s8 conv gate keys on dtype alone, so lift them
        if self.graph.quant and v.dtype == torch.int8:
            return v.to(self._cdt or torch.float32)
        return self._cast_in(v)

    def _cast_out(self, v):
        # serve float32 at the boundary regardless of the compute dtype
        if isinstance(v, tuple):
            return tuple(self._cast_out(t) for t in v)
        if self._cdt is not None and isinstance(v, torch.Tensor) \
                and v.dtype == self._cdt:
            return v.float()
        return v

    # ----------------------------------------------------------------- tail
    def _executor(self) -> Executor:
        """The float32 executor of the tail (and of ``cost_analysis``) on
        the program's weights (dequantized in a quantized program)."""
        if self._tail is None:
            self._tail = Executor(self.graph, self.weights,
                                  device=self.device)
        return self._tail

    def _run_tail(self, env, senv):
        """Run flow[cut:] in the float32 executor on the program's device,
        seeded with the static values, the weights and the prefix's
        dynamic values (compute-dtype outputs as float32)."""
        self._executor()
        tenv = self._tail.initial_env()
        # static values take precedence over the weights, as in the JAX
        # package's tail (a name the flow rebinds holds the new value)
        tenv.update({n: v for n, v in senv.items()
                     if self._senv0.get(n, _UNSET) is not v})
        tenv.update({n: self._cast_out(v) for n, v in env.items()})
        return self._tail.run_range(tenv, self.plan.cut,
                                    len(self.graph.flow))

    # ------------------------------------------------------------------ run
    @torch.inference_mode()
    def __call__(self, *inputs):
        graph = self.graph
        if len(inputs) != len(graph.inputs):
            raise TypeError(
                f"model expects {len(graph.inputs)} input(s) "
                f"{graph.inputs}, got {len(inputs)}")
        overrides = self.op_overrides
        if self._cdt is not None:
            overrides = dict(overrides)
            for op in ("conv", "add"):
                overrides[op] = {**overrides.get(op, {}),
                                 "compute_dtype": self.compute_dtype}
        scoped = TRACING
        env: dict[str, Any] = {}                  # dynamic values (device)
        senv: dict[str, Any] = dict(self._senv0)  # static values (host)
        for n, x in zip(graph.inputs, inputs):
            env[n] = self._bind_input(
                self._cast_graph_in(_to_device(x, self.device)))

        for ri, rec in enumerate(self.plan.records):
            edge = graph.flow[rec.edge]
            layer = self._layers[edge.layers[rec.li]]
            spec = get_op(layer.op)
            src = edge.src if rec.li == 0 else edge.dst

            if rec.kind == "shape":
                v = env[src[0]] if src[0] in env else senv[src[0]]
                _store(senv, env, edge, np.asarray(tuple(v.shape), np.int64))
                continue

            if rec.kind == "static":
                out = spec.fn(*[_host(senv[s]) for s in src], **layer.kwargs)
                _store(senv, env, edge, out)
                continue

            args = []
            for p, s in enumerate(src):
                if (ri, p) in self._wargs:
                    args.append(self._wargs[(ri, p)])
                elif rec.arg_static[p]:
                    v = senv[s]
                    args.append(v if p in spec.static_args or v is None
                                else _to_device(v, self.device))
                else:
                    args.append(env[s])
            kw = layer.kwargs
            ov = overrides.get(layer.op)
            if ov:
                kw = {**kw, **ov}
            if scoped:
                with torch.profiler.record_function(edge.layers[rec.li]):
                    out = self._apply(ri, rec, layer, spec, args, kw)
            else:
                out = self._apply(ri, rec, layer, spec, args, kw)
            _store(env, senv, edge, out)
        return self._finish(env, senv)

    # the steps a program over several devices (``parallel``) replaces
    def _bind_input(self, x):
        """A graph input as the program holds it."""
        return x

    def _apply(self, ri, rec, layer, spec, args, kw):
        """Run the dynamic application ``ri`` of ``layer`` on ``args``."""
        if spec.cached:
            kw = {**kw, "cache": self._caches[ri]}
        return spec.fn(*args, **kw)

    def _finish(self, env, senv):
        """The graph's outputs: the host tail where the flow was cut, the
        final edge's values cast to the boundary dtype."""
        graph = self.graph
        final = graph.flow[-1]
        if self.plan.cut < len(graph.flow):
            env = self._run_tail(env, senv)
            res = [env[n] for n in final.dst]
        else:
            res = [self._cast_out(env[n] if n in env else _host(senv[n]))
                   for n in final.dst]
        if final.dst_scalar:
            out = res[0]
            if isinstance(out, tuple) and len(out) == 1:
                return out[0]
            return out
        return res[0] if len(res) == 1 else tuple(res)

    # ------------------------------------------------------------ profiling
    def cost_analysis(self, *inputs) -> dict:
        """{"flops", "bytes accessed"} of one call at these inputs, counted
        over the float32 executor's run of the whole graph (the fused
        stages as their decomposed chains): 2 per multiply-add of every
        conv and GEMM (``torch.utils.flop_counter``) plus 1 per output
        element of every other op; each op reading its inputs and writing
        its output once, weights at their stored width, activations at the
        compute dtype's.  The hand kernels do the same multiply-adds."""
        from torch.utils.flop_counter import FlopCounterMode
        ex = self._executor()
        itemsize = {id(t): _itemsize(d) for t, (_, _, d)
                    in zip(ex.weights, self.graph.inits)}
        act = (self._cdt or torch.float32).itemsize
        gemm_ops = {"conv", "dense", "matmul", "convtranspose", "stage64",
                    "stagen", "lstm", "gru"}
        tally = {"elementwise": 0, "bytes": 0}

        def nbytes(v):
            if isinstance(v, tuple):
                return sum(nbytes(t) for t in v)
            if not isinstance(v, torch.Tensor):
                return 0
            return v.numel() * itemsize.get(id(v), act)

        def count(i, lname, layer, args, out):
            tally["bytes"] += sum(nbytes(a) for a in args) + nbytes(out)
            if layer.op not in gemm_ops:
                outs = out if isinstance(out, tuple) else (out,)
                tally["elementwise"] += sum(
                    o.numel() for o in outs if isinstance(o, torch.Tensor))

        with FlopCounterMode(display=False) as fc:
            ex.run(*inputs, trace_cb=count)
        return {"flops": float(fc.get_total_flops() + tally["elementwise"]),
                "bytes accessed": float(tally["bytes"])}


def _itemsize(dtype_name) -> int:
    """Bytes per element of an init dtype name (fp8 payloads: 1)."""
    return 1 if "float8" in str(dtype_name) else np.dtype(dtype_name).itemsize
