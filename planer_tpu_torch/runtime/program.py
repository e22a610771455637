"""IR -> compiled straight-line torch program: the port's counterpart of
``planer_tpu/runtime/tracer.py``.

The program keeps the tracer's decisions and its compile step:

1. **Staticness analysis** (``analyze``, the tracer's own): every op
   application is *static* (all inputs derivable from weights and shapes),
   a *shape* read (``shape`` of any tensor: a host value, even where the
   tensor itself is dynamic) or *dynamic*.  Static and shape applications
   are folded on the host and never reach the device; the analysis is per
   application, not per name.
2. **Cut point**: the first application that cannot run with static shapes
   (a data-dependent op, a dynamic shape operand).  The flow from there on
   (the *tail*) runs in the float32 ``Executor`` on the program's device,
   as the JAX package runs it in its numpy executor: seeded with the
   prefix's values (compute-dtype outputs as float32), the static values
   and the weights.
3. **Compile, per input signature** (``_entry``, ``_compile``): the key
   holds each input's (shape, dtype, device), a snapshot of
   ``op_overrides``' content and the call-time switches the ops read
   (``torch_ops.switches``), so a reassigned or updated overrides dict, or
   a flipped module flag, never reuses an entry.  The first call at a key
   walks the flow once: the shape and static records run on the host and
   their values are kept (the tracer's ``statics``), and every dynamic
   application is resolved once — its arguments (weights, static values
   moved to the device, and as host values the operands an op reads on
   the host, the registry's ``host_args``), its kwargs with the overrides
   and the compute dtype, its ``cache`` — into a straight-line list of
   calls.  Later calls run that list and fold nothing.
4. **Run on CUDA**: the first walk is the warm run, on the program's side
   stream and outside any capture (kernels build, their tables fold, cached
   constants fill); the list up to the cut is then captured once into a
   ``torch.cuda.CUDAGraph`` (thread-local capture mode, one memory pool per
   program), the counterpart of the command buffers XLA runs a compiled
   program as on a GPU.  Each later call copies its inputs into the
   graph's static inputs, replays it and returns a fresh device copy of
   each output.  An input on the card is copied (and cast) into a buffer
   in the graph's dtype; an input in host memory is copied as it is into
   a pinned buffer of the entry (``native.stage_copy``: non-temporal
   stores, as only the copy engine reads it), from there by an
   asynchronous copy into a device buffer in its own dtype, and the graph
   casts it on the card (a CUDA event recorded after that copy keeps the
   next call from writing the pinned buffer before the copy has read
   it).  Every kernel module's ``LAUNCHES`` and ``FALLOFF`` (the inventory
   in ``ops/kernels``) gets the delta the capture recorded, so they keep
   counting what the card ran.  A capture that fails raises with the layer
   it reached; nothing runs eagerly in its place.  The first call at a key
   answers from its warm run.  A program on the CPU, and a ``parallel``
   program over distinct cards, run the resolved list uncaptured; a
   ``parallel`` program whose mesh repeats one card captures like any
   other.

``_run`` is the eager loop the entry is resolved from (every record folded
again at every call): the reference a caller holds the compiled entry
against.  While ``profiler.trace`` is active with its layers
(``profiler.TRACING``, read once per call), the program runs the entry's
list eagerly, each dynamic application inside
``torch.profiler.record_function(<IR layer name>)``, the counterpart of
the tracer's ``jax.named_scope``; outside such a trace no scope is
entered.  While ``profiler.record`` is active (``profiler.RECORDING``, read
once per call), a call takes the same steps inside its spans:
``program.call`` around ``program.inputs`` (the inputs as tensors, the
key, the lookup), then on a replay ``program.copy_in``,
``program.replay``, ``program.copy_out`` and ``program.finish``, or
``program.eager`` and ``program.finish`` where the list runs uncaptured;
``_compile`` and ``_capture`` are the spans ``program.compile`` and
``program.capture``.  It counts the caller's input bytes copied in by
where they live (``in_bytes.pageable``, ``.pinned``, ``.device``),
the replays whose inputs went through the pinned buffers
(``copy_in.staged``), ``replays``, ``eager_runs``, ``compiles`` and
``captures``.  Off, a call reads the flag and no clock.  ``lowered_text``
is the text of the entry at a signature; ``cost_analysis`` counts the work
of the graph at given input shapes, the counterpart of XLA's cost analysis
of the compiled program.

The compute-dtype policy is the tracer's: inputs narrow at the boundary
as ``jnp.asarray`` narrows them with 64-bit mode off (float64 to float32,
int64 to int32, before the key is taken, so a float64 batch takes the
float32 entry), ``conv`` and ``add`` get the program compute dtype
injected (their int8 fast paths cannot infer it), int8 graph inputs are
lifted to float at the boundary (user values, never activation codes),
and outputs in the compute dtype leave as float32.  Every call, compile,
capture and ``lowered_text`` runs under ``device.float32_exact``: float32
convolutions and matmuls are float32 (not TF32) whatever the caller has
set, the caller's setting comes back after, and a graph captured that way
replays the float32 kernels.
"""
from __future__ import annotations

import collections
import contextlib
import dataclasses
import threading
import time
from typing import Any, Callable

import numpy as np
import torch

from .. import native as _native
from ..device import float32_exact, narrow_64bit, resolve_device
from ..ir import Graph
from ..ops import kernels as _kernels
from ..ops import torch_ops as tops
from ..ops.qtypes import QTensor
from ..ops.torch_ops import to_dtype
from ..registry import get_op
from . import profiler as _prof
from .executor import Executor

__all__ = ["Program", "analyze", "GraphPlan"]


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


def _as_tensor(x):
    """A caller's input as a tensor (numpy arrays wrap, on the host), 64-bit
    values narrowed as ``jnp.asarray`` narrows them."""
    return narrow_64bit(x if isinstance(x, torch.Tensor)
                        else torch.as_tensor(np.asarray(x)))


def _fresh(v):
    """A device copy of an output, so a later replay cannot overwrite an
    answer already handed out."""
    if isinstance(v, tuple):
        return tuple(_fresh(t) for t in v)
    return v.clone() if isinstance(v, torch.Tensor) else v


def _freeze(v):
    """A hashable snapshot of an overrides value's content."""
    if isinstance(v, dict):
        return tuple(sorted((str(k), _freeze(x)) for k, x in v.items()))
    if isinstance(v, (list, tuple)):
        return tuple(_freeze(x) for x in v)
    try:
        hash(v)
    except TypeError:
        return repr(v)
    return v


def _sig(v) -> str:
    """A value's dtype and shape for ``lowered_text``."""
    if isinstance(v, tuple):
        return "(" + ", ".join(_sig(t) for t in v) + ")"
    if isinstance(v, QTensor):
        return f"q{_sig(v.q)}"
    if isinstance(v, torch.Tensor):
        return f"{str(v.dtype).replace('torch.', '')}{list(v.shape)}"
    if v is None:
        return "None"
    if not isinstance(v, np.ndarray) and hasattr(v, "parts"):
        # a parallel program's value split over shards
        return (f"{type(v).__name__.lower()} "
                f"{str(v.dtype).replace('torch.', '')}{list(v.shape)}")
    a = np.asarray(v)
    return f"host {a.dtype}{list(a.shape)}"


def _kernel_nodes(graph) -> int:
    """Kernel nodes of a captured (kept) CUDA graph, read through the
    driver API."""
    import ctypes
    cu = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)

    def check(err, what):
        if err:
            raise RuntimeError(f"{what} failed: CUDA driver error {err}")

    check(cu.cuGraphGetNodes(raw, None, ctypes.byref(n)), "cuGraphGetNodes")
    nodes = (ctypes.c_void_p * max(n.value, 1))()
    check(cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)), "cuGraphGetNodes")
    kind, count = ctypes.c_int(0), 0
    for node in nodes[:n.value]:
        check(cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind)),
              "cuGraphNodeGetType")
        count += kind.value == 0                  # CU_GRAPH_NODE_TYPE_KERNEL
    return count


@dataclasses.dataclass(frozen=True)
class _Ref:
    """An argument read from the dynamic env at run time."""

    name: str


@dataclasses.dataclass
class _Step:
    """One resolved dynamic application (``args`` hold values or
    ``_Ref``s), or, with ``layer`` None, the dynamic names ``drop`` that a
    static record rebinds."""

    ri: int
    rec: AppRecord | None
    layer: Any
    spec: Any
    args: list
    kw: dict
    edge: Any
    name: str
    drop: tuple = ()
    text: str = ""


@dataclasses.dataclass
class _Entry:
    """The compiled program at one key: the folded statics, the resolved
    list, the names the tail and the outputs read from the prefix, and on
    CUDA the captured graph with its static buffers: per input the device
    buffer the graph reads (``static_in``) and, for an input in host
    memory, the pinned buffer it is staged through (``staging``, else
    None), with the event recorded after the copies out of them
    (``staged``, None where no input is staged), and the (kernel counter,
    launches or fall-offs) pairs a replay adds (``delta``)."""

    key: tuple
    steps: list
    statics: dict
    folded: int
    needs: list
    lines: list
    graph: Any = None
    static_in: list = dataclasses.field(default_factory=list)
    staging: list = dataclasses.field(default_factory=list)
    staged: Any = None
    static_out: dict = dataclasses.field(default_factory=dict)
    delta: list = dataclasses.field(default_factory=list)
    kernel_nodes: int | None = None
    capture_ms: float | None = None


class Program:
    """Compiled straight-line execution of a Graph on one device.

    ``weight_materializer(name, leaf, op)`` lets the quantization layer
    override how a params leaf is turned into what an op consumes;
    ``param_transform`` turns the raw weights into params (e.g. QTensors).
    ``op_overrides`` injects per-opcode kwargs, e.g.
    ``{"stage64": {"force_decomposed": True}}`` or ``{"conv": {"plain":
    True}}`` (the kernels' plain versions, see the registry); its content
    is part of every entry's key.
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
        self._cache: dict[tuple, _Entry] = {}
        self._lock = threading.RLock()
        self._pool = None              # the graphs' memory pool
        self._side = None              # the warm-run and capture stream
        self._streams: dict = {}       # (card, raw handle) -> torch Stream

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

    def _suffix_needs(self) -> list[str]:
        """Names the host tail reads from the prefix (the final outputs
        where there is no tail), as the tracer lists them."""
        flow = self.graph.flow
        if self.plan.cut >= len(flow):
            return list(flow[-1].dst)
        produced: set[str] = set()
        needs: list[str] = []
        for e in flow[self.plan.cut:]:
            for s in e.src:
                if s not in produced and s not in needs:
                    needs.append(s)
            produced.update(e.dst)
        for s in flow[-1].dst:
            if s not in produced and s not in needs:
                needs.append(s)
        return needs

    # ------------------------------------------------------------------ run
    def _overrides(self) -> dict:
        overrides = self.op_overrides
        if self._cdt is not None:
            overrides = dict(overrides)
            for op in ("conv", "add"):
                overrides[op] = {**overrides.get(op, {}),
                                 "compute_dtype": self.compute_dtype}
        return overrides

    def _inputs(self, inputs) -> list:
        if len(inputs) != len(self.graph.inputs):
            raise TypeError(
                f"model expects {len(self.graph.inputs)} input(s) "
                f"{self.graph.inputs}, got {len(inputs)}")
        return [_as_tensor(x) for x in inputs]

    def _bind(self, inputs) -> dict:
        return {n: self._bind_input(self._cast_graph_in(
                    _to_device(x, self.device)))
                for n, x in zip(self.graph.inputs, inputs)}

    def _walk(self, inputs, steps=None, scoped=False):
        """Run the flow once: the shape and static records on the host,
        each dynamic application on the device.  With ``steps`` (a list),
        append each application as it was resolved, and the names a static
        record takes from the dynamic env.  Returns the dynamic and static
        envs."""
        graph = self.graph
        overrides = self._overrides()
        if steps is not None:
            counters = _kernels.counters()
        env: dict[str, Any] = self._bind(inputs)    # dynamic values (device)
        senv: dict[str, Any] = dict(self._senv0)    # static values (host)
        for ri, rec in enumerate(self.plan.records):
            edge = graph.flow[rec.edge]
            lname = edge.layers[rec.li]
            layer = self._layers[lname]
            spec = get_op(layer.op)
            src = edge.src if rec.li == 0 else edge.dst

            if rec.kind != "dyn":
                if rec.kind == "shape":
                    v = env[src[0]] if src[0] in env else senv[src[0]]
                    out = spec.fn(v)
                else:
                    out = spec.fn(*[_host(senv[s]) for s in src],
                                  **layer.kwargs)
                drop = tuple(n for n in edge.dst if n in env)
                if steps is not None and drop:
                    steps.append(_Step(ri, None, None, None, [], {}, edge,
                                       lname, drop))
                _store(senv, env, edge, out)
                continue

            args = []
            for p, s in enumerate(src):
                if p in spec.host_args and rec.arg_static[p]:
                    args.append(senv[s])
                elif (ri, p) in self._wargs:
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
            if steps is not None:
                step = _Step(ri, rec, layer, spec,
                             [a if rec.arg_static[p] else _Ref(s)
                              for p, (s, a) in enumerate(zip(src, args))],
                             kw, edge, lname)
                before = {k: collections.Counter(c)
                          for k, c in counters.items()}
            if scoped:
                with torch.profiler.record_function(lname):
                    out = self._apply(ri, rec, layer, spec, args, kw)
            else:
                out = self._apply(ri, rec, layer, spec, args, kw)
            if steps is not None:
                step.text = self._line(step, args, out, {
                    k: c - before[k] for k, c in counters.items()})
                steps.append(step)
            _store(env, senv, edge, out)
        return env, senv

    @float32_exact()
    def _run(self, *inputs):
        """The eager loop: every record folded and every application
        resolved again at this call, nothing cached or captured — the
        reference the compiled entry is held against."""
        with torch.inference_mode():
            env, senv = self._walk(self._inputs(inputs))
            return self._finish(env, senv)

    def _run_steps(self, entry, env, scoped=False, where=None):
        """Run an entry's resolved list on ``env`` (its inputs bound)."""
        for st in entry.steps:
            if st.layer is None:
                for n in st.drop:
                    env.pop(n, None)
                continue
            if where is not None:
                where[0] = st.name
            args = [env[a.name] if isinstance(a, _Ref) else a
                    for a in st.args]
            if scoped:
                with torch.profiler.record_function(st.name):
                    out = self._apply(st.ri, st.rec, st.layer, st.spec,
                                      args, st.kw)
            else:
                out = self._apply(st.ri, st.rec, st.layer, st.spec, args,
                                  st.kw)
            _store(env, {}, st.edge, out)
        return env

    # ------------------------------------------------------------ compile
    def _key(self, inputs) -> tuple:
        specs = tuple((tuple(x.shape), x.dtype, str(x.device))
                      for x in inputs)
        return specs, _freeze(self.op_overrides), tops.switches()

    def _captures(self) -> bool:
        """Whether the entries run as CUDA graphs: on the card."""
        return self.device.type == "cuda"

    def _current_stream(self, index: int):
        """The current stream of card ``index`` (the one a copy and a replay
        are enqueued on), kept per raw handle: ``torch.cuda.current_stream``
        costs 10-20 us a call on the H100's host, the handle's lookup a
        fraction of that."""
        key = (index, torch._C._cuda_getCurrentRawStream(index))
        stream = self._streams.get(key)
        if stream is None:
            stream = self._streams[key] = torch.cuda.current_stream(index)
        return stream

    def _stream(self):
        if self._side is None:
            self._side = torch.cuda.Stream(self.device)
            self._pool = torch.cuda.graph_pool_handle()
        return self._side

    def _entry(self, *inputs) -> _Entry:
        """The compiled entry at these inputs' key, compiled (and on CUDA
        captured) on first use."""
        inputs = self._inputs(inputs)
        with self._lock, torch.inference_mode(), float32_exact():
            key = self._key(inputs)
            if key not in self._cache:
                self._compile(key, inputs)
            return self._cache[key]

    @_prof.spanned("program.compile", "compiles")
    @float32_exact()
    def _compile(self, key, inputs, scoped=False):
        """Walk the flow once at ``key`` (on CUDA: the warm run, on the
        side stream), keep the folded statics and the resolved list, and on
        CUDA capture the list (unless traced: then at the next call).
        Returns the walk's answer."""
        steps: list[_Step] = []
        cuda = self._captures()
        ctx = contextlib.nullcontext()
        if cuda:
            side = self._stream()
            side.wait_stream(torch.cuda.current_stream(self.device))
            ctx = torch.cuda.stream(side)
        with ctx:
            env, senv = self._walk(inputs, steps=steps, scoped=scoped)
        entry = _Entry(key, steps, dict(senv),
                       sum(r.kind != "dyn" for r in self.plan.records),
                       self._suffix_needs(),
                       [st.text for st in steps if st.layer is not None])
        if cuda:
            torch.cuda.current_stream(self.device).wait_stream(side)
            if not scoped:
                self._capture(entry, inputs)
        self._cache[key] = entry
        return self._finish(env, senv)

    @_prof.spanned("program.capture", "captures")
    @float32_exact()
    def _capture(self, entry, inputs):
        """Capture the entry's list into a CUDA graph with static input
        and output buffers; record the kernel counters' delta and leave
        the counters as they were (a capture runs nothing).  A host input's
        buffer keeps the caller's dtype and the graph casts it first."""
        dev = self.device
        entry.staging = [
            torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            if x.device.type == "cpu" else None for x in inputs]
        entry.static_in = [
            torch.empty(x.shape, dtype=x.dtype, device=dev) if pin is not None
            else torch.empty_like(self._cast_graph_in(_to_device(x, dev)))
            for x, pin in zip(inputs, entry.staging)]
        if any(pin is not None for pin in entry.staging):
            entry.staged = torch.cuda.Event()
            _native.load()                 # the staging copy, built once
        counters = _kernels.counters()
        before = {k: collections.Counter(c) for k, c in counters.items()}
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        where = ["(inputs)"]
        t0 = time.perf_counter()
        try:
            with torch.cuda.graph(graph, pool=self._pool,
                                  stream=self._stream(),
                                  capture_error_mode="thread_local"):
                # (no-op on a buffer already in the graph's dtype)
                env = {n: self._bind_input(self._cast_graph_in(x)) for n, x
                       in zip(self.graph.inputs, entry.static_in)}
                self._run_steps(entry, env, where=where)
                where[0] = "(outputs)"
                entry.static_out = {n: self._cast_out(self._whole(env[n]))
                                    for n in entry.needs if n in env}
        except Exception as e:
            raise RuntimeError(
                f"CUDA graph capture of {self.graph.inputs} at "
                f"{entry.key[0]} failed at layer {where[0]}: {e}") from e
        finally:
            entry.delta = [(c, d) for k, c in counters.items()
                           if (d := c - before[k])]
            for k, c in counters.items():
                c.clear()
                c.update(before[k])
        entry.kernel_nodes = _kernel_nodes(graph)
        graph.instantiate()
        torch.cuda.synchronize(dev)
        entry.capture_ms = 1e3 * (time.perf_counter() - t0)
        entry.graph = graph

    @torch.inference_mode()
    @float32_exact()
    def __call__(self, *inputs):
        """Run the entry at these inputs' key: compile it on first use
        (answering from the walk), replay its graph on the card (its inputs
        copied in, each output copied out), run its list elsewhere or while
        traced.  Under ``profiler.record`` each step is a span of
        ``program.call``, with the counters; a replayed call asks where its
        inputs live only once its replay runs."""
        rec = _prof.RECORDING
        with _prof.NO_SPAN if rec is None else \
                rec.span("program.call") as call:
            if rec is not None:
                t = time.time_ns()
            inputs = self._inputs(inputs)
            scoped = _prof.TRACING
            with self._lock:
                key = self._key(inputs)
                entry = self._cache.get(key)
                if rec is not None:
                    t = rec.step(call, "program.inputs", t)
                if entry is None:
                    return self._compile(key, inputs, scoped)
                if scoped or not self._captures():
                    env = self._run_steps(entry, self._bind(inputs), scoped)
                    if rec is not None:
                        rec.count("eager_runs")
                        t = rec.step(call, "program.eager", t)
                    out = self._finish(env, entry.statics)
                    if rec is not None:
                        rec.step(call, "program.finish", t)
                    return out
                if entry.graph is None:        # compiled under a trace
                    self._capture(entry, inputs)
                    if rec is not None:
                        t = time.time_ns()
                staged = entry.staged
                if staged is not None:
                    # the last call's copies out of the pinned buffers have
                    # run (in a closed loop it has long fired)
                    staged.synchronize()
                for pin, buf, x in zip(entry.staging, entry.static_in,
                                       inputs):
                    if pin is None:
                        buf.copy_(x)
                    else:
                        _native.stage_copy(pin, x)
                        buf.copy_(pin, non_blocking=True)
                if staged is not None:
                    staged.record(self._current_stream(
                        entry.static_in[0].get_device()))
                if rec is not None:
                    t2 = time.time_ns()
                entry.graph.replay()
                if rec is not None:
                    t3 = time.time_ns()
                    rec.step(call, "program.copy_in", t, t2)
                    rec.step(call, "program.replay", t2, t3)
                    for x in inputs:
                        rec.count("in_bytes." + _prof.where(x), x.nbytes)
                    if staged is not None:
                        rec.count("copy_in.staged")
                    rec.count("replays")
                    t = time.time_ns()
                env = {n: _fresh(v) for n, v in entry.static_out.items()}
                for c, d in entry.delta:
                    c.update(d)
                if rec is not None:
                    t = rec.step(call, "program.copy_out", t)
            out = self._finish(env, entry.statics)
            if rec is not None:
                rec.step(call, "program.finish", t)
            return out

    # the steps a program over several devices (``parallel``) replaces
    def _bind_input(self, x):
        """A graph input as the program holds it."""
        return x

    def _whole(self, v):
        """A value as one tensor on the program's device (a parallel
        program gathers its shards)."""
        return v

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
    def _route_text(self, step, args, launched) -> str:
        """What an application ran: the hand kernels it launched (on the
        CPU, or with ``plain``, their plain versions), the ``_int_mm``
        chain of an s8 conv, cuDNN, cuBLAS, or other ATen ops."""
        op, kw = step.layer.op, step.kw
        kernels = _kernels.kernel_names(launched)
        if kernels:
            return " + ".join(f"{k} x{n}" for k, n in kernels.items())
        cuda = self.device.type == "cuda"
        if op in ("stage64", "stagen"):
            if kw.get("force_decomposed") or any(
                    d for (_, c), d in launched.items() if c == "FALLOFF"):
                return "decomposed"
            cache = self._caches.get(step.ri, {})
            plan = next(iter(cache.values()), None)
            if op == "stage64":
                nb = (len(args) - 3) // 4
                kernels = {"stem_kernel": 1, **({"block_kernel": nb}
                                                if nb else {})}
            elif plan is not None:
                kernels = {"block_kernel": len(plan.blocks)}
            return "plain[" + " + ".join(
                f"{k} x{n}" for k, n in kernels.items()) + "]"
        if op in ("conv", "dense") and isinstance(args[1], QTensor):
            from ..ops.kernels import gemm
            if op == "conv":
                x = args[0]
                route = kw.get("route") or tops.conv_route(
                    tuple(x.shape), x.dtype, args[1], kw.get("group", 1),
                    kw.get("strides"), kw.get("dilations"), kw.get("pads"),
                    kw.get("auto_pad"))
            else:
                n, kd = args[1].q.shape
                route = kw.get("branch") or (
                    "gemm" if gemm.tile_plan(
                        int(np.prod(args[0].shape)) // kd, n, kd)
                    is not None else "gemm_fallback")
                route = {"kernel": "gemm", "fallback": "gemm_fallback"}.get(
                    route, route)
            if route in ("s8", "w8a8"):
                return "_int_mm"
            if route == "gemm":
                return "plain[dense_q_kernel x1]"
            if route == "gemm_fallback":
                return "fallback_dense (cublas)" if cuda else "plain"
        if not cuda:
            return "plain"
        if op in ("conv", "convtranspose"):
            return "cudnn"
        if op in ("dense", "matmul", "lstm", "gru"):
            return "cublas"
        return "aten"

    def _line(self, step, args, out, launched) -> str:
        ins = ", ".join(_sig(a) for a in args)
        return (f"  {step.name}: {step.layer.op} "
                f"[{self._route_text(step, args, launched)}] ({ins}) -> "
                f"{_sig(out)}")

    def lowered_text(self, *inputs) -> str:
        """The compiled entry at these inputs' signature, as text: one line
        per dynamic application in flow order (layer, opcode, route, input
        and output dtypes and shapes), the folded statics, the cut and the
        tail, and on CUDA the captured graph's kernel nodes."""
        entry = self._entry(*inputs)
        specs = ", ".join(f"{str(d).replace('torch.', '')}{list(s)} on {v}"
                          for s, d, v in entry.key[0])
        folded = sum(self._senv0.get(n, _UNSET) is not v
                     for n, v in entry.statics.items())
        flow = self.graph.flow
        out = [f"program {self.graph.inputs}: ({specs}), compute dtype "
               f"{self.compute_dtype or 'float32'}, overrides "
               f"{dict(self.op_overrides)}",
               f"folded statics: {entry.folded} records, {folded} values "
               f"beside the weights"]
        out += entry.lines
        if self.plan.cut < len(flow):
            out.append(f"cut: flow[{self.plan.cut}] of {len(flow)} "
                       f"({self.plan.cut_reason}); tail flow[{self.plan.cut}:"
                       f"{len(flow)}] in the float32 executor on "
                       f"{self.device}, reading {entry.needs}")
        else:
            out.append(f"cut: none; no tail ({len(flow)} flow edges)")
        if entry.graph is not None:
            out.append(f"graph: CUDA graph, {entry.kernel_nodes} kernel "
                       f"nodes, captured in {entry.capture_ms:.3f} ms")
        elif self._captures():
            out.append("graph: not captured yet (compiled under a trace)")
        else:
            out.append(f"graph: none (runs uncaptured on {self.device})")
        return "\n".join(out)

    def cost_analysis(self, *inputs) -> dict:
        """{"flops", "bytes accessed"} of one call at these inputs, counted
        over the float32 executor's run of the whole graph (the fused
        stages as their decomposed chains): 2 per multiply-add of every
        conv and GEMM (``torch.utils.flop_counter``) plus 1 per output
        element of every other op; each op reading its inputs and writing
        its output once, weights at their stored width, activations at the
        compute dtype's.  The hand kernels do the same multiply-adds."""
        from torch.utils.flop_counter import FlopCounterMode
        inputs = self._inputs(inputs)
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
