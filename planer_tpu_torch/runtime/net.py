"""``Net`` — the user-facing graph container of the port (the counterpart of
``planer_tpu/runtime/net.py``): build or load a graph, optimize, quantize,
run.  A Net lives on one device, CUDA unless the caller asks for the CPU.

Its weights are host arrays: numpy, except the float32 weights that
``half("bfloat16")`` rounds, which are CPU torch bfloat16 tensors (numpy
has no bfloat16 without ``ml_dtypes``).
"""
from __future__ import annotations

import time

import numpy as np
import torch

from ..device import resolve_device
from ..ir import FlowEdge, Graph, Layer, unpack_weights
from ..ops import fp8
from . import profiler as _prof
from .executor import Executor
from .program import Program

__all__ = ["Net"]


def _numpy(v):
    """numpy of an output (a bfloat16 tensor widened to float32, exactly:
    numpy has no bfloat16)."""
    if isinstance(v, tuple):
        return tuple(_numpy(t) for t in v)
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu()
        return (v.float() if v.dtype == torch.bfloat16 else v).numpy()
    return np.asarray(v)


def _nbytes(v) -> int:
    if isinstance(v, tuple):
        return sum(_nbytes(t) for t in v)
    return v.nbytes


class Net:
    def __init__(self, graph: Graph | None = None,
                 weights: list[np.ndarray] | None = None,
                 compute_dtype: str | None = None, device="cuda"):
        self.device = resolve_device(device)
        self.graph = graph
        self.weights: list[np.ndarray] = weights if weights is not None else []
        self.compute_dtype = compute_dtype   # e.g. 'bfloat16'
        self._program: Program | None = None
        self._oracle: Executor | None = None
        self._timed = False                  # carried to a rebuilt oracle

    # ------------------------------------------------------------- building
    def load_json(self, inputs, inits, body, flow, debug: bool = False):
        """Build the graph from the reference's JSON parts, with zero
        weights until ``load_weights``."""
        g = Graph(
            inputs=list(inputs),
            inits=[(i[0], tuple(i[1]), i[2]) for i in inits],
            layers=[Layer.from_json(list(b)) for b in body],
            flow=[FlowEdge.from_json(list(f)) for f in flow],
        )
        if debug:
            for b in body:
                print(b)
        g.validate()
        self.graph = g
        self.weights = [np.zeros(s, np.uint8 if fp8.is_fp8(d) else d)
                        for _, s, d in g.inits]
        self._invalidate()
        return self

    def load_weights(self, blob):
        """Split the contiguous uint8 blob into per-init arrays."""
        self.weights = unpack_weights(self.graph, np.asarray(blob))
        self._invalidate()

    def load_state(self, state: dict, strict: bool = False) -> int:
        """Load weights (e.g. pretrained, ``models.eval.load_real_weights``)
        from a name -> array dict, before ``quantize()``: each entry must
        have its float32 init's shape.  Returns the number loaded; unknown
        names are skipped, or raise ``KeyError`` when ``strict``."""
        idx = self.graph.init_index()
        n = 0
        for name, arr in state.items():
            i = idx.get(name)
            if i is None:
                if strict:
                    raise KeyError(f"unknown init {name!r}")
                continue
            arr = np.asarray(arr)
            want = self.weights[i]
            if tuple(arr.shape) != tuple(want.shape):
                raise ValueError(
                    f"{name}: shape {arr.shape} != init {tuple(want.shape)}")
            self.weights[i] = np.ascontiguousarray(arr, dtype=want.dtype)
            n += 1
        self._invalidate()
        return n

    # ------------------------------------------------------------ precision
    def half(self, dtype: str = "float16"):
        """Cast the float32 weights down to ``dtype``.  Every op casts a
        weight to its input's dtype, so a halved net computes in float32 on
        the rounded weights, as the JAX package's does.  bfloat16 weights
        are CPU torch tensors; ``pack_weights`` takes them, ``save_pla``
        refuses a halved net (its init table still says float32)."""
        for i, w in enumerate(self.weights):
            if isinstance(w, np.ndarray) and w.dtype == np.float32:
                self.weights[i] = (torch.as_tensor(w).to(torch.bfloat16)
                                   if str(dtype) == "bfloat16"
                                   else w.astype(dtype))
        self._invalidate()

    # ------------------------------------------------------------ transforms
    def optimize(self):
        """IR passes (BN folding, pool hints).  Call before quantize()."""
        from ..optimize import optimize as _opt
        return _opt(self)

    def quantize(self, mode: str = "int8", skip: tuple = (),
                 activations: str | None = None, fuse: bool | None = None):
        """Per-output-channel weight quantization.  With
        ``activations='static'`` (scales from a prior
        calibrate_act_scales run) the ResNet entry stage is also fused into
        the stage64 kernels and int8 codes are chained between convs
        (``fuse=False`` to disable).  ``fuse='all'`` also fuses the body
        stages (optimize.fuse_stagen); those fused at a supported geometry
        (R = 28 and 56 at 224) run the stagen kernel.

        ``mode='fp8'`` stores float8_e4m3fn weights (scale = absmax / 448)
        and is weight-only: the s8 activation paths and the stage64 and
        stagen kernels take int8 weights, so fp8 convs dequantize to the
        compute dtype (and 1x1 ones take ``dense_q``'s fp8 kernel under
        ``torch_ops._PALLAS_CONV1X1``), and ``fuse`` defaults to off.  A
        stage fused anyway (``fuse=True`` or ``'all'``) runs its decomposed
        chain.

        ``fuse='all'`` reproduces the JAX package's fused-stage arithmetic,
        which is far from the float model on a calibrated net: at 224,
        max|d|/max|y| per image against the float32 executor has a p99 of
        0.51 on ResNet-50 and 0.44 on ResNet-18 (32 images on an H100,
        chip_smoke.py), against 0.024 for ResNet-50 with the default fuse.
        The projection residual's requant step clips nearly every residual
        code (ROADMAP "Faults found")."""
        from ..quant import quantize_net
        quantize_net(self, mode=mode, skip=skip, activations=activations)
        if fuse is None:
            fuse = activations == "static" and mode == "int8"
        if fuse:
            from ..optimize import (annotate_output_quant, fuse_stage64,
                                    fuse_stagen)
            fuse_stage64(self)
            if fuse == "all":
                fuse_stagen(self)
            annotate_output_quant(self)
        self._invalidate()
        return self

    def astype_compute(self, dtype: str | None):
        """Set the in-graph compute dtype ('bfloat16' on the card); weights
        and outputs stay float32 at the API boundary."""
        self.compute_dtype = dtype
        self._invalidate()
        return self

    # ------------------------------------------------------------ execution
    def _invalidate(self):
        self._program = None
        self._oracle = None

    @property
    def program(self) -> Program:
        if self._program is None:
            if self.graph.quant:
                from ..quant import make_quant_program
                self._program = make_quant_program(
                    self.graph, self.weights,
                    compute_dtype=self.compute_dtype, device=self.device)
            else:
                self._program = Program(self.graph, self.weights,
                                        compute_dtype=self.compute_dtype,
                                        device=self.device)
        return self._program

    @property
    def oracle(self) -> Executor:
        """The float32 executor on the dequantized weights."""
        if self._oracle is None:
            ws = self.weights
            if self.graph.quant:
                from ..quant import dequant_weights
                ws = dequant_weights(self.graph, ws)
            self._oracle = Executor(self.graph, ws, device=self.device)
            self._oracle.timed = self._timed
        return self._oracle

    def forward(self, *x, debug: bool = False, engine: str | None = None):
        """Run the program (device tensors out), or the float32 executor
        with ``engine='oracle'`` (``'numpy'``, the JAX package's name for
        its oracle, is accepted too), which fills ``timer`` after
        ``timeit("start")``."""
        if debug or engine in ("oracle", "numpy"):
            return self.oracle.run(*x, debug=debug)
        if engine is not None:
            raise ValueError(f"unknown engine {engine!r}")
        return self.program(*x)

    def __call__(self, *x, **kw):
        """Inputs as arrays or tensors (or one dict by input name); outputs
        as numpy arrays, like the JAX package's Net.  Under
        ``profiler.record`` the call is the span ``net.call`` and its copy
        out ``net.to_numpy``, which counts the bytes handed out."""
        rec = _prof.RECORDING
        with _prof.NO_SPAN if rec is None else rec.span("net.call") as call:
            if x and isinstance(x[0], dict):
                x = [x[0][i] for i in self.graph.inputs]
            rst = self.forward(*x, **kw)
            if isinstance(rst, tuple) and len(rst) == 1:
                rst = rst[0]
            if rec is None:
                return _numpy(rst)
            t = time.time_ns()
            out = _numpy(rst)
            rec.step(call, "net.to_numpy", t)
            rec.count("out_bytes", _nbytes(out))
            return out

    def run(self, output=None, input={}, **kw):
        """onnxruntime-style entry point."""
        rst = self(input, **kw)
        return rst if isinstance(rst, tuple) else (rst,)

    # ----------------------------------------------------------- inspection
    @property
    def input(self):
        return self.graph.inputs

    @property
    def inits(self):
        return self.graph.init_names()

    def info(self, obj):
        """Shapes of a value or a nested list of values."""
        if isinstance(obj, (list, tuple)):
            return [self.info(i) for i in obj]
        if hasattr(obj, "shape"):
            return obj.shape
        return obj

    @property
    def timer(self) -> dict:
        """Seconds per opcode of the float32 executor's timed runs (its
        ``Executor.timer``)."""
        return self._oracle.timer if self._oracle is not None else {}

    def timeit(self, status: str = "start"):
        """The float32 executor's per-opcode profile: ``"start"`` clears
        ``timer`` and times every later ``forward(engine="oracle")`` op by
        op (device time on the card); ``"end"`` prints it and stops."""
        if status == "start":
            self._timed = True
            self.oracle.timeit("start")
        if status == "end":
            self._timed = False
            if self._oracle is not None:
                self._oracle.timeit("end")

    def cost_analysis(self, *x):
        """{"flops", "bytes accessed"} of the program at these inputs'
        shapes (``Program.cost_analysis``)."""
        return self.program.cost_analysis(*x)

    def show(self, path: str | None = None):
        """Print a layer table and return the graph as graphviz DOT text
        (written to ``path`` when given)."""
        from ..utils.plot import plot_net
        return plot_net(self.graph, path)

    def __repr__(self):
        g = self.graph
        if g is None:
            return f"Net(empty, device={self.device})"
        return (f"Net({len(g.layers)} layers, {len(g.inits)} weights, "
                f"{len(g.flow)} flow edges, inputs={g.inputs}, "
                f"device={self.device})")
