"""``Net`` — the user-facing graph container of the port (the counterpart of
``planer_tpu/runtime/net.py``): build or load a graph, optimize, quantize,
run.  A Net lives on one device, CUDA unless the caller asks for the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from ..ir import Graph, unpack_weights
from .executor import Executor
from .program import Program

__all__ = ["Net"]


def _numpy(v):
    if isinstance(v, tuple):
        return tuple(_numpy(t) for t in v)
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    return np.asarray(v)


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

    # ------------------------------------------------------------- building
    def load_weights(self, blob):
        """Split the contiguous uint8 blob into per-init arrays."""
        self.weights = unpack_weights(self.graph, np.asarray(blob))
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
        return self._oracle

    def forward(self, *x, debug: bool = False, engine: str | None = None):
        """Run the program (device tensors out), or the float32 executor
        with ``engine='oracle'`` (``'numpy'``, the JAX package's name for
        its oracle, is accepted too)."""
        if debug or engine in ("oracle", "numpy"):
            return self.oracle.run(*x, debug=debug)
        if engine is not None:
            raise ValueError(f"unknown engine {engine!r}")
        return self.program(*x)

    def __call__(self, *x, **kw):
        """Inputs as arrays or tensors (or one dict by input name); outputs
        as numpy arrays, like the JAX package's Net."""
        if x and isinstance(x[0], dict):
            x = [x[0][i] for i in self.graph.inputs]
        rst = self.forward(*x, **kw)
        if isinstance(rst, tuple) and len(rst) == 1:
            return _numpy(rst[0])
        return _numpy(rst)

    def run(self, output=None, input={}, **kw):
        """onnxruntime-style entry point."""
        rst = self(input, **kw)
        return rst if isinstance(rst, tuple) else (rst,)

    def __repr__(self):
        g = self.graph
        if g is None:
            return f"Net(empty, device={self.device})"
        return (f"Net({len(g.layers)} layers, {len(g.inits)} weights, "
                f"{len(g.flow)} flow edges, inputs={g.inputs}, "
                f"device={self.device})")
