"""GraphBuilder — programmatic construction of flow-IR graphs.

A copy of ``planer_tpu/models/builder.py``: every opcode the port registers
becomes a method returning the symbolic name(s) of its output tensor(s).

    b = GraphBuilder(["x"])
    w = b.weight("conv1.w", kernel_array)
    y = b.conv(b.inp("x"), w, None, strides=[2, 2], pads=[3, 3, 3, 3])
    y = b.relu(y)
    b.ret(y)
    graph, weights = b.build()
"""
from __future__ import annotations

import numpy as np

from ..ir import Graph, Layer, FlowEdge
from ..registry import OPS, get_op

__all__ = ["GraphBuilder"]


class GraphBuilder:
    def __init__(self, inputs):
        if isinstance(inputs, str):
            inputs = [inputs]
        self.inputs = list(inputs)
        self.inits: list[tuple[str, tuple, str]] = []
        self.weights: list[np.ndarray] = []
        self.layers: list[Layer] = []
        self.flow: list[FlowEdge] = []
        self._ctr = 0

    # ------------------------------------------------------------- symbols
    def inp(self, name: str) -> str:
        assert name in self.inputs
        return name

    def fresh(self, hint: str = "t") -> str:
        self._ctr += 1
        return f"{hint}_{self._ctr}"

    def weight(self, name: str, array) -> str:
        array = np.asarray(array)
        self.inits.append((name, tuple(array.shape), str(array.dtype)))
        self.weights.append(array)
        return name

    # ----------------------------------------------------------------- ops
    def op(self, opcode: str, srcs, n_out: int | None = None,
           name: str | None = None, **kwargs):
        spec = get_op(opcode)
        if isinstance(srcs, str):
            srcs = [srcs]
        srcs = ["None" if s is None else s for s in srcs]
        lname = name or self.fresh(opcode)
        self.layers.append(Layer(lname, opcode, kwargs))
        if n_out is None:
            n_out = 1
        dsts = [self.fresh(opcode) for _ in range(n_out)]
        self.flow.append(FlowEdge(list(srcs), [lname], dsts,
                                  src_scalar=len(srcs) == 1,
                                  dst_scalar=n_out == 1))
        if n_out == 1:
            return dsts[0]
        return tuple(dsts)

    def ret(self, outputs):
        if isinstance(outputs, str):
            outputs = [outputs]
        self.layers.append(Layer("return", "return", {}))
        self.flow.append(FlowEdge(list(outputs), ["return"], ["plrst"],
                                  src_scalar=len(outputs) == 1,
                                  dst_scalar=True))

    def __getattr__(self, opcode):
        if opcode in OPS:
            def f(*srcs, n_out=None, name=None, **kwargs):
                return self.op(opcode, list(srcs), n_out=n_out, name=name,
                               **kwargs)
            return f
        raise AttributeError(opcode)

    # --------------------------------------------------------------- build
    def build(self) -> tuple[Graph, list[np.ndarray]]:
        g = Graph(inputs=self.inputs, inits=list(self.inits),
                  layers=list(self.layers), flow=list(self.flow))
        g.validate()
        return g, list(self.weights)

    def build_net(self, device="cuda"):
        from ..runtime.net import Net
        g, w = self.build()
        return Net(g, w, device=device)
