"""JSON flow IR — the frontend contract of the framework.

A numpy copy of ``planer_tpu/ir.py``: the port must not import the JAX
package, and the two stay wire-compatible (same JSON, same weight blob).

The IR is kept wire-compatible with the original planer format (its
io.py:287 and net.py:10-24):

    {
      "input":  ["x", ...],                       # graph input tensor names
      "inits":  [[name, shape, dtype], ...],      # weight table (ordered)
      "layers": [[name, opcode, kwargs], ...],    # op instances
      "flow":   [[src, [layer, ...], dst], ...],  # edge program
    }

``src``/``dst`` are either a single tensor name or a list of names.  A chain
``[l1, l2, l3]`` in one edge threads the edge's dst through the intermediate
layers (reference net.py:43-62 semantics: the first layer reads ``src``, every
subsequent layer reads the edge's ``dst`` produced by its predecessor).

Weights travel as ONE contiguous uint8 blob, concatenated in ``inits`` order
(reference io.py:286, net.py:83-88).

Extensions over the reference (ignored by readers that don't know them):

  * ``"quant"``: {init_name: {"scale": scale_init_name, "axis": 0,
    "orig_dtype": "float32", "mode": "int8"}} — weight-only quantization
    metadata emitted by :mod:`planer_tpu.quant` ("mode" is "int8" or
    "fp8").
  * ``"meta"``: free-form dict (producer, opset, ...).
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np
import torch

from .ops import fp8

__all__ = [
    "Layer",
    "FlowEdge",
    "Graph",
    "pack_weights",
    "unpack_weights",
]


@dataclasses.dataclass
class Layer:
    """One op instance: a graph-build-time binding of an opcode + kwargs."""

    name: str
    op: str
    kwargs: dict[str, Any] = dataclasses.field(default_factory=dict)

    def to_json(self) -> list:
        return [self.name, self.op, self.kwargs]

    @staticmethod
    def from_json(obj: list) -> "Layer":
        name, op, kwargs = obj
        return Layer(name, op, dict(kwargs or {}))


@dataclasses.dataclass
class FlowEdge:
    """One edge of the flow program: src tensor(s) -> layer chain -> dst."""

    src: list[str]
    layers: list[str]
    dst: list[str]
    # True when the json had a bare string rather than a 1-list; kept so a
    # round-trip writes back byte-identical structure.
    src_scalar: bool = False
    dst_scalar: bool = False

    def to_json(self) -> list:
        src = self.src[0] if self.src_scalar else self.src
        dst = self.dst[0] if self.dst_scalar else self.dst
        return [src, list(self.layers), dst]

    @staticmethod
    def from_json(obj: list) -> "FlowEdge":
        src, layers, dst = obj
        src_scalar = isinstance(src, str)
        dst_scalar = isinstance(dst, str)
        if src_scalar:
            src = [src]
        if dst_scalar:
            dst = [dst]
        if isinstance(layers, str):
            layers = [layers]
        return FlowEdge(list(src), list(layers), list(dst), src_scalar, dst_scalar)


@dataclasses.dataclass
class Graph:
    """The whole model: inputs, weight table, op instances and flow."""

    inputs: list[str]
    inits: list[tuple[str, tuple[int, ...], str]]  # (name, shape, dtype-str)
    layers: list[Layer]
    flow: list[FlowEdge]
    quant: dict[str, dict] = dataclasses.field(default_factory=dict)
    meta: dict[str, Any] = dataclasses.field(default_factory=dict)

    # ------------------------------------------------------------- accessors
    def layer_map(self) -> dict[str, Layer]:
        return {l.name: l for l in self.layers}

    def init_names(self) -> list[str]:
        return [i[0] for i in self.inits]

    def init_index(self) -> dict[str, int]:
        return {name: i for i, (name, _, _) in enumerate(self.inits)}

    def outputs(self) -> list[str]:
        """Names of the tensors produced by the final flow edge."""
        return list(self.flow[-1].dst)

    def weight_users(self) -> dict[str, list[tuple[str, int]]]:
        """init name -> [(opcode, positional index)] across the flow program
        (chain semantics: non-first layers read the edge dst)."""
        users: dict[str, list[tuple[str, int]]] = {}
        layers = self.layer_map()
        inits = {n for n, _, _ in self.inits}
        for e in self.flow:
            for li, lname in enumerate(e.layers):
                src = e.src if li == 0 else e.dst
                for pidx, sname in enumerate(src):
                    if sname in inits:
                        users.setdefault(sname, []).append(
                            (layers[lname].op, pidx))
        return users

    # ------------------------------------------------------------ validation
    def validate(self) -> None:
        lm = self.layer_map()
        if len(lm) != len(self.layers):
            seen: set[str] = set()
            for l in self.layers:
                if l.name in seen:
                    raise ValueError(f"duplicate layer name: {l.name!r}")
                seen.add(l.name)
        defined = set(self.inputs) | {n for n, _, _ in self.inits} | {"None"}
        for e in self.flow:
            for l in e.layers:
                if l not in lm:
                    raise ValueError(f"flow references unknown layer {l!r}")
            for s in e.src:
                if s not in defined:
                    raise ValueError(f"flow edge reads undefined tensor {s!r}")
            defined.update(e.dst)

    # ------------------------------------------------------------- liveness
    def liveness(self) -> dict[str, int]:
        """tensor name -> index of the last flow edge that reads it.

        Mirrors the reference's eager-free table (net.py:16-19); used only by
        the numpy interpreter — the jitted path leaves liveness to XLA.
        """
        life: dict[str, int] = {}
        for i, e in enumerate(self.flow):
            for s in e.src:
                life[s] = i
        return life

    # -------------------------------------------------------------- json io
    def to_json_dict(self) -> dict:
        d = {
            "input": list(self.inputs),
            "inits": [[n, list(s), t] for n, s, t in self.inits],
            "layers": [l.to_json() for l in self.layers],
            "flow": [e.to_json() for e in self.flow],
        }
        if self.quant:
            d["quant"] = self.quant
        if self.meta:
            d["meta"] = self.meta
        return d

    def to_json(self) -> str:
        return json.dumps(self.to_json_dict())

    @staticmethod
    def from_json_dict(d: dict) -> "Graph":
        g = Graph(
            inputs=list(d["input"]),
            inits=[(n, tuple(s), t) for n, s, t in d["inits"]],
            layers=[Layer.from_json(x) for x in d["layers"]],
            flow=[FlowEdge.from_json(x) for x in d["flow"]],
            quant=dict(d.get("quant", {})),
            meta=dict(d.get("meta", {})),
        )
        return g

    @staticmethod
    def from_json(s: str) -> "Graph":
        return Graph.from_json_dict(json.loads(s))


# ---------------------------------------------------------------- weight blob
def pack_weights(arrays: list[np.ndarray]) -> np.ndarray:
    """Concatenate weight arrays into one contiguous uint8 blob.

    Wire-compatible with reference io.py:286.  A torch tensor (a halved
    net's bfloat16 weights) gives its own bytes.
    """
    if not arrays:
        return np.zeros(0, dtype=np.uint8)
    parts = [a.detach().cpu().contiguous().reshape(-1).view(torch.uint8)
             .numpy() if isinstance(a, torch.Tensor)
             else np.ascontiguousarray(a).view(np.uint8).ravel()
             for a in arrays]
    return np.concatenate(parts)


def unpack_weights(graph: Graph, blob: np.ndarray) -> list[np.ndarray]:
    """Split the uint8 blob back into arrays per the ``inits`` table.

    Wire-compatible with reference net.py:83-88 (raveled uint8 views copied
    in init order).  A float8_e4m3fn init comes back as its uint8 bit
    patterns (``ops.fp8``).
    """
    blob = np.asarray(blob).reshape(-1).view(np.uint8)
    out: list[np.ndarray] = []
    s = 0
    for name, shape, dtype in graph.inits:
        dt = np.dtype(np.uint8 if fp8.is_fp8(dtype) else dtype)
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = n * dt.itemsize
        arr = blob[s : s + nbytes].view(dt).reshape(shape if shape else (1,))
        if not shape:
            arr = arr.reshape(())
        out.append(arr.copy())
        s += nbytes
    if s != blob.size:
        # Tolerate trailing bytes (future format extensions) but never a
        # short blob.
        if s > blob.size:
            raise ValueError(
                f"weight blob too small: need {s} bytes, got {blob.size}"
            )
    return out
