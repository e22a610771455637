"""Carry a model across from the JAX package to the port.

``net_from_arrays`` takes what ``planer_tpu`` holds for a Net — its
``Graph.to_json_dict()`` and its list of weight arrays, int8 payloads,
``~scale`` inits and ``meta["act_scales"]`` included — and returns a port
``Net`` that computes the same thing.  Nothing here imports the JAX package:
the caller hands over plain dicts and arrays.  A float8_e4m3fn payload may
come as the JAX package's ``ml_dtypes`` array or as its uint8 bytes; the
port keeps the bytes (``ops.fp8``).
"""
from __future__ import annotations

import copy

import numpy as np

from .ir import Graph
from .ops import fp8
from .runtime.net import Net

__all__ = ["net_from_arrays"]


def net_from_arrays(graph_json: dict, weights, device="cuda",
                    compute_dtype: str | None = None) -> Net:
    graph = Graph.from_json_dict(copy.deepcopy(graph_json))
    ws = [np.array(w) for w in weights]
    for i, ((name, shape, dtype), w) in enumerate(zip(graph.inits, ws)):
        got = str(w.dtype)
        if fp8.is_fp8(dtype) and got in (fp8.NAME, "uint8"):
            ws[i] = w = w.view(np.uint8)
            got = dtype
        if tuple(w.shape) != tuple(shape) or got != dtype:
            raise ValueError(f"weight {name!r}: {w.dtype}{tuple(w.shape)} "
                             f"does not match the graph's {dtype}{tuple(shape)}")
    if len(ws) != len(graph.inits):
        raise ValueError(f"{len(ws)} weights for {len(graph.inits)} inits")
    return Net(graph, ws, compute_dtype=compute_dtype, device=device)
