"""Carry a model across from the JAX package to the port.

``net_from_arrays`` takes what ``planer_tpu`` holds for a Net — its
``Graph.to_json_dict()`` and its list of weight arrays, int8 payloads,
``~scale`` inits and ``meta["act_scales"]`` included — and returns a port
``Net`` that computes the same thing.  Nothing here imports the JAX package:
the caller hands over plain dicts and arrays.
"""
from __future__ import annotations

import copy

import numpy as np

from .ir import Graph
from .runtime.net import Net

__all__ = ["net_from_arrays"]


def net_from_arrays(graph_json: dict, weights, device="cuda",
                    compute_dtype: str | None = None) -> Net:
    graph = Graph.from_json_dict(copy.deepcopy(graph_json))
    ws = [np.array(w) for w in weights]
    for (name, shape, dtype), w in zip(graph.inits, ws):
        if tuple(w.shape) != tuple(shape) or str(w.dtype) != dtype:
            raise ValueError(f"weight {name!r}: {w.dtype}{tuple(w.shape)} "
                             f"does not match the graph's {dtype}{tuple(shape)}")
    if len(ws) != len(graph.inits):
        raise ValueError(f"{len(ws)} weights for {len(graph.inits)} inits")
    return Net(graph, ws, compute_dtype=compute_dtype, device=device)
