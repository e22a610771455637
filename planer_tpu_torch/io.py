"""Model I/O: ``.pla`` (zip of json graph + npy weight blob) and loose
``.json`` + ``.npy`` — wire-compatible with ``planer_tpu/io.py``, so either
package reads what the other writes.  ONNX import is not ported yet.
"""
from __future__ import annotations

import io as _io
import json
import os
import zipfile

import numpy as np

from .ir import Graph, pack_weights
from .runtime.net import Net

__all__ = ["read_net", "InferenceSession", "save_pla", "load_graph"]


def load_graph(path: str):
    """Resolve path -> (Graph, blob).  Accepts a path with or without
    extension."""
    path = path.replace(".onnx", "").replace(".pla", "").replace(".json", "")
    if os.path.exists(path + ".pla"):
        with zipfile.ZipFile(path + ".pla") as f:
            base = os.path.split(path)[1]
            body = json.loads(f.read(base + ".json"))
            blob = np.load(_io.BytesIO(f.read(base + ".npy")))
        return Graph.from_json_dict(body), blob
    if os.path.exists(path + ".json"):
        with open(path + ".json") as f:
            body = json.load(f)
        blob = np.load(path + ".npy")
        return Graph.from_json_dict(body), blob
    if os.path.exists(path + ".onnx"):
        raise NotImplementedError("ONNX import is not ported yet; convert "
                                  "with planer_tpu.io.onnx2pla first")
    raise FileNotFoundError(f"model {path!r} not found "
                            f"(.pla/.json+.npy both missing)")


def read_net(path: str, device="cuda") -> Net:
    """Load a model from disk onto ``device``."""
    graph, blob = load_graph(path)
    net = Net(graph, device=device)
    net.load_weights(blob)
    return net


InferenceSession = read_net


def save_pla(path: str, graph: Graph, weights: list[np.ndarray]):
    """Write a .pla package (zip of json + npy blob)."""
    if path.endswith(".pla"):
        path = path[:-4]
    base = os.path.split(path)[1]
    blob = pack_weights(weights)
    bio = _io.BytesIO()
    np.save(bio, blob)
    with zipfile.ZipFile(path + ".pla", "w", zipfile.ZIP_DEFLATED) as f:
        f.writestr(base + ".json", graph.to_json())
        f.writestr(base + ".npy", bio.getvalue())
    return path + ".pla"
