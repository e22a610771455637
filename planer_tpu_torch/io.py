"""Model I/O: ``.pla`` (zip of json graph + npy weight blob), loose
``.json`` + ``.npy``, and ``.onnx`` converted on the fly by the frontend —
wire-compatible with ``planer_tpu/io.py``, so either package reads what the
other writes.  A path is resolved in that order: ``.pla``, then ``.json``,
then ``.onnx``.
"""
from __future__ import annotations

import io as _io
import json
import os
import zipfile

import numpy as np

from .ir import Graph, pack_weights
from .ops import fp8
from .runtime.net import Net

__all__ = ["read_net", "InferenceSession", "save_pla", "load_graph",
           "onnx2pla"]


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
        from .frontend.onnx_convert import convert_onnx
        return convert_onnx(path + ".onnx")
    raise FileNotFoundError(f"model {path!r} not found "
                            f"(.pla/.json+.npy/.onnx all missing)")


def read_net(path: str, debug: bool = False, *, device="cuda") -> Net:
    """Load a model from disk onto ``device`` (keyword only).  ``debug``
    prints each layer's JSON before loading, as the JAX package's
    ``read_net`` does."""
    graph, blob = load_graph(path)
    if debug:
        for layer in graph.layers:
            print(layer.to_json())
    net = Net(graph, device=device)
    net.load_weights(blob)
    return net


InferenceSession = read_net


def save_pla(path: str, graph: Graph, weights: list[np.ndarray]):
    """Write a .pla package (zip of json + npy blob).  Each weight must
    have its init's dtype: a halved net's weights do not, and are refused."""
    for (name, _, dtype), w in zip(graph.inits, weights):
        have = str(w.dtype).replace("torch.", "")
        if have != ("uint8" if fp8.is_fp8(dtype) else str(dtype)):
            raise ValueError(
                f"save_pla: weight {name!r} is {have} but its init says "
                f"{dtype} (a halved net has no .pla form; save it before "
                f"half())")
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


def onnx2pla(path: str, zip: bool = True, quantize: str | None = None):
    """Convert an .onnx file to .pla (or loose .json + .npy with
    zip=False) beside it; ``quantize`` ("int8" or "fp8") stores quantized
    weights.  Conversion runs nothing on a device."""
    from .frontend.onnx_convert import convert_onnx
    graph, blob = convert_onnx(path)
    # quantize_net rewrites the host weights only
    net = Net(graph, device="cpu")
    net.load_weights(blob)
    if quantize:
        net.quantize(mode=quantize)
    base = path[:-5] if path.endswith(".onnx") else path
    if zip:
        return save_pla(base, net.graph, net.weights)
    with open(base + ".json", "w") as f:
        f.write(net.graph.to_json())
    np.save(base + ".npy", pack_weights(net.weights))
    return base + ".json"
