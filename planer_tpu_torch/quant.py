"""Quantization: per-output-channel INT8 or FP8 (e4m3fn) weights,
calibrated static activation scales, and the quantized program — the
port's counterpart of ``planer_tpu/quant.py``.

  * :func:`calibrate_act_scales` runs batches through the float32 executor
    and records, per conv weight, the percentile of |input| (taken with
    ``np.percentile`` on the host, as the reference does);
  * :func:`quantize_net` rewrites GEMM-shaped weights to int8 or
    float8_e4m3fn with per-output-channel absmax scales and records them in
    ``graph.quant`` (the same IR and bytes as the JAX package's pass; fp8
    payloads live on the host as uint8 bit patterns, ``ops.fp8``);
  * :func:`make_quant_program` builds a :class:`Program` whose params carry
    the int8 or fp8 payloads and scales as QTensors.
"""
from __future__ import annotations

import numpy as np

from .ir import Graph
from .ops import fp8
from .ops.qtypes import QTensor
from .runtime.program import Program

__all__ = ["quantize_net", "dequant_weights", "make_quant_program",
           "calibrate_act_scales", "QTensor"]

# ops with a quantizable weight at positional input 1, and the output-channel
# axis of that weight
_QUANT_OPS = {
    "conv": 0,           # OIHW
    "dense": 0,          # (O, I) — stored transposed by the converter
    "convtranspose": 1,  # (I, O/g, kh, kw)
    "matmul": -1,        # (..., I, O): per-column scales on the last axis
    "stage64": 0,        # fused entry stage: conv weights at odd positions
    "stagen": 0,         # fused body stage: conv weights at odd positions
}


def _is_weight_pos(op: str, p: int) -> bool:
    if op in ("stage64", "stagen"):
        return p % 2 == 1    # [x, Ws, Bs, W1, B1, W2, B2, ...]
    return p == 1


# mode: (the payload's init dtype name, the largest magnitude it takes)
_MODES = {
    "int8": ("int8", 127.0),
    "fp8": (fp8.NAME, fp8.MAX),
}


def calibrate_act_scales(net, batches, percentile: float = 99.99) -> dict:
    """Run calibration batches through the float32 executor, recording the
    per-tensor activation scale of every conv's input.  Returns
    {weight_name: scale} and stores it in graph.meta["act_scales"].

    A graph fused before calibration (e.g. loaded from a fused .pla) has
    its stage64 and stagen chains replayed so the stages' internal convs
    get scales too.
    """
    from .ops import torch_ops as tops
    graph: Graph = net.graph
    layers = graph.layer_map()
    wname_by_layer: dict[str, str] = {}
    stage_wnames: dict[str, list[str]] = {}
    inits = set(graph.init_names())
    for e in graph.flow:
        for li, lname in enumerate(e.layers):
            src = e.src if li == 0 else e.dst
            if layers[lname].op == "conv":
                if len(src) > 1 and src[1] in inits:
                    wname_by_layer[lname] = src[1]
            elif layers[lname].op in ("stage64", "stagen"):
                # weights are (W, B) pairs after x: convs at odd positions
                stage_wnames[lname] = [src[p] for p in
                                       range(1, len(src)) if p % 2 == 1]
    maxima: dict[str, float] = {}

    def record(w, x):
        a = np.abs(x.detach().float().cpu().numpy()).ravel()
        m = float(np.percentile(a, percentile)) if percentile < 100 \
            else float(a.max())
        maxima[w] = max(maxima.get(w, 0.0), m)

    def cb(i, lname, layer, args, out):
        if layer.op == "conv" and lname in wname_by_layer:
            record(wname_by_layer[lname], args[0])
        elif layer.op == "stage64" and lname in stage_wnames:
            names = stage_wnames[lname]
            x, Ws, Bs = args[0], args[1], args[2]
            record(names[0], x)
            y = tops.maxpool(tops.relu(
                tops.conv2d(x, Ws, Bs, strides=(2, 2), pads=(3, 3, 3, 3))),
                w=(3, 3), pads=(1, 1, 1, 1), strides=(2, 2))
            bw = args[3:]
            for k in range(0, len(bw), 4):
                W1, B1, W2, B2 = bw[k:k + 4]
                record(names[1 + (k // 4) * 2], y)
                y1 = tops.relu(tops.conv2d(y, W1, B1, strides=(1, 1),
                                           pads=(1, 1, 1, 1)))
                record(names[2 + (k // 4) * 2], y1)
                y = tops.relu(tops.conv2d(y1, W2, B2, strides=(1, 1),
                                          pads=(1, 1, 1, 1)) + y)
        elif layer.op == "stagen" and lname in stage_wnames:
            # the same replay for fused body stages: the decomposed chain
            # shows each conv's input, in weight order
            from .ops.kernels.stagen import decomposed
            names = iter(stage_wnames[lname])
            decomposed(*args, blocks=layer.kwargs["blocks"],
                       on_conv=lambda x: record(next(names), x))

    oracle = net.oracle
    for x in batches:
        oracle.run(*(x if isinstance(x, tuple) else (x,)), trace_cb=cb)
    scales = {w: max(m, 1e-6) / 127.0 for w, m in maxima.items()}
    graph.meta["act_scales"] = scales
    net._invalidate()
    return scales


def quantize_net(net, mode: str = "int8", skip: tuple = (),
                 activations: str | None = None):
    """In-place weight quantization of a Net's GEMM-shaped weights, to int8
    (``mode="int8"``) or float8_e4m3fn (``mode="fp8"``, weights / (absmax /
    448) cast to e4m3 with round-to-nearest-even, stored as uint8 bit
    patterns under the init dtype name ``"float8_e4m3fn"``).

    ``activations="static"`` uses the scales of a prior
    :func:`calibrate_act_scales` run; ``"dynamic"`` quantizes activations
    per call where the s8 path applies."""
    if mode not in _MODES:
        raise NotImplementedError(f"quantize mode {mode!r} is not ported "
                                  f"yet (ported: {sorted(_MODES)})")
    qname, qmax = _MODES[mode]
    graph: Graph = net.graph
    users = graph.weight_users()
    idx = graph.init_index()
    new_inits = list(graph.inits)
    quant = dict(graph.quant)

    for name, ulist in users.items():
        if name in skip or name in quant:
            continue
        # quantize only weights used EXCLUSIVELY as the weight operand of
        # GEMM-shaped ops — anything else keeps full precision
        if not ulist or not all(op in _QUANT_OPS and _is_weight_pos(op, p)
                                for op, p in ulist):
            continue
        i = idx[name]
        w = net.weights[i]
        if w.dtype != np.float32 or w.ndim < 2:
            continue
        out_axis = _QUANT_OPS[ulist[0][0]] % w.ndim
        red = tuple(a for a in range(w.ndim) if a != out_axis)
        absmax = np.maximum(np.abs(w).max(axis=red, keepdims=True), 1e-12)
        scale = (absmax / qmax).astype(np.float32)
        if mode == "int8":
            q = np.clip(np.round(w / scale), -qmax, qmax).astype(np.int8)
        else:
            q = fp8.encode(w / scale)
        sname = name + "~scale"
        net.weights[i] = q
        net.weights.append(scale)
        new_inits[i] = (name, tuple(q.shape), qname)
        new_inits.append((sname, tuple(scale.shape), str(scale.dtype)))
        quant[name] = {"scale": sname, "axis": out_axis,
                       "orig_dtype": "float32", "mode": mode}

    graph.inits = new_inits
    graph.quant = quant
    if activations:
        graph.meta["act_quant"] = activations
    return net


def dequant_weights(graph: Graph, weights: list[np.ndarray]) -> list[np.ndarray]:
    """Full-precision view of a (possibly) quantized weight list — what the
    float32 executor runs on.  fp8 payloads decode by their init's dtype
    name."""
    if not graph.quant:
        return weights
    idx = graph.init_index()
    out = list(weights)
    for name, info in graph.quant.items():
        i = idx[name]
        q = weights[i]
        q = fp8.decode(q) if fp8.is_fp8(graph.inits[i][2]) \
            else q.astype(np.float32)
        s = weights[idx[info["scale"]]]
        out[i] = (q * s).astype(info["orig_dtype"])
    return out


def make_quant_program(graph: Graph, weights: list[np.ndarray],
                       compute_dtype: str | None = None,
                       device="cuda") -> Program:
    idx = graph.init_index()
    deq = dequant_weights(graph, weights)
    act_mode = graph.meta.get("act_quant")
    act_scales = graph.meta.get("act_scales", {})

    def param_transform(params: dict) -> dict:
        out = {}
        for name, leaf in params.items():
            info = graph.quant.get(name)
            if info is None:
                out[name] = leaf
            else:
                a_scale = act_scales.get(name) if act_mode == "static" else None
                q = weights[idx[name]]
                if fp8.is_fp8(graph.inits[idx[name]][2]):
                    q = fp8.to_tensor(q)
                out[name] = QTensor(q,
                                    weights[idx[info["scale"]]],
                                    act_dynamic=act_mode in ("dynamic",
                                                             "static"),
                                    act_scale=a_scale)
        return out

    def materialize(name, leaf, op):
        # fused stages fold their requant scales on the host from the
        # QTensor's scale and from the biases as the program casts them
        # (bf16-rounded in a bf16 program), like the reference
        if op in ("stage64", "stagen"):
            return leaf
        if isinstance(leaf, QTensor):
            if op in _QUANT_OPS:
                return leaf  # quant-aware op consumes the payload directly
            return leaf.dequant()
        return leaf

    return Program(graph, deq, weight_materializer=materialize,
                   param_transform=param_transform,
                   compute_dtype=compute_dtype, device=device)
