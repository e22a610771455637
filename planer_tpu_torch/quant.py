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
    the int8 or fp8 payloads and scales as QTensors;
  * :func:`layer_quant_errors` ranks the convs by the error their weight
    quantization alone causes, and :func:`quantize_auto` quantizes with
    per-layer fallback until an accuracy budget holds.
"""
from __future__ import annotations

import numpy as np
import torch

from .ir import Graph
from .ops import fp8
from .ops.qtypes import QTensor
from .runtime.program import Program

__all__ = ["quantize_net", "dequant_weights", "make_quant_program",
           "calibrate_act_scales", "layer_quant_errors", "quantize_auto",
           "QTensor"]

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


def layer_quant_errors(net, batches, mode: str = "int8",
                       activations: str | None = None,
                       percentile: float = 99.9) -> dict:
    """Per-layer quantization-error attribution on calibration data.

    Runs the float32 executor once per batch; for every conv with a
    float32 initializer weight, recomputes that conv IN ISOLATION with
    simulated quantization (per-output-channel weights rounded at
    absmax / qmax, qmax 127 for int8 and 448 for fp8, as in the reference;
    per-tensor activation quantization at the ``percentile`` of |x| where
    ``activations`` is set and the conv would take the s8 path) and records
    max|yq - y| / max|y|.  The recomputation is float32 torch on the net's
    device, with TF32 off as in the executor.  Returns {weight_name:
    rel_err}, the ranking :func:`quantize_auto` falls back by.
    """
    from .ops import torch_ops as tops
    if mode not in _MODES:
        raise NotImplementedError(f"quantize mode {mode!r} is not ported")
    qmax = _MODES[mode][1]
    graph: Graph = net.graph
    inits = set(graph.init_names())
    idx = graph.init_index()
    errs: dict[str, float] = {}

    def sim_quant_w(w):
        red = tuple(range(1, w.ndim))
        absmax = w.abs().amax(dim=red, keepdim=True).clamp_min(1e-12)
        scale = absmax / qmax
        return torch.clamp(torch.round(w / scale), -qmax, qmax) * scale

    def cb(i, lname, layer, args, out):
        if layer.op != "conv":
            return
        src = graph.flow[i].src
        if len(src) < 2 or src[1] not in inits:
            return
        wname = src[1]
        w = net.weights[idx[wname]]
        if not isinstance(w, np.ndarray) or w.dtype != np.float32:
            return
        x = args[0].float()
        xq = x
        if activations and x.ndim == 4 and x.shape[1] >= 128 \
                and int(layer.kwargs.get("group", 1)) == 1:
            a = np.abs(x.cpu().numpy())
            sx = max(float(np.percentile(a, percentile)), 1e-6) / 127.0
            xq = torch.clamp(torch.round(x / sx), -127, 127) * sx
        b = args[2] if len(args) > 2 else None
        wq = sim_quant_w(torch.as_tensor(w, device=x.device))
        yq = tops.conv2d(xq, wq, b, **layer.kwargs)
        y = out.float()
        rel = float((yq - y).abs().max() / (y.abs().max() + 1e-9))
        errs[wname] = max(errs.get(wname, 0.0), rel)

    oracle = net.oracle
    for x in batches:
        oracle.run(*(x if isinstance(x, tuple) else (x,)), trace_cb=cb)
    return errs


def quantize_auto(net, mode: str = "int8", activations: str | None = None,
                  budget_top1: float = 0.995, budget_rel: float = 0.05,
                  eval_n: int = 64, eval_shape=(3, 224, 224),
                  calib_batches: int = 4, seed: int = 11,
                  max_fallbacks: int = 8, min_margin: float = 0.0,
                  verbose: bool = False):
    """Quantize with automatic per-layer fallback until the accuracy budget
    holds: the reference's trial loop.

    Quantizes every eligible weight, measures top-1 agreement and the
    relative output delta against the float32 net on structured synthetic
    inputs, and while the budget is violated returns the worst layer left
    (ranked by :func:`layer_quant_errors`) to full precision and measures
    again.  Raises ``RuntimeError`` when ``max_fallbacks`` fallbacks do not
    meet it; never returns an over-budget net.  On success the found
    configuration is applied to ``net`` in place.

    Returns {"skip": [...], "top1": float, "delta": {...},
    "layer_errors": {...}}.
    """
    import copy

    from .models import eval as _ev
    from .runtime.net import Net

    ref = Net(copy.deepcopy(net.graph), [w.copy() for w in net.weights],
              device=net.device)

    cal = list(_ev.synthetic_images(calib_batches * 2, eval_shape, seed=seed,
                                    batch=2))
    errs = layer_quant_errors(net, cal, mode=mode, activations=activations)
    if activations == "static":
        calibrate_act_scales(net, cal)
    order = sorted(errs, key=errs.get, reverse=True)

    base_graph = copy.deepcopy(net.graph)
    base_weights = [w.copy() for w in net.weights]
    skip: list[str] = []
    report = {}
    for trial in range(max_fallbacks + 1):
        cand = Net(copy.deepcopy(base_graph), [w.copy() for w in base_weights],
                   compute_dtype=net.compute_dtype, device=net.device)
        quantize_net(cand, mode=mode, skip=tuple(skip),
                     activations=activations)
        top1 = _ev.top1_agreement(ref, cand, n=eval_n, shape=eval_shape,
                                  seed=seed + 1, min_margin=min_margin)
        delta = _ev.output_delta(ref, cand, n=min(eval_n, 16),
                                 shape=eval_shape, seed=seed + 2)
        report = {"skip": list(skip), "top1": top1, "delta": delta,
                  "layer_errors": errs}
        if verbose:
            print(f"quantize_auto trial {trial}: top1={top1:.4f} "
                  f"max_rel={delta['max_rel']:.4f} skip={skip}")
        if top1 >= budget_top1 and delta["max_rel"] <= budget_rel:
            break
        nxt = [w for w in order if w not in skip]
        if not nxt:
            break
        skip.append(nxt[0])
    if report["top1"] < budget_top1 or report["delta"]["max_rel"] > budget_rel:
        raise RuntimeError(
            f"quantize_auto could not meet budget (top1 {report['top1']:.4f}"
            f" < {budget_top1} or delta {report['delta']['max_rel']:.4f} > "
            f"{budget_rel}) after {len(skip)} fallbacks")

    quantize_net(net, mode=mode, skip=tuple(skip), activations=activations)
    net._invalidate()
    return report


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
                       device="cuda", cls=Program, **kw) -> Program:
    """The quantized program of a graph: a ``cls`` (``Program`` or a
    subclass, which gets ``kw``) whose params are QTensors."""
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

    return cls(graph, deq, weight_materializer=materialize,
               param_transform=param_transform,
               compute_dtype=compute_dtype, device=device, **kw)
