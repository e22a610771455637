"""The YOLO family (``"family": "yolo"``): everything of a YOLO-v3
configuration (Darknet-53 and three FPN heads) that the harness reaches by
name.

The system under test: the flow-IR graph the port's zoo builds
(``models.yolov3(decode=False)``: conv -> batchnorm (affine K, B) ->
leakyrelu, residual adds, upsample and concat routes, three raw heads) and
the seeded float arrays, and the pipeline a user runs to make its static
W8A8 program.  The yardstick: the seeded images, the step's work counted
from the layer shapes, the plain reference (``yolo_ref``), its comparison
with the answers and the control put in the program's place.

``arrays`` draws the weights from the run seed on the device as the zoo
draws them (He-normal convs, BatchNorm K ~ 1 + 0.05 N, B ~ 0.05 N), with the
heads' biases drawn small (0.05 N) so that their add is exercised.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import compare as cmp
from .. import inputs as seeded
from . import resnet
from . import yolo_ref as ref

# the calibration batches and the traffic's images are ResNet's
calibration = resnet.calibration
inputs = resnet.inputs


def graph_json(cfg) -> dict:
    """The flow IR of the configuration's network (input ``x``), named as
    the port's ``GraphBuilder`` names it (each output ``<opcode>_<n>``)."""
    inits, layers, flow = [], [], []
    count = 0

    def init(name, shape):
        inits.append([name, list(shape), "float32"])
        return name

    def op(lname, opcode, srcs, kwargs=None):
        nonlocal count
        count += 1
        dst = f"{opcode}_{count}"
        layers.append([lname, opcode, kwargs or {}])
        flow.append([srcs[0] if len(srcs) == 1 else list(srcs), [lname],
                     dst])
        return dst

    nodes, heads = ref.network(cfg)
    t = {"x": "x"}
    for n in nodes:
        src = [t[s] for s in n.src]
        if n.op == "conv":
            w = init(f"{n.name}.w", (n.cout, n.cin, n.k, n.k))
            kw = {"group": 1, "strides": [n.stride] * 2, "dilations": [1, 1],
                  "pads": [n.pad] * 4}
            if n.head:
                b = init(f"{n.name}.b", (n.cout,))
                t[n.name] = op(n.name, "conv", [src[0], w, b], kw)
                continue
            y = op(n.name, "conv", [src[0], w, "None"], kw)
            k = init(f"{n.name}.bn.k", (1, n.cout, 1, 1))
            b = init(f"{n.name}.bn.b", (1, n.cout, 1, 1))
            y = op(f"{n.name}.bn", "batchnorm", [y, k, b])
            t[n.name] = op(f"{n.name}.act", "leakyrelu", [y],
                           {"alpha": cfg["leaky"]})
        elif n.op == "add":
            t[n.name] = op(n.name, "add", src)
        elif n.op == "up":
            k = init(f"{n.src[0]}.k", (4,))
            t[n.name] = op(n.name, "upsample", [src[0], k],
                           {"mode": "nearest"})
        else:
            t[n.name] = op(n.name, "concat", src, {"axis": 1})
    layers.append(["return", "return", {}])
    flow.append([[t[h] for h in heads], ["return"], "plrst"])
    return {"input": ["x"], "inits": inits, "layers": layers, "flow": flow}


def arrays(cfg, seed: int, device) -> dict[str, np.ndarray]:
    """name -> float32 array of every init of ``graph_json(cfg)``, in its
    order: the weights from one standard-normal stream on ``device``, the
    upsample scales (1, 1, 2, 2)."""
    inits = graph_json(cfg)["inits"]
    # every init but the upsamples' scales ("route<s>.k")
    shapes = [(n, tuple(s)) for n, s, _ in inits
              if not n.endswith(".k") or n.endswith(".bn.k")]
    sizes = [math.prod(s) for _, s in shapes]
    z = torch.randn(sum(sizes), generator=seeded.generator(
        seed, "weights", device), device=device).cpu().numpy()
    out, at = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        v = z[at:at + n].reshape(shape)
        at += n
        if name.endswith(".bn.k"):
            v = 1.0 + 0.05 * v
        elif name.endswith(".b"):
            v = 0.05 * v
        else:
            v = v * np.float32(math.sqrt(2.0 / math.prod(shape[1:])))
        out[name] = np.ascontiguousarray(v, dtype=np.float32)
    scale = np.array([1, 1, 2, 2], np.float32)
    return {n: out[n] if n in out else scale for n, _, _ in inits}


def build(cfg, weights: dict, calib, device):
    """The port's static W8A8 program, built as a user builds it."""
    import planer_tpu_torch as pt
    g = graph_json(cfg)
    net = pt.net_from_arrays(g, [weights[n] for n, _, _ in g["inits"]],
                             device=device)
    net.optimize()
    pt.calibrate_act_scales(net, calib,
                            percentile=cfg["calibration"]["percentile"])
    net.quantize(cfg["quant"], activations=cfg["activations"],
                 fuse=None if cfg["fuse"] == "default" else cfg["fuse"])
    net.astype_compute(cfg["compute_dtype"])
    return net


def reference(cfg, weights: dict, calib, device, bits=8):
    """The plain reference, worked out again from the seeded arrays."""
    return ref.Int8Yolo(cfg, weights, calib, device, bits=bits)


def control(cfg, weights: dict, calib, device):
    """The control in the program's place: the reference with 4-bit weights
    and activation codes, whose ``forward`` the load calls as it calls the
    program's (the three heads of a batch on the card, each conv routed at
    the call's batch)."""
    return reference(cfg, weights, calib, device, bits=4)


def compare(cfg, reference, load, sample, batch: int):
    """({"max_rel_gap": the largest gap over images and the three heads},
    images compared) of the sampled answers ((key, heads) pairs) against
    ``reference`` run on the same inputs at the program's ``batch``, one
    pool batch at a time; ({}, 0) where there is nothing to compare."""
    by_key = {}
    for key, y in sample:
        by_key.setdefault(key, []).append(y)
    gap, n = None, 0
    for k in sorted(by_key):
        r = reference.forward(load.inputs(k), batch=batch)
        for y in by_key[k]:
            for got, want in zip(y, r, strict=True):
                g = cmp.max_rel_gap(got, want)
                gap = g if gap is None else max(gap, g)
            n += batch
    return ({} if gap is None else {"max_rel_gap": gap}), n


def work(cfg, batch: int) -> dict:
    """The work of one step, counted from the layer shapes: 2 operations per
    multiply-add of every conv, by the precision its route computes in at
    ``batch``.

    {"int8_ops", "bf16_ops"}, and "s8_gemm": (ops, least bytes) of the
    convs whose GEMM is an s8 one (routes "w8a8" and "s8"): their input
    codes read once, their weights once, their int32 accumulators written
    once."""
    convs = {n.name: n for n in ref.network(cfg)[0] if n.op == "conv"}
    int8 = bf16 = nbytes = 0
    for name, (route, h) in ref.routes(cfg, cfg["image_side"],
                                       batch).items():
        c = convs[name]
        o = ref.out_side(c, h)
        wsize = c.cout * c.cin * c.k * c.k
        ops = 2 * batch * o * o * wsize
        if route == "float":
            bf16 += ops
        else:
            int8 += ops
            nbytes += batch * h * h * c.cin + wsize + 4 * batch * o * o * c.cout
    return {"int8_ops": int8, "bf16_ops": bf16, "s8_gemm": (int8, nbytes)}
