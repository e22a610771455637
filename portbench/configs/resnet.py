"""The ResNet family (``"family": "resnet"``): everything of a
torchvision-layout ResNet configuration that the harness reaches by name.

The system under test: the flow-IR graph and the seeded float arrays, and
the pipeline a user runs to make its INT8 program on the card.  The
yardstick: the seeded images, the step's work counted from the layer
shapes, the plain reference (``resnet_ref``), its comparison with the
answers and the control put in the program's place.

``graph_json`` writes the graph as the port's ``GraphBuilder`` would
(conv -> batchnorm (affine K, B) -> relu, maxpool 3x3/2, basic or
bottleneck blocks with the projection after the main chain, global average
pool, flatten, dense); ``arrays`` draws its weights from the run seed on
the device (He-normal convs, BatchNorm K ~ 1 + 0.1 N, B ~ 0.1 N, dense
N / sqrt(C_in)); ``build`` hands both to the port and runs ``optimize``,
``calibrate_act_scales``, ``quantize`` and ``astype_compute``.

The harness calls ``arrays``, ``calibration``, ``build``, ``inputs``,
``reference``, ``control``, ``compare`` and ``work``; a new family is a new
module beside this one with the same functions.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import compare as cmp
from .. import inputs as seeded
from . import resnet_ref as ref


def graph_json(cfg) -> dict:
    """The flow IR of the configuration's network (input ``x``)."""
    inits, layers, flow = [], [], []

    def init(name, shape):
        inits.append([name, list(shape), "float32"])
        return name

    def op(lname, opcode, srcs, kwargs=None):
        layers.append([lname, opcode, kwargs or {}])
        dst = f"{lname}:y"
        flow.append([srcs[0] if len(srcs) == 1 else list(srcs), [lname],
                     dst])
        return dst

    def conv_bn(x, c: ref.Conv, relu):
        w = init(f"{c.name}.w", (c.cout, c.cin, c.k, c.k))
        y = op(c.name, "conv", [x, w, "None"],
               {"group": 1, "strides": [c.stride] * 2, "dilations": [1, 1],
                "pads": [c.pad] * 4})
        k = init(f"{c.name}.bn.k", (1, c.cout, 1, 1))
        b = init(f"{c.name}.bn.b", (1, c.cout, 1, 1))
        y = op(f"{c.name}.bn", "batchnorm", [y, k, b])
        return op(f"{c.name}.relu", "relu", [y]) if relu else y

    y = conv_bn("x", ref.STEM, True)
    y = op("stem.pool", "maxpool", [y], {"w": [3, 3], "pads": [1, 1, 1, 1],
                                         "strides": [2, 2]})
    cin = 64
    for b in ref.blocks_of(cfg):
        t = y
        for i, c in enumerate(b.convs):
            t = conv_bn(t, c, i < len(b.convs) - 1)
        res = conv_bn(y, b.down, False) if b.down else y
        y = op(f"{b.name}.out", "relu", [op(f"{b.name}.add", "add",
                                            [t, res])])
        cin = b.cout
    y = op("flatten", "flatten", [op("gap", "gap", [y])])
    w = init("fc.w", (cfg["num_classes"], cin))
    bias = init("fc.b", (cfg["num_classes"],))
    y = op("fc", "dense", [y, w, bias])
    layers.append(["return", "return", {}])
    flow.append([y, ["return"], "plrst"])
    return {"input": ["x"], "inits": inits, "layers": layers, "flow": flow}


def arrays(cfg, seed: int, device) -> dict[str, np.ndarray]:
    """name -> float32 array of every init of ``graph_json(cfg)``, in its
    order, drawn from one standard-normal stream on ``device``."""
    shapes = [(n, tuple(s)) for n, s, _ in graph_json(cfg)["inits"]]
    sizes = [math.prod(s) for _, s in shapes]
    z = torch.randn(sum(sizes), generator=seeded.generator(
        seed, "weights", device), device=device).cpu().numpy()
    out, at = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        v = z[at:at + n].reshape(shape)
        at += n
        if name.endswith(".bn.k"):
            v = 1.0 + 0.1 * v
        elif name.endswith(".bn.b") or name == "fc.b":
            v = 0.1 * v
        elif name == "fc.w":
            v = v * np.float32(math.sqrt(1.0 / shape[1]))
        else:
            v = v * np.float32(math.sqrt(2.0 / math.prod(shape[1:])))
        out[name] = np.ascontiguousarray(v, dtype=np.float32)
    return out


def calibration(cfg, seed: int, device) -> list[torch.Tensor]:
    """The calibration batches: ``images`` seeded images at the input side,
    in batches of ``batch``."""
    c = cfg["calibration"]
    x = seeded.images(c["images"], cfg["image_side"],
                      seeded.generator(seed, "calibration", device))
    return list(torch.split(x, c["batch"]))


def build(cfg, weights: dict, calib, device):
    """The port's INT8 program, built as a user builds it."""
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


def inputs(cfg, n: int, seed: int, device) -> torch.Tensor:
    """``n`` seeded float32 images at the input side, on ``device``."""
    return seeded.images(n, cfg["image_side"],
                         seeded.generator(seed, "traffic", device))


def reference(cfg, weights: dict, calib, device, bits=8):
    """The plain reference, worked out again from the seeded arrays."""
    return ref.Int8ResNet(cfg, weights, calib, device, bits=bits)


def control(cfg, weights: dict, calib, device):
    """The control in the program's place: the reference with 4-bit
    weights and activation codes, called as the program is (arrays or
    tensors in, numpy logits out, each conv routed at the call's batch)."""
    low = reference(cfg, weights, calib, device, bits=4)

    def call(x):
        x = torch.as_tensor(x).to(low.dev)
        return low.forward(x, batch=x.shape[0]).cpu().numpy()
    return call


def compare(cfg, reference, load, sample, batch: int):
    """({"max_rel_gap": the largest gap}, images compared) of the sampled
    answers ((key, logits) pairs) against ``reference`` run on the same
    inputs at the program's ``batch``, in blocks of at most 64 images;
    ({}, 0) where there is nothing to compare."""
    by_key = {}
    for key, y in sample:
        by_key.setdefault(key, []).append(y)
    gap, n = None, 0
    keys = sorted(by_key)
    per_block = max(1, 64 // batch)
    for at in range(0, len(keys), per_block):
        part = keys[at:at + per_block]
        r = reference.forward(torch.cat([load.inputs(k) for k in part]),
                              batch=batch)
        for j, k in enumerate(part):
            for y in by_key[k]:
                g = cmp.max_rel_gap(y, r[j * batch:(j + 1) * batch])
                gap = g if gap is None else max(gap, g)
                n += batch
    return ({} if gap is None else {"max_rel_gap": gap}), n


def _macs(c: ref.Conv, h: int) -> int:
    o = (h + 2 * c.pad - c.k) // c.stride + 1
    return o * o * c.cout * c.cin * c.k * c.k


def work(cfg, batch: int) -> dict:
    """The work of one step, counted from the layer shapes (never from a
    kernel's padding or tiles): 2 operations per multiply-add of every conv
    and of the classifier, and for each fused stage the bytes it must move
    at least (its input codes read once, its weights and per-channel tables
    read once, its output written once).

    {"int8_ops", "bf16_ops"}: the step's operations by the precision the
    configuration computes them in, and {"stage64", "stagen"}: (ops, bytes)
    of the work those fused stages cover, or None where none runs."""
    side = cfg["image_side"]
    convs = {c.name: c for c in ref.all_convs(cfg)}
    int8 = bf16 = 0
    stage = {"stage64": [0, 0], "stagen": [0, 0]}
    for name, (route, h) in ref.routes(cfg, side, batch).items():
        ops = 2 * batch * _macs(convs[name], h)
        if route == "float":
            bf16 += ops
        else:
            int8 += ops
        if route in stage:
            c = convs[name]
            stage[route][0] += ops
            stage[route][1] += c.cout * c.cin * c.k * c.k + 8 * c.cout
    bf16 += 2 * batch * cfg["num_classes"] * ref.blocks_of(cfg)[-1].cout
    s64, stages, _ = ref.plan(cfg, side)
    r = side // 4
    # the entry stage reads the image's int8 codes and writes its last plane
    # in bfloat16; a fused body stage reads int8 codes and writes bfloat16
    stage["stage64"][1] += batch * (3 * side * side + 64 * r * r * 2)
    h = r
    for blks, fused in stages:
        out = h // blks[0].stride
        if fused:
            stage["stagen"][1] += batch * (blks[0].cin * h * h
                                           + blks[-1].cout * out * out * 2)
        h = out
    return {"int8_ops": int8, "bf16_ops": bf16,
            "stage64": tuple(stage["stage64"]),
            "stagen": tuple(stage["stagen"]) if stage["stagen"][0] else None}
