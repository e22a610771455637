"""The ConvNeXt family (``"family": "convnext"``): everything of a ConvNeXt
configuration (torchvision's ``convnext_*`` layout) that the harness
reaches by name.

The system under test: the port's zoo ConvNeXt (``models.convnext``) on the
seeded float arrays, and the pipeline a user runs to make its int8 program
(``optimize``, ``calibrate_act_scales``, ``quantize``, ``astype_compute``).
The yardstick: the seeded images, the step's work counted from the layer
shapes, the plain reference (``convnext_ref``), its comparison with the
answers and the control put in the program's place.

``arrays`` draws the weights from the run seed on the device: He-normal
convs and Linears (N * sqrt(2 / fan_in)), the classifier N / sqrt(C),
LayerNorm scales 1 + 0.05 N, every bias 0.05 N, the layer scales
0.5 + 0.1 N.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .. import inputs as seeded
from . import convnext_ref as ref
from . import resnet

# the calibration batches, the traffic's images, the comparison of logits
# and the control are ResNet's
calibration = resnet.calibration
inputs = resnet.inputs
compare = resnet.compare


def arrays(cfg, seed: int, device) -> dict[str, np.ndarray]:
    """name -> float32 array of every weight (``convnext_ref.weight_shapes``
    order), from one standard-normal stream on ``device``."""
    shapes = ref.weight_shapes(cfg)
    sizes = [math.prod(s) for _, s in shapes]
    z = torch.randn(sum(sizes), generator=seeded.generator(
        seed, "weights", device), device=device).cpu().numpy()
    out, at = {}, 0
    for (name, shape), n in zip(shapes, sizes):
        v = z[at:at + n].reshape(shape)
        at += n
        if name.endswith(".gamma"):
            v = 0.5 + 0.1 * v
        elif name.endswith(".s"):
            v = 1.0 + 0.05 * v
        elif name.endswith(".b"):
            v = 0.05 * v
        elif name == "fc.w":
            v = v * np.float32(math.sqrt(1.0 / shape[1]))
        else:
            v = v * np.float32(math.sqrt(2.0 / math.prod(shape[1:])))
        out[name] = np.ascontiguousarray(v, dtype=np.float32)
    return out


def build(cfg, weights: dict, calib, device):
    """The port's int8 program, built as a user builds it: the zoo's
    ConvNeXt on the seeded weights."""
    import planer_tpu_torch as pt
    from planer_tpu_torch.models import convnext
    net = convnext(cfg["depths"], cfg["widths"], cfg["num_classes"],
                   device=device, weights=weights)
    net.optimize()
    pt.calibrate_act_scales(net, calib,
                            percentile=cfg["calibration"]["percentile"])
    net.quantize(cfg["quant"], activations=cfg["activations"],
                 fuse=None if cfg["fuse"] == "default" else cfg["fuse"])
    net.astype_compute(cfg["compute_dtype"])
    return net


def reference(cfg, weights: dict, calib, device, bits=8):
    """The plain reference, worked out again from the seeded arrays."""
    return ref.Int8ConvNeXt(cfg, weights, calib, device, bits=bits)


def control(cfg, weights: dict, calib, device):
    """The control in the program's place: the reference with 4-bit
    weights and activation codes, called as the program is (arrays or
    tensors in, numpy logits out, each conv and Linear routed at the call's
    batch)."""
    low = reference(cfg, weights, calib, device, bits=4)

    def call(x):
        x = torch.as_tensor(x).to(low.dev)
        return low.forward(x, batch=x.shape[0]).cpu().numpy()
    return call


def work(cfg, batch: int) -> dict:
    """The work of one step, counted from the layer shapes: 2 operations
    per multiply-add of every conv and Linear, by the precision its route
    computes in at ``batch`` (the W8A8 convs in int8; the float convs and
    every Linear in bfloat16, ``dense_q`` on decoded int8 weights).

    {"int8_ops", "bf16_ops"}, and "dense_q": (ops, least bytes) of the
    Linears on ``dense_q``'s kernel branch: x read once in bfloat16, the
    int8 weights, float32 scales and bfloat16 bias once, the bfloat16
    output written once."""
    convs = {c.name: c for c in ref.convs(cfg)}
    lin = {n: (o, k) for n, o, k in ref.linears(cfg)}
    int8 = bf16 = q_ops = q_bytes = 0
    for name, (route, h) in ref.routes(cfg, cfg["image_side"],
                                       batch).items():
        if name in convs:
            c = convs[name]
            o = (h + 2 * c.pad - c.k) // c.stride + 1
            ops = 2 * batch * o * o * c.cout * c.cin // c.group * c.k * c.k
            if route == "w8a8":
                int8 += ops
            else:
                bf16 += ops
            continue
        n, kd = lin[name]
        m = batch * h * h
        bf16 += 2 * m * n * kd
        if route == "kernel":
            q_ops += 2 * m * n * kd
            q_bytes += 2 * m * kd + n * kd + 4 * n + 2 * n + 2 * m * n
    return {"int8_ops": int8, "bf16_ops": bf16, "dense_q": (q_ops, q_bytes)}
