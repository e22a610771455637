"""ConvNeXt (Liu et al., "A ConvNet for the 2020s", arXiv:2201.03545) built
natively in the flow IR, in torchvision's ``convnext_*`` layout.

  * stem: ``Conv2d(3, w0, k=4, s=4, bias)``, then a channel LayerNorm;
  * each later stage: a channel LayerNorm and ``Conv2d(C, 2C, k=2, s=2,
    bias)``;
  * each block over C channels: ``dwconv7x7`` (groups = C, pad 3, bias),
    to NHWC, ``LayerNorm(C)``, ``Linear(C, 4C)``, exact (erf) GELU,
    ``Linear(4C, C)``, the layer scale ``gamma`` (per channel), back to NCHW,
    and the residual add (stochastic depth is the identity at inference);
  * head: global average pool, a channel LayerNorm, flatten,
    ``Linear(C, num_classes)``.

A channel LayerNorm is ``transpose`` -> ``layernorm`` -> ``transpose``, as
torchvision's ``LayerNorm2d``; every LayerNorm has eps 1e-6.  Weights are
random from ``seed`` (He-normal convs and Linears, LayerNorm scale
``1 + 0.05 N`` and bias ``0.05 N``, conv and Linear biases ``0.05 N``,
``gamma`` ``0.5 + 0.1 N`` so that no block vanishes, the classifier
``N / sqrt(C)``), or the caller's (``weights``: name -> array, by the names
``weight_shapes`` lists).  The net lives on ``device``.
"""
from __future__ import annotations

import numpy as np

from .builder import GraphBuilder

__all__ = ["convnext", "convnext_base", "weight_shapes"]

EPS = 1e-6
NCHW_TO_NHWC = [0, 2, 3, 1]
NHWC_TO_NCHW = [0, 3, 1, 2]


def weight_shapes(depths=(3, 3, 27, 3), widths=(128, 256, 512, 1024),
                  num_classes: int = 1000) -> list[tuple[str, tuple]]:
    """(name, shape) of every weight of the net, in the graph's order."""
    out = []

    def ln(p, c):
        out.extend([(f"{p}.s", (c,)), (f"{p}.b", (c,))])

    out += [("stem.w", (widths[0], 3, 4, 4)), ("stem.b", (widths[0],))]
    ln("stem.ln", widths[0])
    for i, (d, c) in enumerate(zip(depths, widths)):
        if i:
            ln(f"down{i}.ln", widths[i - 1])
            out += [(f"down{i}.w", (c, widths[i - 1], 2, 2)),
                    (f"down{i}.b", (c,))]
        for j in range(d):
            p = f"s{i}.{j}"
            out += [(f"{p}.dw.w", (c, 1, 7, 7)), (f"{p}.dw.b", (c,))]
            ln(f"{p}.ln", c)
            out += [(f"{p}.fc1.w", (4 * c, c)), (f"{p}.fc1.b", (4 * c,)),
                    (f"{p}.fc2.w", (c, 4 * c)), (f"{p}.fc2.b", (c,)),
                    (f"{p}.gamma", (c,))]
    ln("head.ln", widths[-1])
    out += [("fc.w", (num_classes, widths[-1])), ("fc.b", (num_classes,))]
    return out


def _draw(name, shape, rng):
    z = rng.standard_normal(shape)
    if name.endswith(".gamma"):
        v = 0.5 + 0.1 * z
    elif name.endswith(".s"):
        v = 1.0 + 0.05 * z
    elif name.endswith(".b"):
        v = 0.05 * z
    elif name == "fc.w":
        v = z * np.sqrt(1.0 / shape[1])
    else:
        v = z * np.sqrt(2.0 / np.prod(shape[1:]))
    return v.astype(np.float32)


def convnext(depths=(3, 3, 27, 3), widths=(128, 256, 512, 1024),
             num_classes: int = 1000, seed: int = 0, device="cuda",
             weights: dict | None = None):
    """A ConvNeXt of the given stage depths and widths; ``weights`` (name ->
    float32 array) in place of the seeded ones."""
    rng = np.random.default_rng(seed)
    b = GraphBuilder(["x"])
    shapes = dict(weight_shapes(depths, widths, num_classes))

    def w(name):
        a = (_draw(name, shapes[name], rng) if weights is None
             else np.asarray(weights[name], np.float32))
        if a.shape != shapes[name]:
            raise ValueError(f"weight {name!r}: shape {a.shape}, the net "
                             f"takes {shapes[name]}")
        return b.weight(name, a)

    def conv(x, p, stride, pad, group=1):
        return b.conv(x, w(f"{p}.w"), w(f"{p}.b"), group=group,
                      strides=[stride, stride], dilations=[1, 1],
                      pads=[pad] * 4, name=p)

    def layernorm(x, p):
        return b.layernorm(x, w(f"{p}.s"), w(f"{p}.b"), axis=-1,
                           epsilon=EPS, name=p)

    def channel_ln(x, p):
        y = b.transpose(x, axis=NCHW_TO_NHWC, name=f"{p}.nhwc")
        return b.transpose(layernorm(y, p), axis=NHWC_TO_NCHW,
                           name=f"{p}.nchw")

    y = channel_ln(conv("x", "stem", 4, 0), "stem.ln")
    for i, d in enumerate(depths):
        if i:
            y = conv(channel_ln(y, f"down{i}.ln"), f"down{i}", 2, 0)
        for j in range(d):
            p = f"s{i}.{j}"
            t = conv(y, f"{p}.dw", 1, 3, group=widths[i])
            t = layernorm(b.transpose(t, axis=NCHW_TO_NHWC, name=f"{p}.nhwc"),
                          f"{p}.ln")
            t = b.dense(t, w(f"{p}.fc1.w"), w(f"{p}.fc1.b"), name=f"{p}.fc1")
            t = b.gelu(t, name=f"{p}.gelu")
            t = b.dense(t, w(f"{p}.fc2.w"), w(f"{p}.fc2.b"), name=f"{p}.fc2")
            t = b.mul(t, w(f"{p}.gamma"), name=f"{p}.scale")
            t = b.transpose(t, axis=NHWC_TO_NCHW, name=f"{p}.nchw")
            y = b.add(y, t, name=f"{p}.add")
    y = channel_ln(b.gap(y, name="gap"), "head.ln")
    y = b.flatten(y, name="flatten")
    y = b.dense(y, w("fc.w"), w("fc.b"), name="fc")
    b.ret(y)
    return b.build_net(device)


def convnext_base(num_classes: int = 1000, seed: int = 0, device="cuda",
                  weights: dict | None = None):
    """ConvNeXt-Base: depths (3, 3, 27, 3), widths (128, 256, 512, 1024),
    88.6 M parameters at 1000 classes, 15.4 GMAC an image at 224."""
    return convnext((3, 3, 27, 3), (128, 256, 512, 1024), num_classes, seed,
                    device, weights)
