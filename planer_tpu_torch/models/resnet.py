"""ResNet-18 / ResNet-50 built natively in the flow IR.

A copy of ``planer_tpu/models/resnet.py``: the same graph and the same
seeded He-initialized weights, so both packages build the same model.  Conv
weights in OIHW, BatchNorm as per-channel affine (K, B) pairs, maxpool 3x3/2
with pads, dense head with transposed weight.  The net lives on ``device``.
"""
from __future__ import annotations

import numpy as np

from .builder import GraphBuilder

__all__ = ["resnet18", "resnet50"]


class _Init:
    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def conv(self, o, i, kh, kw):
        fan_in = i * kh * kw
        return (self.rng.standard_normal((o, i, kh, kw))
                * np.sqrt(2.0 / fan_in)).astype(np.float32)

    def dense(self, o, i):
        return (self.rng.standard_normal((o, i))
                * np.sqrt(1.0 / i)).astype(np.float32)

    def bn(self, c):
        # folded-BN affine: K ~ 1, B ~ 0 (converter-style (1,C,1,1) layout)
        k = (1.0 + 0.1 * self.rng.standard_normal((1, c, 1, 1))).astype(np.float32)
        b = (0.1 * self.rng.standard_normal((1, c, 1, 1))).astype(np.float32)
        return k, b

    def vec(self, c):
        return (0.1 * self.rng.standard_normal(c)).astype(np.float32)


def _conv_bn_relu(b: GraphBuilder, ini: _Init, x, cin, cout, k, stride,
                  name, relu=True):
    pad = k // 2
    W = b.weight(f"{name}.w", ini.conv(cout, cin, k, k))
    y = b.conv(x, W, None, group=1, strides=[stride, stride],
               dilations=[1, 1], pads=[pad, pad, pad, pad], name=name)
    K, B = ini.bn(cout)
    y = b.batchnorm(y, b.weight(f"{name}.bn.k", K),
                    b.weight(f"{name}.bn.b", B), name=f"{name}.bn")
    if relu:
        y = b.relu(y, name=f"{name}.relu")
    return y


def _basic_block(b, ini, x, cin, cout, stride, name):
    y = _conv_bn_relu(b, ini, x, cin, cout, 3, stride, f"{name}.conv1")
    y = _conv_bn_relu(b, ini, y, cout, cout, 3, 1, f"{name}.conv2", relu=False)
    if stride != 1 or cin != cout:
        x = _conv_bn_relu(b, ini, x, cin, cout, 1, stride, f"{name}.down",
                          relu=False)
    y = b.add(y, x, name=f"{name}.add")
    return b.relu(y, name=f"{name}.out")


def _bottleneck(b, ini, x, cin, cmid, stride, name):
    cout = cmid * 4
    y = _conv_bn_relu(b, ini, x, cin, cmid, 1, 1, f"{name}.conv1")
    y = _conv_bn_relu(b, ini, y, cmid, cmid, 3, stride, f"{name}.conv2")
    y = _conv_bn_relu(b, ini, y, cmid, cout, 1, 1, f"{name}.conv3", relu=False)
    if stride != 1 or cin != cout:
        x = _conv_bn_relu(b, ini, x, cin, cout, 1, stride, f"{name}.down",
                          relu=False)
    y = b.add(y, x, name=f"{name}.add")
    return b.relu(y, name=f"{name}.out")


def _resnet(blocks, block_fn, widths, num_classes, seed, device):
    ini = _Init(seed)
    b = GraphBuilder(["x"])
    y = _conv_bn_relu(b, ini, "x", 3, 64, 7, 2, "stem")
    y = b.maxpool(y, w=[3, 3], pads=[1, 1, 1, 1], strides=[2, 2], name="stem.pool")
    cin = 64
    for si, (n, cw) in enumerate(zip(blocks, widths)):
        for bi in range(n):
            stride = 2 if (si > 0 and bi == 0) else 1
            y = block_fn(b, ini, y, cin, cw, stride, f"layer{si+1}.{bi}")
            cin = cw * (4 if block_fn is _bottleneck else 1)
    y = b.gap(y, name="gap")
    y = b.flatten(y, name="flatten")
    W = b.weight("fc.w", ini.dense(num_classes, cin))
    Bv = b.weight("fc.b", ini.vec(num_classes))
    y = b.dense(y, W, Bv, name="fc")
    b.ret(y)
    return b.build_net(device)


def resnet18(num_classes: int = 1000, seed: int = 0, device="cuda"):
    return _resnet([2, 2, 2, 2], _basic_block, [64, 128, 256, 512],
                   num_classes, seed, device)


def resnet50(num_classes: int = 1000, seed: int = 0, device="cuda"):
    return _resnet([3, 4, 6, 3], _bottleneck, [64, 128, 256, 512],
                   num_classes, seed, device)
