"""UNet segmentation model built natively in the flow IR.

A copy of ``planer_tpu/models/unet.py``: the same graph and the same seeded
weights, so both packages build the same model.  Classic 4-level
encoder/decoder with skip connections: conv-conv blocks, maxpool
downsampling, ConvTranspose (or nearest upsample + 1x1 conv) upsampling,
channel concat, final 1x1 conv + sigmoid.  Large images run tiled
(``utils.tile``).  The net lives on ``device``.
"""
from __future__ import annotations

import numpy as np

from .builder import GraphBuilder

__all__ = ["unet"]


def unet(in_ch: int = 1, out_ch: int = 1, base: int = 32, depth: int = 4,
         seed: int = 0, upsample_mode: str = "convtranspose", device="cuda"):
    rng = np.random.default_rng(seed)

    def conv_w(o, i, k):
        return (rng.standard_normal((o, i, k, k))
                * np.sqrt(2.0 / (i * k * k))).astype(np.float32)

    b = GraphBuilder(["x"])

    def block(x, cin, cout, name):
        for j in (1, 2):
            W = b.weight(f"{name}.c{j}.w", conv_w(cout, cin, 3))
            Bv = b.weight(f"{name}.c{j}.b",
                          (0.01 * rng.standard_normal(cout)).astype(np.float32))
            x = b.conv(x, W, Bv, group=1, strides=[1, 1], dilations=[1, 1],
                       pads=[1, 1, 1, 1], name=f"{name}.c{j}")
            x = b.relu(x, name=f"{name}.c{j}.relu")
            cin = cout
        return x

    # encoder
    skips = []
    x, cin = "x", in_ch
    for d in range(depth):
        cout = base * (2 ** d)
        x = block(x, cin, cout, f"enc{d}")
        skips.append((x, cout))
        x = b.maxpool(x, w=[2, 2], pads=[0, 0, 0, 0], strides=[2, 2],
                      name=f"down{d}")
        cin = cout

    # bottleneck
    cmid = base * (2 ** depth)
    x = block(x, cin, cmid, "mid")
    cin = cmid

    # decoder
    for d in reversed(range(depth)):
        cout = base * (2 ** d)
        if upsample_mode == "convtranspose":
            # ConvTranspose kernel layout (C_in, C_out, kh, kw)
            W = b.weight(f"up{d}.w", (rng.standard_normal((cin, cout, 2, 2))
                                      * np.sqrt(2.0 / cin)).astype(np.float32))
            x = b.convtranspose(x, W, None, strides=[2, 2], dilations=[1, 1],
                                pads=[0, 0, 0, 0], output_padding=[0, 0],
                                group=1, name=f"up{d}")
        else:
            k = b.weight(f"up{d}.k", np.array([1, 1, 2, 2], np.float32))
            x = b.upsample(x, k, mode="nearest", name=f"up{d}")
            W = b.weight(f"up{d}.w", conv_w(cout, cin, 1))
            x = b.conv(x, W, None, group=1, strides=[1, 1], dilations=[1, 1],
                       pads=[0, 0, 0, 0], name=f"up{d}.proj")
        skip, sc = skips[d]
        x = b.concat(x, skip, axis=1, name=f"cat{d}")
        x = block(x, cout + sc, cout, f"dec{d}")
        cin = cout

    W = b.weight("head.w", conv_w(out_ch, cin, 1))
    Bv = b.weight("head.b", np.zeros(out_ch, np.float32))
    x = b.conv(x, W, Bv, group=1, strides=[1, 1], dilations=[1, 1],
               pads=[0, 0, 0, 0], name="head")
    x = b.sigmoid(x, name="head.sig")
    b.ret(x)
    return b.build_net(device)
