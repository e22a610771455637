"""YOLO-v3 (Darknet-53 + FPN heads) built natively in the flow IR.

A copy of ``planer_tpu/models/yolov3.py``: the same graph and the same
seeded weights, so both packages build the same model.  The graph outputs
the three raw multi-scale head tensors (stride 32/16/8), or with
``decode=True`` one tensor of decoded boxes; :mod:`.yolo_post` decodes,
filters and suppresses boxes on the host (the data-dependent tail).  The
net lives on ``device``.
"""
from __future__ import annotations

import numpy as np

from .builder import GraphBuilder

__all__ = ["yolov3", "YOLO_ANCHORS"]

# canonical COCO anchors, grouped [large, medium, small] to match head order
YOLO_ANCHORS = {
    32: [(116, 90), (156, 198), (373, 326)],
    16: [(30, 61), (62, 45), (59, 119)],
    8: [(10, 13), (16, 30), (33, 23)],
}


def _decode_head(b: GraphBuilder, t: str, stride: int,
                 num_classes: int) -> str:
    """In-graph box decode for one head: (N, 3*(5+C), H, W) ->
    (N, 3*H*W, 5+C) with [cx, cy, w, h, obj, cls...] in pixels.

    All index/grid math is expressed as shape-chain IR ops (Shape/Range/
    Expand/...), which the program folds on the host as static records —
    only the sigmoid/exp/mul/add tensor math runs on the device.  The grid
    is a host value and is not cast to the compute dtype; the stride and the
    anchors are weights the device ops consume, so they are: in a bf16
    program ``xy`` comes out f32 and ``wh`` bf16, and the concat promotes.
    """
    na = 3
    C = num_classes
    nm = f"dec{stride}"
    # ---- static shape scalars
    shp = b.shape(t, name=f"{nm}.shape")
    i2 = b.weight(f"{nm}.i2", np.array(2, np.int64))
    i3 = b.weight(f"{nm}.i3", np.array(3, np.int64))
    h = b.gather(shp, i2, name=f"{nm}.h")          # scalar
    w = b.gather(shp, i3, name=f"{nm}.w")
    hu = b.unsqueeze(h, axes=[0], name=f"{nm}.hu")
    wu = b.unsqueeze(w, axes=[0], name=f"{nm}.wu")
    head_dims = b.weight(f"{nm}.hd", np.array([0, na, 5 + C], np.int64))
    tgt5 = b.concat(head_dims, hu, wu, axis=0, name=f"{nm}.tgt5")
    t5 = b.reshape(t, tgt5, name=f"{nm}.r5")       # (N,3,5+C,H,W)
    t5 = b.transpose(t5, axis=[0, 1, 3, 4, 2], name=f"{nm}.tr")  # (N,3,H,W,5+C)

    # ---- channel slices (static bounds)
    def _slice(name, lo, hi):
        st = b.weight(f"{nm}.{name}.st", np.array([lo], np.int64))
        en = b.weight(f"{nm}.{name}.en", np.array([hi], np.int64))
        ax = b.weight(f"{nm}.{name}.ax", np.array([4], np.int64))
        return b.slice(t5, st, en, ax, name=f"{nm}.{name}")

    txy = _slice("xy", 0, 2)
    twh = _slice("wh", 2, 4)
    trest = _slice("rest", 4, 5 + C)

    # ---- grid (static chain -> trace-time constant)
    z = b.weight(f"{nm}.z", np.array(0, np.int64))
    one = b.weight(f"{nm}.one", np.array(1, np.int64))
    rx = b.cast(b.range(z, w, one, name=f"{nm}.rx"), dtype="float32",
                name=f"{nm}.rxf")
    ry = b.cast(b.range(z, h, one, name=f"{nm}.ry"), dtype="float32",
                name=f"{nm}.ryf")
    hw = b.concat(hu, wu, axis=0, name=f"{nm}.hw")
    row = b.reshape(rx, b.weight(f"{nm}.rs", np.array([1, -1], np.int64)),
                    name=f"{nm}.row")
    col = b.reshape(ry, b.weight(f"{nm}.cs", np.array([-1, 1], np.int64)),
                    name=f"{nm}.col")
    gx = b.expand(row, hw, name=f"{nm}.gx")        # (H, W)
    gy = b.expand(col, hw, name=f"{nm}.gy")
    gxu = b.unsqueeze(gx, axes=[0, 1, 4], name=f"{nm}.gxu")  # (1,1,H,W,1)
    gyu = b.unsqueeze(gy, axes=[0, 1, 4], name=f"{nm}.gyu")
    grid = b.concat(gxu, gyu, axis=4, name=f"{nm}.grid")     # (1,1,H,W,2)

    stride_c = b.weight(f"{nm}.stride", np.array(float(stride), np.float32))
    anchors = b.weight(
        f"{nm}.anchors",
        np.asarray(YOLO_ANCHORS[stride], np.float32).reshape(1, na, 1, 1, 2))

    xy = b.sigmoid(txy, name=f"{nm}.sxy")
    xy = b.add(xy, grid, name=f"{nm}.xyg")
    xy = b.mul(xy, stride_c, name=f"{nm}.xys")
    # clip pre-exp so random-weight extremes stay finite (matches host decode)
    wh = b.clip(twh, min=-20.0, max=20.0, name=f"{nm}.whc")
    wh = b.exp(wh, name=f"{nm}.ewh")
    wh = b.mul(wh, anchors, name=f"{nm}.wha")
    rest = b.sigmoid(trest, name=f"{nm}.srest")
    dec = b.concat(xy, wh, rest, axis=4, name=f"{nm}.cat")
    flat = b.weight(f"{nm}.flat", np.array([0, -1, 5 + C], np.int64))
    return b.reshape(dec, flat, name=f"{nm}.out")  # (N, 3*H*W, 5+C)


def yolov3(num_classes: int = 80, seed: int = 0, decode: bool = False,
           device="cuda"):
    """Darknet-53 + FPN heads.  ``decode=True`` appends the in-graph box
    decode and returns a single (N, total_boxes, 5+C) tensor (pixels)."""
    rng = np.random.default_rng(seed)
    b = GraphBuilder(["x"])

    def conv_w(o, i, k):
        return (rng.standard_normal((o, i, k, k))
                * np.sqrt(2.0 / (i * k * k))).astype(np.float32)

    def cbl(x, cin, cout, k, stride, name):
        """conv + folded-BN + LeakyReLU(0.1) — the darknet building unit."""
        pad = k // 2
        W = b.weight(f"{name}.w", conv_w(cout, cin, k))
        y = b.conv(x, W, None, group=1, strides=[stride, stride],
                   dilations=[1, 1], pads=[pad, pad, pad, pad], name=name)
        K = b.weight(f"{name}.bn.k",
                     (1 + 0.05 * rng.standard_normal((1, cout, 1, 1))
                      ).astype(np.float32))
        Bb = b.weight(f"{name}.bn.b",
                      (0.05 * rng.standard_normal((1, cout, 1, 1))
                       ).astype(np.float32))
        y = b.batchnorm(y, K, Bb, name=f"{name}.bn")
        return b.leakyrelu(y, alpha=0.1, name=f"{name}.act")

    def residual(x, c, name):
        y = cbl(x, c, c // 2, 1, 1, f"{name}.1")
        y = cbl(y, c // 2, c, 3, 1, f"{name}.2")
        return b.add(y, x, name=f"{name}.add")

    # ---------------------------------------------------- darknet-53 backbone
    y = cbl("x", 3, 32, 3, 1, "d0")
    y = cbl(y, 32, 64, 3, 2, "d1")
    y = residual(y, 64, "r1.0")
    y = cbl(y, 64, 128, 3, 2, "d2")
    for i in range(2):
        y = residual(y, 128, f"r2.{i}")
    y = cbl(y, 128, 256, 3, 2, "d3")
    for i in range(8):
        y = residual(y, 256, f"r3.{i}")
    c3 = y                                      # stride 8, 256ch
    y = cbl(y, 256, 512, 3, 2, "d4")
    for i in range(8):
        y = residual(y, 512, f"r4.{i}")
    c4 = y                                      # stride 16, 512ch
    y = cbl(y, 512, 1024, 3, 2, "d5")
    for i in range(4):
        y = residual(y, 1024, f"r5.{i}")
    c5 = y                                      # stride 32, 1024ch

    out_ch = 3 * (5 + num_classes)

    def convset(x, cin, cmid, name):
        x = cbl(x, cin, cmid, 1, 1, f"{name}.0")
        x = cbl(x, cmid, cmid * 2, 3, 1, f"{name}.1")
        x = cbl(x, cmid * 2, cmid, 1, 1, f"{name}.2")
        x = cbl(x, cmid, cmid * 2, 3, 1, f"{name}.3")
        x = cbl(x, cmid * 2, cmid, 1, 1, f"{name}.4")
        return x

    def detect(x, cmid, name):
        y = cbl(x, cmid, cmid * 2, 3, 1, f"{name}.conv")
        W = b.weight(f"{name}.out.w", conv_w(out_ch, cmid * 2, 1))
        Bv = b.weight(f"{name}.out.b", np.zeros(out_ch, np.float32))
        return b.conv(y, W, Bv, group=1, strides=[1, 1], dilations=[1, 1],
                      pads=[0, 0, 0, 0], name=f"{name}.out")

    # ------------------------------------------------------------- FPN heads
    h5 = convset(c5, 1024, 512, "h5")
    out_l = detect(h5, 512, "det32")            # stride 32

    r4 = cbl(h5, 512, 256, 1, 1, "route4")
    k4 = b.weight("route4.k", np.array([1, 1, 2, 2], np.float32))
    r4 = b.upsample(r4, k4, mode="nearest", name="route4.up")
    h4 = b.concat(r4, c4, axis=1, name="route4.cat")
    h4 = convset(h4, 256 + 512, 256, "h4")
    out_m = detect(h4, 256, "det16")            # stride 16

    r3 = cbl(h4, 256, 128, 1, 1, "route3")
    k3 = b.weight("route3.k", np.array([1, 1, 2, 2], np.float32))
    r3 = b.upsample(r3, k3, mode="nearest", name="route3.up")
    h3 = b.concat(r3, c3, axis=1, name="route3.cat")
    h3 = convset(h3, 128 + 256, 128, "h3")
    out_s = detect(h3, 128, "det8")             # stride 8

    if decode:
        d32 = _decode_head(b, out_l, 32, num_classes)
        d16 = _decode_head(b, out_m, 16, num_classes)
        d8 = _decode_head(b, out_s, 8, num_classes)
        dec = b.concat(d32, d16, d8, axis=1, name="decode.cat")
        b.ret(dec)
    else:
        b.ret([out_l, out_m, out_s])
    return b.build_net(device)
