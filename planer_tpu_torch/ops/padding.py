"""Shared pad-resolution math for conv/pool ops (a copy of
``planer_tpu/ops/padding.py``, which the port may not import).

ONNX ``auto_pad`` (SAME_UPPER/SAME_LOWER/VALID) and pool ``ceil_mode`` are
input-shape-dependent, so a converter cannot emit static pads for them.  The
IR keeps the attributes as kwargs and both the float32 executor and the
program resolve them with this one module at apply time.
"""
from __future__ import annotations

import math

__all__ = ["resolve_conv_pads", "resolve_pool_pads"]


def _same_axis(in_size: int, k: int, s: int, d: int) -> int:
    """Total SAME padding for one spatial axis (out = ceil(in / stride))."""
    eff_k = (k - 1) * d + 1
    out = -(-in_size // s)
    return max((out - 1) * s + eff_k - in_size, 0)


def resolve_conv_pads(in_hw, kernel_hw, strides, dilations, pads, auto_pad):
    """Return explicit (pt, pl, pb, pr) honoring ONNX auto_pad semantics."""
    if not auto_pad or auto_pad == "NOTSET":
        return tuple(int(p) for p in (pads or (0, 0, 0, 0)))
    if auto_pad == "VALID":
        return (0, 0, 0, 0)
    sh, sw = (int(s) for s in (strides or (1, 1)))
    dh, dw = (int(v) for v in (dilations or (1, 1)))
    th = _same_axis(int(in_hw[0]), int(kernel_hw[0]), sh, dh)
    tw = _same_axis(int(in_hw[1]), int(kernel_hw[1]), sw, dw)
    if auto_pad == "SAME_UPPER":       # extra pad goes at the end
        return (th // 2, tw // 2, th - th // 2, tw - tw // 2)
    if auto_pad == "SAME_LOWER":       # extra pad goes at the start
        return (th - th // 2, tw - tw // 2, th // 2, tw // 2)
    raise ValueError(f"unknown auto_pad {auto_pad!r}")


def resolve_pool_pads(in_hw, kernel_hw, strides, pads, auto_pad, ceil_mode):
    """Resolve pool padding: explicit pads + ceil_mode extension.

    Returns ((pt, pl, pb, pr), (eh, ew)) where (eh, ew) is the extra
    bottom/right "virtual" padding ceil_mode adds.  Virtual padding must not
    participate in an AveragePool divisor even when count_include_pad=1
    (onnxruntime semantics), hence it is reported separately.
    """
    pt, pl, pb, pr = resolve_conv_pads(in_hw, kernel_hw, strides, (1, 1),
                                       pads, auto_pad)
    if not ceil_mode:
        return (pt, pl, pb, pr), (0, 0)
    sh, sw = (int(s) for s in (strides or (2, 2)))
    kh, kw = (int(k) for k in kernel_hw)
    h, w = int(in_hw[0]), int(in_hw[1])

    def extra(in_size, k, s, p0, p1):
        span = in_size + p0 + p1 - k
        out = math.ceil(span / s) + 1
        # ONNX: the last window must start inside the input or explicit pads
        if (out - 1) * s >= in_size + p0:
            out -= 1
        return max((out - 1) * s + k - (in_size + p0 + p1), 0)

    return (pt, pl, pb, pr), (extra(h, kh, sh, pt, pb),
                              extra(w, kw, sw, pl, pr))
