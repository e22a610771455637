"""ONNX Resize/Upsample index planning — a copy of ``planer_tpu/ops/resize.py``
(numpy only), so both packages plan the same indices.

The ONNX ``coordinate_transformation_mode`` / ``nearest_mode`` maze directly
moves YOLO mAP (reference approximates it in util.py:155-219 via stamp+shift;
we implement the spec exactly).  All index math is done here ONCE, in float64
numpy, on the host — the float32 executor and the program both consume the
same plan, so the two agree bit for bit.

A plan is per-axis:
  * nearest: ``idx``   — int32 source index per output position
  * linear : ``lo, hi, frac`` — gather indices + lerp weight per output position
"""
from __future__ import annotations

import numpy as np

__all__ = ["nearest_plan", "linear_plan", "resize_shape"]


def _original_coord(out_idx: np.ndarray, scale: float, in_size: int,
                    out_size: int, mode: str) -> np.ndarray:
    """Map output index -> continuous input coordinate (ONNX spec)."""
    x = out_idx.astype(np.float64)
    if mode == "half_pixel":
        return (x + 0.5) / scale - 0.5
    if mode == "pytorch_half_pixel":
        if out_size > 1:
            return (x + 0.5) / scale - 0.5
        return np.zeros_like(x)
    if mode == "align_corners":
        if out_size == 1:
            return np.zeros_like(x)
        return x * (in_size - 1) / (out_size - 1)
    if mode == "asymmetric":
        return x / scale
    if mode == "tf_half_pixel_for_nn":
        return (x + 0.5) / scale
    raise ValueError(f"unknown coordinate_transformation_mode {mode!r}")


def _round_nearest(x: np.ndarray, mode: str) -> np.ndarray:
    if mode == "round_prefer_floor":
        return np.ceil(x - 0.5)
    if mode == "round_prefer_ceil":
        return np.floor(x + 0.5)
    if mode == "floor":
        return np.floor(x)
    if mode == "ceil":
        return np.ceil(x)
    raise ValueError(f"unknown nearest_mode {mode!r}")


def nearest_plan(in_size: int, out_size: int, scale: float,
                 coord_mode: str = "half_pixel",
                 nearest_mode: str = "round_prefer_floor") -> np.ndarray:
    """int32 gather index per output position for nearest resize."""
    x = _original_coord(np.arange(out_size), scale, in_size, out_size, coord_mode)
    idx = _round_nearest(x, nearest_mode)
    return np.clip(idx, 0, in_size - 1).astype(np.int32)


def linear_plan(in_size: int, out_size: int, scale: float,
                coord_mode: str = "half_pixel"):
    """(lo, hi, frac): bilinear gather indices + weights per output position."""
    x = _original_coord(np.arange(out_size), scale, in_size, out_size, coord_mode)
    x = np.clip(x, 0.0, in_size - 1.0)
    lo = np.floor(x)
    frac = (x - lo).astype(np.float32)
    lo = lo.astype(np.int32)
    hi = np.minimum(lo + 1, in_size - 1).astype(np.int32)
    return lo, hi, frac


def resize_shape(in_hw, scales=None, sizes=None):
    """Resolve output (H, W) and effective scales from ONNX scales-or-sizes."""
    h, w = int(in_hw[0]), int(in_hw[1])
    if sizes is not None and (scales is None or np.size(scales) == 0):
        oh, ow = int(sizes[0]), int(sizes[1])
        return (oh, ow), (oh / h, ow / w)
    kh, kw = float(scales[0]), float(scales[1])
    # ONNX: output_size = floor(input_size * scale)
    return (int(np.floor(h * kh)), int(np.floor(w * kw))), (kh, kw)
