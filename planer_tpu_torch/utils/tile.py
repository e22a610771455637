"""Tiled big-image inference with overlap blending: a copy of
``planer_tpu/utils/tile.py`` (numpy only).

Optional resampling to ``sample`` size, padding/rounding to a ``glob``
multiple, overlapping ``window`` slices with ``margin`` overlap, per-window
forward passes, and triangular edge-ramp weighted blending of overlaps —
output-scale aware (segmentation k=1 and super-resolution k>1 both work).
The windows run one after another through the wrapped function (a net on
the card); the blend runs on the host.
"""
from __future__ import annotations

import itertools
import math

import numpy as np

from .image import resize

__all__ = ["tile", "grid_slice", "make_slice"]


def make_slice(length: int, window: int, margin: int) -> list[slice]:
    """Window start positions covering [0, length) with >= margin overlap."""
    n = max(1, math.ceil((length - margin) / max(window - margin, 1)))
    starts = np.linspace(0, length - window, n)
    return [slice(int(s), int(s) + window) for s in starts]


def grid_slice(H: int, W: int, h: int, w: int, margin: int):
    return list(itertools.product(make_slice(H, h, margin),
                                  make_slice(W, w, margin)))


def _blend_weights(h: int, w: int, overlap: int) -> np.ndarray:
    """Separable triangular blend ramp.

    Along each axis the weight rises 1..overlap+1 from the border and
    plateaus; the 2-D weight is the outer minimum of the two axis ramps, so
    corners take the corner-correct min (not the product) and two windows
    overlapping by ``overlap`` pixels sum to a constant across the seam."""

    def axis_ramp(n: int) -> np.ndarray:
        up = np.arange(1, n + 1)
        return np.minimum(np.minimum(up, up[::-1]), overlap + 1)

    return np.minimum(axis_ramp(h)[:, None],
                      axis_ramp(w)[None, :]).astype(np.float32)


def _run_tiled(f, img, args, kwargs, *, sample, glob, window, margin,
               progress, astype):
    in_h, in_w = img.shape[:2]
    work = img.astype(astype, copy=False)

    # working resolution: explicit (h, w) or a scale factor of the input
    if isinstance(sample, (tuple, list)):
        work_hw = [int(sample[0]), int(sample[1])]
    else:
        work_hw = [int(in_h * sample), int(in_w * sample)]
    # a window larger than the image collapses, per axis, to the image
    # extent rounded up to a ``glob`` multiple (models often require
    # shape % 2**depth == 0)
    win = [window, window]
    for ax in (0, 1):
        if win[ax] > work_hw[ax]:
            win[ax] = work_hw[ax] = math.ceil(work_hw[ax] / glob) * glob
    if work_hw != [in_h, in_w]:
        work = resize(work, work_hw)
    overlap = int(window * margin) if isinstance(margin, float) else margin

    windows = grid_slice(work_hw[0], work_hw[1], win[0], win[1], overlap)
    total = len(windows)

    acc = norm = ramp = None
    scale = 1.0
    out_dtype = None
    for idx, (rs, cs) in enumerate(windows):
        if progress and total > 1:
            progress(idx + 1, total)
        piece = np.asarray(f(work[rs, cs], *args, **kwargs))
        if acc is None:
            # the first result fixes the output scale (super-resolution
            # nets return k x the window height) and the output dtype
            scale = piece.shape[0] / (rs.stop - rs.start)
            out_dtype = piece.dtype
            if total == 1:
                if work_hw != [in_h, in_w]:
                    piece = resize(piece, (int(in_h * scale),
                                           int(in_w * scale)))
                return piece.astype(out_dtype)
            ramp = _blend_weights(piece.shape[0], piece.shape[1],
                                  int(overlap * scale))
            if piece.ndim == 3:
                ramp = ramp[:, :, None]
            full = (int(work.shape[0] * scale), int(work.shape[1] * scale))
            acc = np.zeros(full + piece.shape[2:], dtype=np.float32)
            norm = np.zeros(full + (1,) * (piece.ndim - 2),
                            dtype=np.float32)
        dst = (slice(int(rs.start * scale), int(rs.stop * scale)),
               slice(int(cs.start * scale), int(cs.stop * scale)))
        acc[dst] += piece * ramp
        norm[dst] += ramp
    acc /= norm
    if work_hw != [in_h, in_w]:
        acc = resize(acc, (int(in_h * scale), int(in_w * scale)))
    return acc.astype(out_dtype)


def tile(sample=1, glob=1, window=1024, margin=0.1, astype="float32",
         progress=None):
    """Decorator: make ``f(img2d_or_hwc) -> img`` work on arbitrarily large
    inputs by running it on overlapping windows and blending the seams.
    Tiling options may be overridden per call via keyword arguments of the
    same names; every other kwarg is forwarded to ``f``."""
    options = {"sample": sample, "glob": glob, "window": window,
               "margin": margin, "progress": progress}

    def deco(f):
        def wrapped(img, *args, **kwargs):
            opts = {k: kwargs.pop(k, v) for k, v in options.items()}
            return _run_tiled(f, np.asarray(img), args, kwargs,
                              astype=astype, **opts)
        return wrapped

    return deco
