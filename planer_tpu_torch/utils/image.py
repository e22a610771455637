"""Host-side image toolkit: resize, coordinate sampling, separable filters.

A copy of ``planer_tpu/utils/image.py`` (numpy only).

Capability parity with the reference's image utilities (util.py:221-285),
re-implemented cleanly: bilinear ``resize`` with half-pixel clamped sampling,
``mapcoord`` bilinear coordinate lookup, separable uniform/gaussian filters.
These run on the host (pre/post-processing around the net); the in-graph
upsample op lives in planer_tpu_torch.ops.
"""
from __future__ import annotations

import numpy as np

__all__ = ["resize", "mapcoord", "uniform_filter", "gaussian_filter"]


def _axis_coords(in_size: int, out_size: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Half-pixel source coords, clamped; returns (lo, hi, frac)."""
    k = out_size / in_size
    x = (np.arange(out_size) + 0.5) / k - 0.5
    x = np.clip(x, 0, in_size - 1)
    lo = np.floor(np.clip(x, 0, in_size - 1 - 1e-9)).astype(np.int64)
    hi = np.minimum(lo + 1, in_size - 1)
    frac = (x - lo).astype(np.float32)
    return lo, hi, frac


def resize(img: np.ndarray, size) -> np.ndarray:
    """Bilinear resize of an (H, W[, C]) image to ``size=(H', W')``."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    oh, ow = int(size[0]), int(size[1])
    rlo, rhi, rf = _axis_coords(h, oh)
    clo, chi, cf = _axis_coords(w, ow)
    rf = rf.reshape(-1, *([1] * (img.ndim - 1)))
    cf = cf.reshape(-1, *([1] * (img.ndim - 2)))
    rows = img[rlo] * (1 - rf) + img[rhi] * rf
    out = rows[:, clo] * (1 - cf) + rows[:, chi] * cf
    return out.astype(img.dtype) if np.issubdtype(img.dtype, np.floating) else out


def mapcoord(img: np.ndarray, rs: np.ndarray, cs: np.ndarray,
             keeptp: bool = True) -> np.ndarray:
    """Bilinear sampling of (H, W[, C]) ``img`` at float coords (rs, cs)."""
    img = np.asarray(img)
    h, w = img.shape[:2]
    rs = np.clip(np.asarray(rs, np.float32), 0, h - 1)
    cs = np.clip(np.asarray(cs, np.float32), 0, w - 1)
    ra = np.floor(np.clip(rs, 0, h - 1.5)).astype(np.int64)
    ca = np.floor(np.clip(cs, 0, w - 1.5)).astype(np.int64)
    fr, fc = rs - ra, cs - ca
    if img.ndim == 3:
        fr, fc = fr[..., None], fc[..., None]
    out = (img[ra, ca] * (1 - fr) * (1 - fc) + img[ra + 1, ca] * fr * (1 - fc)
           + img[ra, ca + 1] * (1 - fr) * fc + img[ra + 1, ca + 1] * fr * fc)
    return out.astype(img.dtype) if keeptp else out


def _sep_filter(img: np.ndarray, core: np.ndarray, mode: str) -> np.ndarray:
    """Apply a 1-D filter along rows then columns (separable convolution)."""
    img = np.asarray(img)
    k = core.size
    out = img.astype(np.float32)
    for axis in (0, 1):
        p = [(0, 0)] * img.ndim
        p[axis] = (k // 2, k // 2)
        padded = np.pad(out, p, mode=mode)
        acc = np.zeros_like(out)
        sl = [slice(None)] * img.ndim
        for i in range(k):
            sl[axis] = slice(i, i + out.shape[axis])
            acc += padded[tuple(sl)] * core[i]
        out = acc
    return out.astype(img.dtype) if np.issubdtype(img.dtype, np.integer) else out


def uniform_filter(img: np.ndarray, size: int = 3, mode: str = "reflect"):
    core = np.ones(size, np.float32) / size
    return _sep_filter(img, core, mode)


def gaussian_filter(img: np.ndarray, sig: float = 2, mode: str = "reflect"):
    r = int(sig * 2.5 + 0.5)
    x = np.arange(-r, r + 1)
    core = np.exp(-x**2 / (2 * sig**2)) / (sig * np.sqrt(2 * np.pi))
    return _sep_filter(img, core.astype(np.float32), mode)
