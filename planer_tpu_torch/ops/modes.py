"""Numeric-parity modes — a copy of ``planer_tpu/ops/modes.py`` (numpy
only), which the port may not import.

Erf: the original planer computes Erf through a 1025-entry lookup table over
[-2, 2], index ``trunc(clip(x + 2, 0, 4) * 256)`` into ``erf(i/256 - 2)``.
The exact function is the default; the ``"lut"`` mode reproduces the table
bit for bit in the program and in the float32 executor alike.

The mode is read at call time: set it before running a net.
"""
from __future__ import annotations

import math

import numpy as np

__all__ = ["set_erf_mode", "get_erf_mode", "ERF_LUT", "lut_index_f"]

# ERF_LUT[i] = erf(i/256 - 2), i in [0, 1024]
ERF_LUT = np.asarray([math.erf(i / 256 - 2) for i in range(1025)], np.float32)

_erf_mode = "exact"


def set_erf_mode(mode: str) -> None:
    """``"exact"`` (default) or ``"lut"`` (the original planer's table)."""
    global _erf_mode
    if mode not in ("exact", "lut"):
        raise ValueError(f"erf mode must be 'exact' or 'lut', got {mode!r}")
    _erf_mode = mode


def get_erf_mode() -> str:
    return _erf_mode


def lut_index_f(x):
    """The table's index before truncation: clip(x + 2, 0, 4) * 256.

    Pure arithmetic, for numpy arrays and torch tensors alike; truncation
    toward zero equals floor here because the operand is non-negative.
    """
    return (x + 2).clip(0, 4) * 256
