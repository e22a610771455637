"""The port's own float8_e4m3fn codec, on the host, without ``ml_dtypes``.

numpy has no float8 dtype of its own: the JAX package gets one from
``ml_dtypes``, which the port does not use.  So the port holds an fp8
payload on the host as a uint8 array of its bit patterns, keeps the dtype
name ``"float8_e4m3fn"`` in ``graph.inits`` (as the JAX package writes it,
so ``.pla`` files and blobs are byte-compatible), and turns the bytes into a
``torch.float8_e4m3fn`` tensor only when an op needs the payload.

e4m3fn: 1 sign, 4 exponent (bias 7) and 3 mantissa bits, no infinities,
codes 0x7F and 0xFF are NaN, the largest finite value is 448.  Every value
is exact in float16, bfloat16 and float32.

``encode`` rounds to nearest even through torch's CPU cast, which gives the
bytes ``ml_dtypes`` gives for every |v| <= 464.  Above that ``ml_dtypes``
returns NaN and torch saturates to +-448; ``quant.quantize_net`` divides by
absmax / 448 and so never gets there.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["NAME", "MAX", "encode", "decode", "to_tensor", "is_fp8"]

NAME = "float8_e4m3fn"   # the init dtype name in graph.inits
MAX = 448.0


def is_fp8(dtype_name) -> bool:
    return str(dtype_name) == NAME


def encode(v: np.ndarray) -> np.ndarray:
    """float32 values -> uint8 e4m3fn bit patterns of the same shape."""
    t = torch.from_numpy(np.ascontiguousarray(v, dtype=np.float32))
    return t.to(torch.float8_e4m3fn).view(torch.uint8).numpy()


def _table() -> np.ndarray:
    codes = np.arange(256)
    sign = np.where(codes & 0x80, -1.0, 1.0)
    exp, man = (codes >> 3) & 0xF, codes & 0x7
    val = np.where(exp == 0, man / 8.0 * 2.0 ** -6,
                   (1.0 + man / 8.0) * 2.0 ** (exp - 7.0))
    val = sign * val
    val[(codes & 0x7F) == 0x7F] = np.nan
    return val.astype(np.float32)


_DECODE = _table()


def decode(q: np.ndarray) -> np.ndarray:
    """uint8 e4m3fn bit patterns -> float32 values (NaN for 0x7F, 0xFF)."""
    return _DECODE[np.asarray(q, dtype=np.uint8)]


def to_tensor(q: np.ndarray) -> torch.Tensor:
    """uint8 bit patterns -> a ``torch.float8_e4m3fn`` tensor (a view)."""
    return torch.from_numpy(np.ascontiguousarray(q, dtype=np.uint8)).view(
        torch.float8_e4m3fn)
