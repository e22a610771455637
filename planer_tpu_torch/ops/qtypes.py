"""Quantized-tensor type shared by the quantization layer and ops."""
from __future__ import annotations

import dataclasses

import torch

__all__ = ["QTensor"]


@dataclasses.dataclass(eq=False)
class QTensor:
    """Quantized weight payload + broadcast-ready scales.

    ``q`` is an int8 or a float8_e4m3fn tensor with the original weight's
    shape; ``scale`` is a float32 tensor already shaped for broadcast (per
    output channel).  Both payload types are exact in float32, so
    ``dequant`` is the same arithmetic for either.

    ``act_dynamic``: the consuming op may quantize its activations
    per-tensor on the fly and run the s8 x s8 -> s32 path where the shape
    profits (int8 payloads only; the ops' gates test ``q.dtype``).
    ``act_scale`` is the calibrated static per-tensor activation scale, or
    None.  Identity equality (``eq=False``) keeps instances hashable, so
    per-weight caches can key on them.
    """

    q: torch.Tensor
    scale: torch.Tensor
    act_dynamic: bool = False
    act_scale: float | None = None

    def dequant(self, dtype=torch.float32):
        # same association as the JAX package: (q * scale) in f32, then cast
        return (self.q.float() * self.scale).to(dtype)

    @property
    def shape(self):
        return self.q.shape

    @property
    def ndim(self):
        return self.q.ndim

    @property
    def dtype(self):
        return self.q.dtype

    @property
    def device(self):
        return self.q.device
