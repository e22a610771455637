"""Seeded inputs of the benchmark: every random stream is a function of
``--seed`` and a stream name, and is drawn on the device in a few large
calls, so the same seed gives the same weights and images on one device."""
from __future__ import annotations

import zlib

import numpy as np
import torch
import torch.nn.functional as F


def generator(seed: int, stream: str, device) -> torch.Generator:
    """A generator on ``device`` for stream ``stream`` of run seed ``seed``
    (any integer: the two are hashed into 64 bits)."""
    ss = np.random.SeedSequence([int(seed) % 2 ** 64, zlib.crc32(stream.encode())])
    g = torch.Generator(device=torch.device(device))
    g.manual_seed(int(ss.generate_state(1, np.uint64)[0]))
    return g


def images(n: int, side: int, g: torch.Generator) -> torch.Tensor:
    """``n`` float32 RGB images (n, 3, side, side) on the generator's device:
    a smooth field (8x8 pixel cells, bilinear) plus pixel noise, about unit
    variance, so neighbouring pixels correlate as in a photograph."""
    dev = g.device
    coarse = torch.randn((n, 3, max(side // 8, 1), max(side // 8, 1)),
                         generator=g, device=dev)
    fine = torch.randn((n, 3, side, side), generator=g, device=dev)
    smooth = F.interpolate(coarse, size=(side, side), mode="bilinear",
                           align_corners=False)
    return (smooth + 0.5 * fine).contiguous()
