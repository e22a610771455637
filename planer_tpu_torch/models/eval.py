"""Evaluation inputs: ``synthetic_images``, a copy of the JAX package's
generator (planer_tpu/models/eval.py), so both packages calibrate and
evaluate on the same arrays from the same seed."""
from __future__ import annotations

import numpy as np

__all__ = ["synthetic_images"]


def synthetic_images(n: int, shape=(3, 224, 224), seed: int = 0,
                     batch: int = 8):
    """Deterministic structured inputs (mixed gaussians + gradients) — more
    activation-realistic than white noise for calibration/eval."""
    rng = np.random.default_rng(seed)
    c, h, w = shape
    for start in range(0, n, batch):
        b = min(batch, n - start)
        base = rng.standard_normal((b, c, h, w)).astype(np.float32)
        yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
        grad = (xx / w + yy / h)[None, None] - 1.0
        blobs = np.zeros((b, 1, h, w), np.float32)
        for i in range(b):
            cy, cx = rng.integers(0, h), rng.integers(0, w)
            s = float(rng.uniform(h / 16, h / 4))
            blobs[i, 0] = np.exp(-((yy - cy) ** 2 + (xx - cx) ** 2)
                                 / (2 * s * s))
        yield (0.5 * base + grad + 2 * blobs).astype(np.float32)
