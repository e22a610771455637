"""Comparisons of answers with the plain reference's, shared by the
configuration families."""
from __future__ import annotations

import torch


def max_rel_gap(got, ref) -> float:
    """Largest over items of max|got - ref| / max|ref| (logits, one row an
    item)."""
    ref = torch.as_tensor(ref, dtype=torch.float64)
    got = torch.as_tensor(got, dtype=torch.float64).to(ref.device)
    got = got.reshape(ref.shape[0], -1)
    gap = (got - ref.reshape(ref.shape[0], -1)).abs().amax(1)
    return float((gap / (ref.reshape(ref.shape[0], -1).abs().amax(1)
                         + 1e-9)).max())
