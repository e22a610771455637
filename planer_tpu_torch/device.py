"""Device selection for the port's entry points."""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """The torch.device an entry point runs on.  The default is the CUDA
    card; a caller that wants the CPU says so.  Asking for CUDA where there
    is none raises, rather than carrying on quietly on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "planer_tpu_torch runs on a CUDA device by default and none is "
            "available; pass device='cpu' to run on the CPU")
    return dev
