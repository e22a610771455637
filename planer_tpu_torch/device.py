"""Device selection and the numeric defaults of the port's entry points:
which device a call runs on, how 64-bit inputs narrow at the boundary, and
the float32 precision a program holds during its calls."""
from __future__ import annotations

import contextlib
import threading

import torch

__all__ = ["resolve_device", "narrow_64bit", "float32_exact"]


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


# the 32-bit dtype jnp.asarray gives a 64-bit value with 64-bit mode off
_NARROW = {torch.float64: torch.float32, torch.int64: torch.int32}


def narrow_64bit(t: torch.Tensor) -> torch.Tensor:
    """``t`` with float64 narrowed to float32 and int64 to int32, as
    ``jnp.asarray`` narrows a program's inputs; other dtypes as they are.
    The ops that take integer operands as indices (``gather``,
    ``scatternd``, the recurrent ops' ``sequence_lens``) widen them to
    int64 themselves."""
    dt = _NARROW.get(t.dtype)
    return t if dt is None else t.to(dt)


# float32_exact's state: the nesting depth over all threads and the flags
# the outermost entry found
_F32_LOCK = threading.Lock()
_f32_depth = 0
_f32_saved: tuple[bool, bool] | None = None


@contextlib.contextmanager
def float32_exact():
    """Within the block, float32 convolutions (cuDNN) and matmuls (cuBLAS)
    run in float32, not TF32 (torch's default leaves cuDNN's TF32 on).
    The flags are process-wide, so entries nest over threads: the first
    entry saves ``torch.backends.cudnn.allow_tf32`` and
    ``torch.backends.cuda.matmul.allow_tf32`` and turns both off, and the
    last exit restores what the first found.  Another thread running torch
    outside any port call meanwhile sees them off too.  Only these legacy
    flags are read and set (torch refuses a read of them after the
    ``fp32_precision`` API has set TF32, so a caller keeps to these).  Also
    a decorator."""
    global _f32_depth, _f32_saved
    cudnn, matmul = torch.backends.cudnn, torch.backends.cuda.matmul
    with _F32_LOCK:
        if _f32_depth == 0:
            _f32_saved = (cudnn.allow_tf32, matmul.allow_tf32)
            cudnn.allow_tf32 = matmul.allow_tf32 = False
        _f32_depth += 1
    try:
        yield
    finally:
        with _F32_LOCK:
            _f32_depth -= 1
            if _f32_depth == 0:
                cudnn.allow_tf32, matmul.allow_tf32 = _f32_saved
                _f32_saved = None
