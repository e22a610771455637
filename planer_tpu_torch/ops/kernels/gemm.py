"""Weight-only int8 / fp8 GEMM — the port of ``planer_tpu/ops/pallas/gemm.py``.

``dense_q(x, K, B)`` computes y = x @ dequant(K).T + B for int8 or
float8_e4m3fn weights ``K.q`` (N, Kd) with per-output-channel scales, by one
of two numerics, as the reference does:

  * the kernel branch, where ``tile_plan`` admits the shape (N and Kd
    multiples of 128, M >= 8, within the reference's VMEM budget): x rounded
    to bf16, the weights exact in bf16 (int8 and e4m3 both are), an f32 sum
    of exact products, the per-column scale applied to the f32 accumulator,
    the result cast to x's dtype and the bias added after the cast.  On
    CUDA tensors this is the hand-written Hopper kernel ``csrc/gemm.cu``
    (launches counted in ``LAUNCHES["dense_q"]`` for int8 weights and
    ``LAUNCHES["dense_q[fp8]"]`` for fp8); on CPU tensors its plain PyTorch
    version ``dense_q_plain``;
  * ``fallback_dense`` everywhere else (the ResNet fc, N = 1000): weights
    dequantized to x's dtype, f32 accumulation, cast, then the bias.  The
    reference computes it outside any Pallas kernel, so it stays a
    ``torch.matmul``.

The gate decides the numerics, so the port takes the kernel branch on
exactly the shapes where the TPU takes it.  It has no dtype term, and its
VMEM estimate counts one byte per weight for both payloads.  Its tile sizes
are TPU tiling and the kernel does not use them: the kernel's own tiles
are ``kernel_plan``'s (128 channels by 128 or 64 pixels, a persistent grid
of one block per SM), which the C side computes the same way
(``dense_q_plan`` in ``csrc/gemm.cu``).  The kernel reads x as bf16: the
wrapper rounds f32 x to bf16 (round to nearest even, the reference's round
in its kernel branch) and the kernel writes an f32 result.
"""
from __future__ import annotations

import collections
import ctypes
import functools

import numpy as np
import torch

from ..qtypes import QTensor

__all__ = ["dense_q", "matmul_q", "tile_plan", "kernel_plan", "device_plan",
           "fallback_dense", "dense_q_plain", "dense_q_kernel", "LAUNCHES"]

# kernel launches ("dense_q": int8 weights, "dense_q[fp8]": e4m3 weights);
# plain-version runs are not counted
LAUNCHES = collections.Counter()
KERNEL_NAMES = (("dense_q", "dense_q_kernel"),)

_VMEM_BUDGET = 12 * 1024 * 1024   # the reference's, part of its gate


@functools.lru_cache(maxsize=4096)
def tile_plan(M: int, N: int, Kd: int):
    """The reference's ``_tile_plan``: (bm, bn), or None where the kernel
    branch is not taken."""
    if N % 128 or Kd % 128:
        return None
    if M < 8:
        return None
    bm = 256 if M >= 256 else max(8, 1 << int(np.floor(np.log2(max(M, 1)))))
    bn = min(256, N)
    vmem = bm * Kd * 4 + Kd * bn + bm * bn * 4
    if vmem > _VMEM_BUDGET:
        return None
    return bm, bn


H100_SMS = 132
KERNEL_BC = 128       # channels per kernel tile


def kernel_plan(M: int, N: int, Kd: int, sms: int = H100_SMS):
    """The CUDA kernel's tile plan for a shape ``tile_plan`` admits:
    (pixels per tile, tiles, blocks).  128-pixel tiles, or 64-pixel tiles
    where 128-pixel ones would leave SMs idle (fewer tiles than SMs);
    channels fastest in the tile order, one persistent block per SM.
    ``csrc/gemm.cu``'s ``make_plan`` is the same function."""
    tn = N // KERNEL_BC
    t128, t64 = -(-M // 128) * tn, -(-M // 64) * tn
    bp = 128 if t128 >= sms else 64
    tiles = t128 if bp == 128 else t64
    return bp, tiles, min(tiles, sms)


def fallback_dense(x2d, K: QTensor, B=None):
    """The reference's ``_fallback_dense``: weights dequantized to x's dtype,
    f32 accumulation, result cast to x's dtype, bias added after the cast."""
    Kd = K.dequant(x2d.dtype)
    # bf16 operands are exact in f32, so an f32 product is the f32-accumulated
    # bf16 dot (TF32 is off inside every program and executor call)
    y = torch.matmul(x2d.float(), Kd.float().t()).to(x2d.dtype)
    if B is not None:
        y = y + B.reshape(1, -1).to(y.dtype)
    return y


def dense_q_plain(x2d, q, scale, B=None):
    """The kernel branch in plain PyTorch: f32(bf16(x)) @ f32(q).T (exact
    products, f32 sums) times the per-column scale, cast to x's dtype, plus
    the bias in that dtype.  Refuses to run with TF32 on, which would round
    the operands."""
    if x2d.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("dense_q_plain: TF32 matmuls are on")
    N = q.shape[0]
    acc = torch.matmul(x2d.to(torch.bfloat16).float(), q.float().t())
    y = (acc * scale.reshape(1, N).float()).to(x2d.dtype)
    if B is not None:
        y = y + B.reshape(1, N).to(x2d.dtype)
    return y


# --------------------------------------------------------------------------
# kernel wrapper
# --------------------------------------------------------------------------

_VP, _I = ctypes.c_void_p, ctypes.c_int
# x's dtype -> the kernel's odtype code (the output and bias dtype)
_XDTYPES = {torch.float32: 0, torch.bfloat16: 1}
# weight dtype -> (the kernel's wdtype code, the LAUNCHES key)
_WDTYPES = {torch.int8: (0, "dense_q"),
            torch.float8_e4m3fn: (1, "dense_q[fp8]")}


def _lib():
    from . import build
    lib = build.load("gemm")
    if not getattr(lib, "_planer_typed", False):
        lib.dense_q.argtypes = [_VP, _VP, _VP, _VP, _VP, _I, _I, _I, _I, _I,
                                _VP]
        lib.dense_q.restype = _I
        lib.dense_q_plan.argtypes = [_I, _I, _I, ctypes.POINTER(_I)]
        lib.dense_q_plan.restype = _I
        lib._planer_typed = True
    return lib


def device_plan(M: int, N: int, Kd: int):
    """The plan the built kernel takes on the current card (its C
    ``dense_q_plan``): (pixels per tile, tiles, blocks)."""
    plan = (_I * 3)()
    err = _lib().dense_q_plan(M, N, Kd, plan)
    if err:
        raise RuntimeError(f"dense_q_plan({M}, {N}, {Kd}): CUDA error {err}")
    return tuple(plan)


def _stream(device):
    """The raw handle of the current CUDA stream on ``device`` (a few
    hundred ns, against microseconds for a ``torch.cuda.Stream`` object)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _launch(x2d, q, scale, B):
    """One kernel launch: (M, Kd) x in f32 or bf16 (read as bf16), (N, Kd)
    int8 or e4m3 weights as they are (row n is the k-contiguous column n of
    the GEMM's B); the result and the bias in x's dtype."""
    M, Kd = x2d.shape
    N = q.shape[0]
    wcode, key = _WDTYPES[q.dtype]
    odt = x2d.dtype
    xb = x2d.to(torch.bfloat16)
    if xb.data_ptr() % 16:        # TMA needs 16-byte aligned bases
        xb = xb.clone()
    if q.data_ptr() % 16:
        q = q.clone()
    out = torch.empty((M, N), dtype=odt, device=x2d.device)
    err = _lib().dense_q(xb.data_ptr(), q.data_ptr(), scale.data_ptr(),
                         B.data_ptr() if B is not None else None,
                         out.data_ptr(), M, N, Kd, _XDTYPES[odt], wcode,
                         _stream(x2d.device))
    if err:
        raise RuntimeError(f"dense_q launch failed: CUDA error {err}")
    LAUNCHES[key] += 1
    return out


def dense_q_kernel(x2d, q, scale, B=None):
    """Kernel wrapper for ``dense_q_plain`` (same arguments and result) on a
    shape ``tile_plan`` admits.  CPU tensors run the plain version; CUDA
    tensors launch the kernel."""
    if x2d.ndim != 2 or q.ndim != 2 or x2d.shape[1] != q.shape[1]:
        raise ValueError(f"dense_q: x {tuple(x2d.shape)} and weights "
                         f"{tuple(q.shape)} do not chain")
    M, Kd = x2d.shape
    N = q.shape[0]
    if tile_plan(M, N, Kd) is None:
        raise ValueError(f"dense_q: ({M}, {N}, {Kd}) is not a kernel shape")
    if x2d.dtype not in _XDTYPES or q.dtype not in _WDTYPES:
        raise TypeError(f"dense_q: x {x2d.dtype} and weights {q.dtype}; the "
                        f"kernel takes f32 or bf16 x and int8 or "
                        f"float8_e4m3fn weights")
    scale = scale.reshape(N)
    if scale.dtype != torch.float32:
        raise TypeError(f"dense_q: scale dtype {scale.dtype}")
    if B is not None:
        B = B.reshape(N).to(x2d.dtype)
    dev = x2d.device
    for name, t in (("weights", q), ("scale", scale), ("bias", B)):
        if t is not None and t.device != dev:
            raise ValueError(f"dense_q: {name} on {t.device}, x on {dev}")
    if dev.type == "cpu":
        return dense_q_plain(x2d, q, scale, B)
    if dev.type != "cuda":
        raise ValueError(f"dense_q: no kernel for {dev}")
    return _launch(x2d.contiguous(), q.contiguous(), scale.contiguous(),
                   None if B is None else B.contiguous())


# --------------------------------------------------------------------------
# public ops
# --------------------------------------------------------------------------

def dense_q(x, K: QTensor, B=None, *, plain=False, branch=None):
    """y = x @ dequant(K).T + B;  K.q is (N, Kd) int8 or float8_e4m3fn,
    scales (N, 1).  The shape alone picks the numerics (``tile_plan``, its
    rows counted at the logical batch of ``torch_ops.logical_batch``), or
    ``branch`` (``"kernel"`` or ``"fallback"``) where a sharded program
    forces the unsharded GEMM's.  ``plain`` runs the kernel branch's plain
    version on any device — the reference a caller holds the kernel
    against; it never happens by itself."""
    from ..torch_ops import logical_rows
    N, Kd = K.q.shape
    x2d = x.reshape(-1, Kd)
    if branch is None:
        rows = logical_rows(x2d.shape[0], x.shape[0] if x.ndim > 1 else 0)
        branch = "fallback" if tile_plan(rows, N, Kd) is None else "kernel"
    if branch == "fallback":
        y = fallback_dense(x2d, K, B)
    elif plain:
        y = dense_q_plain(x2d, K.q, K.scale, B)
    else:
        y = dense_q_kernel(x2d, K.q, K.scale, B)
    return y.reshape(*x.shape[:-1], N)


def matmul_q(x, K: QTensor, *, plain=False):
    """x @ dequant(K) for (Kd, N)-layout quantized weights."""
    q = QTensor(K.q.t(), K.scale.reshape(-1, 1))
    return dense_q(x, q, None, plain=plain)
