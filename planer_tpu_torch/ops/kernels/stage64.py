"""Fused ResNet entry stage (stem conv + maxpool + C=64 basic blocks) — the
port of ``planer_tpu/ops/pallas/stage64.py``.

Two hand-written Hopper kernels (``csrc/stage64.cu``) run the stage, both
implicit GEMMs on the int8 tensor cores (``mma.sync`` m16n8k32 s8 x s8 ->
s32) in a persistent grid that loads the weights once per block:

  * ``stem_pool_requant`` replaces ``_stage_kernel`` in its stem-only forms:
    7x7/2 s8 conv with int32 accumulation (K = the 147 taps zero-padded to
    160, gathered into a shared-memory A tile of a 15 x 17 conv tile), the
    3x3/2 maxpool taken on the raw int32 accumulators (-2^30 border), one
    requant of the pooled 7 x 8 tile;
  * ``basic_block`` replaces ``_block_kernel``: conv3x3 -> requant ->
    int8 mid plane kept in shared memory -> conv3x3 + residual -> int8 out,
    or, for a last block without ``out_scale``, exact f32 + ReLU -> bf16
    out, on 14 x 14 output tiles held channel-last in shared memory (a tap
    is an address offset: no im2col copy), both convs' weights resident.

Their weights are packed in the kernels' order once, when ``_fold`` builds
the plan the program caches (``_pack_stem``: (64, 160) with K in the
weights' (c, ky, kx) order; ``_pack_block``: (9, 64, 64) [tap][o][c]), and
``_run`` hands them to the wrappers, so no call on the program path
permutes or pads a weight.  A wrapper called without them packs them
itself.

Beside each kernel sits its plain PyTorch version with the same integer
arithmetic.  A wrapper runs the plain version only for CPU tensors; for a
CUDA tensor it launches the kernel or raises, and counts the launch in
``LAUNCHES``.  All requant scales fold on the host in float64 numpy exactly
as the JAX package folds them (``_fxp_pack`` and ``_pallas_stage``), so the
int8 planes are bit-identical to the reference's.

The module flags are the reference's A/B switches, read at call time, with
its defaults:

  * ``REQUANT``: "fxp" — int32 fixed-point int8 epilogues — or "trunc" —
    exact f32 ``acc*f + b`` clipped to [0, 127.99] and truncated;
  * ``SPLIT``: True — one call for the stem and one per block — or False —
    the reference's one-call form (``_stage_kernel`` with blocks): the trunc
    stem, trunc blocks and a bf16 last plane, ignoring ``out_scale``.  That
    kernel computes the same function as the split trunc chain (the same
    tables, epilogues and bf16 last plane), and on Hopper one launch cannot
    hold a stage (a 56x56x64 plane and its mid plane are 400 KB per image,
    against 227 KB of shared memory), so the port runs it as that chain of
    launches.  Like the reference it folds the last block's tables with
    ``out_scale`` all the same (ROADMAP "Faults found").

The TPU lane layout (row stride, halos, packed dots) is not part of the
contract.  Ineligible geometries fall back to ``decomposed`` and are counted
in ``FALLOFF``, as in the reference.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..qtypes import QTensor
from ..torch_ops import conv_s8, quantize, scalar, _window_max

__all__ = ["stage64", "decomposed", "FALLOFF", "LAUNCHES",
           "stem_pool_requant", "basic_block", "stem_pool_requant_plain",
           "basic_block_plain", "stem_prologue"]

# why the fused kernels were skipped, by reason
FALLOFF = collections.Counter()
# kernel launches by wrapper and form: "stem_pool_requant" (fxp),
# "stem_pool_requant[bf16]" and "[trunc]"; "basic_block" (int8 out) and
# "basic_block_last" (bf16 out), with "[trunc]" for the trunc requants;
# plain-version runs are not counted
LAUNCHES = collections.Counter()

# the reference's A/B flags (module doc), with its defaults
SPLIT = True
REQUANT = "fxp"

_FXP_MMAX = 115
# pool border sentinel: far below any s8 x s8 K <= 576 accumulator, exact
# in f32 and overflow-safe under max
_NEG = -2 ** 30
# stem epilogue modes (the kernel's MODE template argument)
STEM_MODES = {"fxp": 0, "bf16": 1, "trunc": 2}


def _fxp_pack(f, b_half, sx=0.0):
    """Fold per-channel f32 requant (f, b+0.5) into int32 (m, B, s, mr) with
    clamp((acc*m + res*mr + B) >> s, 0, 127) == clamp(floor(acc*f + res*sx
    + b + 0.5)) up to the m/mr rounding error.  Headroom budget in int32:
    |acc*m| <= 2^30, |res*mr| <= 2^29, |B| <= 2^28.  (A float64 numpy copy
    of the reference's ``_fxp_pack``.)"""
    f = np.asarray(f, np.float64).reshape(-1)
    bh = np.asarray(b_half, np.float64).reshape(-1)
    s = np.floor(np.log2(_FXP_MMAX / np.maximum(f, 1e-30)))
    if sx:
        s = np.minimum(s, np.floor(np.log2(2.0 ** 29 / (127.0 * abs(sx)))))
    s = np.minimum(s, np.floor(np.log2(2.0 ** 28
                                       / np.maximum(np.abs(bh), 1.0))))
    s = np.clip(s, 0, 30)
    p = 2.0 ** s
    q = np.stack([np.round(f * p), np.round(bh * p), s,
                  np.round(sx * p)], axis=1)
    return q.astype(np.int32)


# --------------------------------------------------------------------------
# geometry and eligibility (the reference's, so the port fuses exactly where
# the reference does)
# --------------------------------------------------------------------------

_HALO = 128
_S_MAX = 5760


def _geometry(H):
    """Stage side R = H // 4 for a (H, H) input, or None if unsupported.
    The reference's TPU lane layout limits (row stride RS with R*RS a
    multiple of 128, S = R*RS <= 5760, RS + 1 <= 128) decide eligibility."""
    if H % 4:
        return None
    R = H // 4
    RS = next(r for r in range(R + 2, R + 130) if (R * r) % 128 == 0)
    if R < 16 or R * RS > _S_MAX or RS + 1 > _HALO:
        return None
    return R


def _is_q8(w, shape):
    return (isinstance(w, QTensor) and w.act_scale is not None
            and w.q.dtype == torch.int8 and tuple(w.q.shape) == shape)


def _eligible(x, Ws, bw):
    """Return the stage side R, or None (recording WHY in FALLOFF)."""
    if not _is_q8(Ws, (64, 3, 7, 7)):
        FALLOFF["weights"] += 1
        return None
    if x.ndim != 4 or x.shape[1] != 3 or x.shape[2] != x.shape[3]:
        FALLOFF["shape"] += 1
        return None
    R = _geometry(x.shape[2])
    if R is None:
        FALLOFF["geometry"] += 1
        return None
    if len(bw) % 4:    # empty = stem-only stage (ResNet-50) — allowed
        FALLOFF["weights"] += 1
        return None
    for i in range(0, len(bw), 4):
        for w in (bw[i], bw[i + 2]):
            if not _is_q8(w, (64, 64, 3, 3)):
                FALLOFF["weights"] += 1
                return None
    return R


# --------------------------------------------------------------------------
# plain PyTorch versions (the kernels' arithmetic, on any device)
# --------------------------------------------------------------------------

def stem_prologue(x, s_in):
    """Quantize the image to int8 codes: clamp(round(x / s_in), -127, 127),
    as the reference's XLA prologue does before the stem kernel (with the
    division compiled as XLA compiles it, see torch_ops.quantize)."""
    return quantize(x, s_in)


def _fxp_q(acc, q, res=None):
    """clamp((acc*m + B [+ res*mr]) >> s, 0, 127) in int32."""
    m, B, s, mr = (q[:, i].reshape(1, -1, 1, 1) for i in range(4))
    v = acc * m + B
    if res is not None:
        v = v + res.to(torch.int32) * mr
    return torch.clamp(v >> s, 0, 127).to(torch.int8)


def _affine(acc, f, b):
    """acc*f + b per channel in f32, the product and the sum each rounded
    (the kernels' __fmul_rn / __fadd_rn)."""
    return acc.float() * f.reshape(1, -1, 1, 1) + b.reshape(1, -1, 1, 1)


def _block_sum(acc, f, b, res, sx):
    """(acc*f + b) + res*sx, every step rounded, as the reference reads."""
    return _affine(acc, f, b) + res.float() * scalar(sx, res)


def _trunc_q(v):
    """clip(v, 0, 127.99) -> int8: float -> int8 conversion truncates."""
    return torch.clamp(v, 0.0, 127.99).to(torch.int8)


def stem_pool_requant_plain(xq, wq, table, mode="fxp"):
    """(N, 3, H, H) int8 codes -> (N, 64, H/4, H/4): 7x7/2 pad-3 s8 conv,
    3x3/2 pad-1 max over the int32 accumulators, then one requant.
    ``mode``: "fxp" (table (64, 4) int32 -> int8), "bf16" (table (2, 64)
    f32 rows f, b -> relu -> bf16) or "trunc" (f, b -> clip [0, 127.99] ->
    int8 by truncation)."""
    acc = conv_s8(xq, wq, (2, 2), (3, 3, 3, 3))
    pooled = _window_max(acc, 3, 3, 2, 2, (1, 1, 1, 1), _NEG)
    if mode == "fxp":
        return _fxp_q(pooled, table).contiguous()
    v = _affine(pooled, table[0], table[1])
    if mode == "bf16":
        return torch.clamp_min(v, 0.0).to(torch.bfloat16).contiguous()
    return _trunc_q(v).contiguous()


def basic_block_plain(y, w1, q1, w2, e2, sx=0.0, last=False, trunc=False):
    """One C=64 basic block on int8 codes (N, 64, R, R): conv3x3 -> requant
    (ReLU folded into the clip) -> conv3x3 + residual.  The int8 requants
    are fxp — q1 and, unless ``last``, e2 are (64, 4) int32 tables, e2 with
    the residual's ``mr`` term — or, with ``trunc``, (2, 64) f32 rows f, b:
    clip(acc*f + b [+ res*sx], 0, 127.99) truncated.  ``last`` True: e2 is
    (2, 64) f32 rows f2, b2 and the plane is exact f32 acc*f2 + b2 + res*sx,
    ReLU, bf16 out."""
    a1 = conv_s8(y, w1, (1, 1), (1, 1, 1, 1))
    y1 = _trunc_q(_affine(a1, q1[0], q1[1])) if trunc else _fxp_q(a1, q1)
    a2 = conv_s8(y1, w2, (1, 1), (1, 1, 1, 1))
    if not (last or trunc):
        return _fxp_q(a2, e2, res=y).contiguous()
    v = _block_sum(a2, e2[0], e2[1], y, sx)
    if not last:
        return _trunc_q(v).contiguous()
    return torch.clamp_min(v, 0.0).to(torch.bfloat16).contiguous()


# --------------------------------------------------------------------------
# kernel wrappers
# --------------------------------------------------------------------------

_VP, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _lib():
    from . import build
    lib = build.load("stage64")
    if not getattr(lib, "_planer_typed", False):
        lib.stem_pool_requant.argtypes = [_VP, _VP, _VP, _VP, _I, _I, _I, _VP]
        lib.stem_pool_requant.restype = _I
        lib.basic_block.argtypes = [_VP, _VP, _VP, _VP, _VP, _F, _VP, _I,
                                    _I, _I, _I, _VP]
        lib.basic_block.restype = _I
        lib._planer_typed = True
    return lib


def _check(t, name, dtype, shape, device):
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _check_aligned(*named):
    """The kernels read weights and tables in aligned 16-byte pieces and the
    stem's input in aligned 4-byte words; 16 covers both (an image of a
    batch with H % 4 == 0 starts 16-byte aligned)."""
    for name, t in named:
        if t.data_ptr() % 16:
            raise ValueError(f"{name}: must be 16-byte aligned")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def _table_spec(mode):
    return (torch.int32, (64, 4)) if mode == "fxp" \
        else (torch.float32, (2, 64))


STEM_K = 160     # the stem's 147 taps zero-padded to 5 k-steps of 32


def _pack_stem(wq):
    """(64, 3, 7, 7) -> (64, 160): each output channel's taps in their flat
    (c, ky, kx) order, then 13 zeros — the stem kernel's B operand."""
    return F.pad(wq.reshape(64, 147), (0, STEM_K - 147)).contiguous()


def _pack_block(w):
    """OIHW (64, 64, 3, 3) -> (9, 64, 64) [tap][o][c], tap = 3*ky + kx: a
    (tap, out channel) row is 64 contiguous input-channel bytes — the block
    kernel's B operand."""
    return w.permute(2, 3, 0, 1).reshape(9, 64, 64).contiguous()


def stem_pool_requant(xq, wq, table, mode="fxp", wpack=None):
    """Kernel wrapper for ``stem_pool_requant_plain`` (same arguments).
    CPU tensors run the plain version; CUDA tensors launch the kernel.
    ``wpack`` is ``_pack_stem(wq)`` when the caller keeps it (the program
    does); without it the wrapper packs ``wq`` for this call."""
    if mode not in STEM_MODES:
        raise ValueError(f"unknown stem mode {mode!r}")
    if xq.ndim != 4 or xq.shape[1] != 3 or xq.shape[2] != xq.shape[3] \
            or _geometry(xq.shape[2]) is None:
        raise ValueError(f"stem input shape {tuple(xq.shape)} unsupported")
    n, _, h, _ = xq.shape
    dev = xq.device
    tdt, tshape = _table_spec(mode)
    _check(xq, "xq", torch.int8, (n, 3, h, h), dev)
    _check(wq, "wq", torch.int8, (64, 3, 7, 7), dev)
    _check(table, "table", tdt, tshape, dev)
    if wpack is not None:
        _check(wpack, "wpack", torch.int8, (64, STEM_K), dev)
    if dev.type == "cpu":
        return stem_pool_requant_plain(xq, wq, table, mode)
    if dev.type != "cuda":
        raise ValueError(f"stem_pool_requant: no kernel for {dev}")
    if wpack is None:
        wpack = _pack_stem(wq)
    _check_aligned(("xq", xq), ("wpack", wpack), ("table", table))
    odt = torch.bfloat16 if mode == "bf16" else torch.int8
    out = torch.empty((n, 64, h // 4, h // 4), dtype=odt, device=dev)
    err = _lib().stem_pool_requant(xq.data_ptr(), wpack.data_ptr(),
                                   table.data_ptr(), out.data_ptr(), n, h,
                                   STEM_MODES[mode], _stream(xq))
    if err:
        raise RuntimeError(f"stem_pool_requant launch failed: CUDA error "
                           f"{err}")
    LAUNCHES["stem_pool_requant" + ("" if mode == "fxp" else f"[{mode}]")] += 1
    return out


def basic_block(y, w1, q1, w2, e2, sx=0.0, last=False, trunc=False,
                w1p=None, w2p=None):
    """Kernel wrapper for ``basic_block_plain`` (same arguments).
    CPU tensors run the plain version; CUDA tensors launch the kernel.
    ``w1p``/``w2p`` are ``_pack_block`` of ``w1``/``w2`` when the caller
    keeps them (the program does); without them the wrapper packs the
    weights for this call."""
    # an even side, as every eligible stage side is: the kernel stores
    # pixel pairs
    if y.ndim != 4 or y.shape[1] != 64 or y.shape[2] != y.shape[3] \
            or y.shape[2] % 2:
        raise ValueError(f"block input shape {tuple(y.shape)} unsupported")
    if (w1p is None) != (w2p is None):
        raise ValueError("basic_block: pass both packed weights or neither")
    dev = y.device
    qdt, qshape = _table_spec("trunc" if trunc else "fxp")
    edt, eshape = _table_spec("trunc" if (last or trunc) else "fxp")
    _check(y, "y", torch.int8, y.shape, dev)
    _check(w1, "w1", torch.int8, (64, 64, 3, 3), dev)
    _check(w2, "w2", torch.int8, (64, 64, 3, 3), dev)
    _check(q1, "q1", qdt, qshape, dev)
    _check(e2, "e2", edt, eshape, dev)
    if w1p is not None:
        _check(w1p, "w1p", torch.int8, (9, 64, 64), dev)
        _check(w2p, "w2p", torch.int8, (9, 64, 64), dev)
    if dev.type == "cpu":
        return basic_block_plain(y, w1, q1, w2, e2, sx, last, trunc)
    if dev.type != "cuda":
        raise ValueError(f"basic_block: no kernel for {dev}")
    n, _, r, _ = y.shape
    if w1p is None:
        w1p, w2p = _pack_block(w1), _pack_block(w2)
    _check_aligned(("w1p", w1p), ("w2p", w2p), ("q1", q1), ("e2", e2))
    out = torch.empty((n, 64, r, r),
                      dtype=torch.bfloat16 if last else torch.int8,
                      device=dev)
    err = _lib().basic_block(y.data_ptr(), w1p.data_ptr(), q1.data_ptr(),
                             w2p.data_ptr(), e2.data_ptr(), float(sx),
                             out.data_ptr(), n, r, int(bool(last)),
                             int(bool(trunc)), _stream(y))
    if err:
        raise RuntimeError(f"basic_block launch failed: CUDA error {err}")
    LAUNCHES[("basic_block_last" if last else "basic_block")
             + ("[trunc]" if trunc else "")] += 1
    return out


# --------------------------------------------------------------------------
# host folding (the reference's _pallas_stage, in numpy float32/float64)
# --------------------------------------------------------------------------

@dataclasses.dataclass
class _Block:
    w1: torch.Tensor
    q1: torch.Tensor
    w2: torch.Tensor
    e2: torch.Tensor
    sx: float
    last: bool
    trunc: bool
    w1p: torch.Tensor     # _pack_block(w1), _pack_block(w2): the kernel's B
    w2p: torch.Tensor


@dataclasses.dataclass
class _Plan:
    s_in: float
    ws: torch.Tensor
    stem_mode: str
    stem_table: torch.Tensor
    blocks: list
    out_int8: bool
    ws_pack: torch.Tensor     # _pack_stem(ws): the stem kernel's B


def _np32(v):
    return v.detach().float().cpu().numpy() if isinstance(v, torch.Tensor) \
        else np.asarray(v, np.float32)


def _fold(Ws, Bs, blocks, out_scale, device, requant="fxp", split=True):
    """Fold every requant scale on the host.  The arithmetic follows the
    reference step by step: float32 products with each Python scalar rounded
    to float32 once, then ``_fxp_pack`` in float64.  Biases arrive as the
    program passes them (bf16-rounded in a bf16 program), so the fxp B terms
    match the reference's.  ``requant`` and ``split`` are the module flags
    (module doc); a stage without blocks has one form whatever they say."""
    f32 = np.float32
    one_call = bool(blocks) and not split
    trunc = bool(blocks) and (requant == "trunc" or one_call)

    def bias(Bw):
        return (np.zeros((64,), np.float32) if Bw is None
                else _np32(Bw).reshape(-1)).reshape(64, 1)

    def wscale(W):
        return _np32(W.scale).reshape(64, 1)

    s_in = float(Ws.act_scale)
    inv0 = (1.0 / float(blocks[0][0].act_scale) if blocks
            else (1.0 / out_scale if out_scale else 1.0))
    f_s = wscale(Ws) * f32(s_in * inv0)
    b_s = bias(Bs) * f32(inv0) + f32(0.5 if (blocks or out_scale) else 0.0)

    def dev(a, dtype):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype,
                               device=device)

    def rows(f, b):
        return dev(np.stack([f.reshape(-1), b.reshape(-1)]), torch.float32)

    if blocks and not trunc:
        stem_mode, stem_table = "fxp", dev(_fxp_pack(f_s, b_s), torch.int32)
    else:
        stem_mode = "trunc" if (blocks or out_scale) else "bf16"
        stem_table = rows(f_s, b_s)
    plan_blocks = []
    for bi, (W1, B1, W2, B2) in enumerate(blocks):
        sx_in = float(W1.act_scale)
        s_mid = float(W2.act_scale)
        last = bi == len(blocks) - 1
        inv_out = ((1.0 / out_scale if out_scale else 1.0) if last
                   else 1.0 / float(blocks[bi + 1][0].act_scale))
        f1 = wscale(W1) * f32(sx_in / s_mid)
        b1 = bias(B1) / f32(s_mid) + f32(0.5)
        f2 = wscale(W2) * f32(s_mid * inv_out)
        quant_out = (not last) or bool(out_scale)
        b2 = bias(B2) * f32(inv_out) + f32(0.5 if quant_out else 0.0)
        sx = sx_in * inv_out
        # with out_scale the final block keeps the quantizing epilogue,
        # except in the one-call form, whose last plane is always bf16
        flast = last and (one_call or not out_scale)
        q1 = rows(f1, b1) if trunc else dev(_fxp_pack(f1, b1), torch.int32)
        e2 = (rows(f2, b2) if (flast or trunc)
              else dev(_fxp_pack(f2, b2, sx=sx), torch.int32))
        plan_blocks.append(_Block(W1.q, q1, W2.q, e2, sx, flast, trunc,
                                  _pack_block(W1.q), _pack_block(W2.q)))
    return _Plan(s_in, Ws.q, stem_mode, stem_table, plan_blocks,
                 bool(out_scale) and not one_call, _pack_stem(Ws.q))


def _run(x, plan, plain=False):
    xq = stem_prologue(x, plan.s_in)
    if plain:
        y = stem_pool_requant_plain(xq, plan.ws, plan.stem_table,
                                    plan.stem_mode)
        for b in plan.blocks:
            y = basic_block_plain(y, b.w1, b.q1, b.w2, b.e2, b.sx, b.last,
                                  b.trunc)
    else:
        y = stem_pool_requant(xq, plan.ws, plan.stem_table, plan.stem_mode,
                              wpack=plan.ws_pack)
        for b in plan.blocks:
            y = basic_block(y, b.w1, b.q1, b.w2, b.e2, b.sx, b.last,
                            b.trunc, w1p=b.w1p, w2p=b.w2p)
    return y if plan.out_int8 else y.to(x.dtype)


# --------------------------------------------------------------------------
# public op
# --------------------------------------------------------------------------

def decomposed(x, Ws, Bs, *bw):
    """Reference semantics: exactly the op chain the fusion pass replaced
    (conv7x7/2 + relu + maxpool3/2 + N x [conv-relu-conv-add-relu])."""
    from .. import torch_ops as tops
    y = tops.conv2d(x, Ws, Bs, strides=(2, 2), pads=(3, 3, 3, 3))
    y = tops.relu(y)
    y = tops.maxpool(y, w=(3, 3), pads=(1, 1, 1, 1), strides=(2, 2))
    for i in range(0, len(bw), 4):
        W1, B1, W2, B2 = bw[i:i + 4]
        r = y
        y = tops.relu(tops.conv2d(y, W1, B1, strides=(1, 1),
                                  pads=(1, 1, 1, 1)))
        y = tops.conv2d(y, W2, B2, strides=(1, 1), pads=(1, 1, 1, 1))
        y = tops.relu(tops.add(y, r))
    return y


def stage64(x, Ws, Bs, *bw, out_scale=None, force_decomposed=False,
            cache=None, plain=False):
    """Fused ResNet entry stage.  Positional inputs: x, stem W, stem B, then
    (W1, B1, W2, B2) per block.  ``out_scale`` makes the stage emit int8
    codes at that scale; the decomposed fallback and the one-call form
    (``SPLIT = False``) ignore it and emit float.  ``cache`` (a dict owned
    by the caller) keeps the folded tables between calls with the same
    weights.  ``plain`` runs the kernels' plain versions on any device —
    the reference a caller holds the kernels against, as the JAX package's
    ``interpret`` flag is; it never happens by itself."""
    if force_decomposed:
        return decomposed(x, Ws, Bs, *bw)
    if REQUANT not in ("fxp", "trunc"):
        raise ValueError(f"stage64: unknown REQUANT {REQUANT!r}")
    if _eligible(x, Ws, bw) is None:
        return decomposed(x, Ws, Bs, *bw)
    key = (out_scale, x.device, REQUANT, bool(SPLIT))
    plan = cache.get(key) if cache is not None else None
    if plan is None:
        blocks = [tuple(bw[i:i + 4]) for i in range(0, len(bw), 4)]
        plan = _fold(Ws, Bs, blocks, out_scale, x.device, REQUANT,
                     bool(SPLIT))
        if cache is not None:
            cache[key] = plan
    return _run(x, plan, plain)
