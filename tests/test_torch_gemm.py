"""The port's weight-only int8 GEMM (planer_tpu_torch/ops/kernels/gemm.py)
against the JAX package's (planer_tpu/ops/pallas/gemm.py) on the CPU.

The JAX side runs its Pallas kernel in interpret mode: ``gemm.dense_q(...,
interpret=True)`` for one call, and, for a whole program, ``gemm.dense_q``
patched to that (jax_ops looks it up at call time) with
``jax_ops._PALLAS_CONV1X1`` on.  Without that patch the reference never runs
its kernel off the TPU.  The port's wrapper runs the kernel's plain PyTorch
version on CPU tensors; chip_smoke.py holds the CUDA kernel against that
version on the card.

Tolerances: the kernel branch sums exact bf16 products in f32 in another
order than XLA, so the two agree within the f32 rounding of the sums:
max|d|/max|y| <= 1e-5 for f32 outputs.  For bf16 outputs that sum-order
difference can carry a value across one rounding boundary: at most one bf16
ulp of the product before the bias plus 1e-5 of the largest product, plus
one ulp of the result where a bias is added after the cast.  (The f32 term
matters where a sum cancels to near zero: on the H100 one element of a
no-bias (64, 512, 1024) product sat more than one ulp from the plain
version, at 1.7e-6 of the largest |product|.)
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from planer_tpu import models as jm
from planer_tpu.models import eval as jev
from planer_tpu.ops import jax_ops as jops
from planer_tpu.ops.pallas import gemm as jg
from planer_tpu.ops.qtypes import QTensor as JQ
from planer_tpu.quant import make_quant_program as j_program

import planer_tpu_torch as pt
from planer_tpu_torch.ops import torch_ops as tops
from planer_tpu_torch.ops import fp8
from planer_tpu_torch.ops.kernels import gemm as tg
from planer_tpu_torch.ops.qtypes import QTensor as TQ

MARGIN = 0.02          # bench.py's decisive-logit filter


# --------------------------------------------------------------- helpers

def _weights(rng, N, Kd):
    q = rng.integers(-127, 128, size=(N, Kd), dtype=np.int8)
    s = ((0.5 + rng.random((N, 1))) * 0.05 / 127.0).astype(np.float32)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    return q, s, b


def _both(q, s, b=None):
    """The same weights as a JAX and a port QTensor, and the bias."""
    jk = JQ(jnp.asarray(q), jnp.asarray(s))
    tk = TQ(torch.as_tensor(q), torch.as_tensor(s))
    return jk, tk, (None if b is None else jnp.asarray(b)), \
        (None if b is None else torch.as_tensor(b))


def _x(rng, shape, dtype):
    x = rng.standard_normal(shape).astype(np.float32)
    return jnp.asarray(x).astype(dtype), torch.as_tensor(x).to(
        getattr(torch, dtype))


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(jnp.asarray(v).astype(jnp.float32))


def _ulp(a):
    """One bf16 ulp of |a| (bf16 keeps 8 significant bits)."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -126))) - 7)


def _assert_close(out, ref, dtype, bias=None):
    """The module doc's bounds; returns the share of differing elements."""
    out, ref = _np(out), _np(ref)
    assert out.shape == ref.shape
    d = np.abs(out - ref)
    if dtype == "float32":
        assert d.max() / np.abs(ref).max() <= 1e-5
    else:
        pre = ref if bias is None else ref - _np(bias)
        bound = _ulp(pre) + 1e-5 * np.abs(pre).max() \
            + (0 if bias is None else _ulp(ref))
        assert (d <= bound).all(), float((d / bound).max())
    return float((d > 0).mean())


def _interpret(x, jk, jb):
    return jax.jit(lambda v: jg.dense_q(v, jk, jb, interpret=True))(x)


# ------------------------------------------------------------------ gate

def test_tile_plan_equals_reference():
    """The gate decides the numerics: equal to ``_tile_plan`` over a grid
    that crosses every edge (N or Kd off 128, M = 7 and 8, the VMEM
    budget)."""
    seen = set()
    for M in (1, 7, 8, 9, 100, 255, 256, 257, 50176):
        for N in (64, 100, 128, 256, 1000, 1024, 2048, 4096):
            for Kd in (64, 200, 128, 512, 2048, 8192, 16384):
                ref = jg._tile_plan(M, N, Kd)
                assert tg.tile_plan(M, N, Kd) == ref, (M, N, Kd)
                if ref is None:
                    seen.add("off" if (N % 128 or Kd % 128 or M < 8)
                             else "budget")
    assert seen == {"off", "budget"}
    assert tg.tile_plan(8, 128, 128) == (8, 128)
    assert tg.tile_plan(7, 128, 128) is None
    assert tg.tile_plan(256, 256, 8192) == (256, 256)
    assert tg.tile_plan(256, 256, 16384) is None


# ------------------------------------------------------------- op level

SHAPES = [(8, 128, 128), (32, 256, 384), (100, 128, 256), (256, 512, 128)]


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,Kd", SHAPES)
def test_dense_q_matches_interpret_run(M, N, Kd, dtype, bias):
    """The kernel branch (plain version on CPU tensors) against the JAX
    kernel in interpret mode, on the shapes of tests/test_pallas.py."""
    rng = np.random.default_rng(M + N + Kd)
    q, s, b = _weights(rng, N, Kd)
    jk, tk, jb, tb = _both(q, s, b if bias else None)
    jx, tx = _x(rng, (M, Kd), dtype)
    calls = []
    orig = tg.dense_q_plain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tg, "dense_q_plain",
                   lambda *a: calls.append(1) or orig(*a))
        out = tg.dense_q(tx, tk, tb)
    assert calls == [1] and out.dtype == tx.dtype
    ref = _interpret(jx, jk, jb)
    share = _assert_close(out, ref, dtype, tb)
    print(f"({M},{N},{Kd}) {dtype} bias={bias}: {share:.4f} of elements "
          f"differ")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leading_dims_and_matmul_q(dtype):
    """x with leading batch dimensions, and ``matmul_q`` on (Kd, N)-layout
    weights."""
    rng = np.random.default_rng(4)
    q, s, b = _weights(rng, 256, 128)
    jk, tk, jb, tb = _both(q, s, b)
    jx, tx = _x(rng, (2, 3, 4, 128), dtype)
    out = tg.dense_q(tx, tk, tb)
    assert out.shape == (2, 3, 4, 256)
    _assert_close(out, _interpret(jx, jk, jb), dtype, tb)
    jkt = JQ(jnp.asarray(q.T.copy()), jnp.asarray(s.reshape(1, -1)))
    tkt = TQ(torch.as_tensor(q.T.copy()), torch.as_tensor(s.reshape(1, -1)))
    out = tg.matmul_q(tx, tkt)
    ref = jax.jit(lambda v: jg.matmul_q(v, jkt, interpret=True))(jx)
    assert out.shape == ref.shape == (2, 3, 4, 256)
    _assert_close(out, ref, dtype)


FALLBACK = [(4, 128, 128), (7, 256, 128), (16, 1000, 512), (32, 128, 64),
            (2, 1000, 2048)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,Kd", FALLBACK)
def test_fallback_shapes_match_reference(M, N, Kd, dtype):
    """Shapes the gate refuses take ``_fallback_dense``'s numerics on both
    sides (the ResNet fc is (b, 1000, 2048)); the plain kernel branch is
    not run."""
    rng = np.random.default_rng(M * N + Kd)
    q, s, b = _weights(rng, N, Kd)
    jk, tk, jb, tb = _both(q, s, b)
    jx, tx = _x(rng, (M, Kd), dtype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tg, "dense_q_plain", None)
        out = tops.dense(tx, tk, tb)
    ref = jax.jit(lambda v: jg._fallback_dense(v, jk, jb))(jx)
    _assert_close(out, ref, dtype, tb)
    np.testing.assert_array_equal(_np(out), _np(tg.fallback_dense(tx, tk,
                                                                   tb)))


# --------------------------------------------------- the three numerics

# 1 + 3 * 2^-9: bf16 rounds it up, to 1 + 2^-7
S_UP = np.float32(1.005859375)


def _one_hot_weights(N, Kd, cols, scale):
    q = np.zeros((N, Kd), np.int8)
    for k, v in cols.items():
        q[:, k] = v
    return q, np.full((N, 1), scale, np.float32)


def test_kernel_branch_rounds_f32_x_to_bf16():
    """gemm.py:58: an f32 x is rounded to bf16 before the dot, even in an
    f32 program (1 + 2^-10 becomes 1)."""
    q, s = _one_hot_weights(128, 128, {0: 1}, 1.0)
    jk, tk, _, _ = _both(q, s)
    x = np.zeros((8, 128), np.float32)
    x[:, 0] = 1 + 2.0 ** -10
    out = tg.dense_q(torch.as_tensor(x), tk).numpy()
    ref = np.asarray(_interpret(jnp.asarray(x), jk, None))
    np.testing.assert_array_equal(out, ref)
    assert (out == 1.0).all()
    assert (tg.fallback_dense(torch.as_tensor(x), tk).numpy()
            == np.float32(1 + 2.0 ** -10)).all()


def test_kernel_branch_adds_bias_after_the_cast():
    """gemm.py:126-129: acc*scale is cast to x's dtype, then the bias is
    added in that dtype: bf16(1.005859375) = 1.0078125, + 2^-8 ties to
    1.015625; adding before the cast would give 1.0078125."""
    q, s = _one_hot_weights(128, 128, {0: 1}, S_UP)
    b = np.full(128, 2.0 ** -8, np.float32)
    jk, tk, jb, tb = _both(q, s, b)
    x = np.zeros((8, 128), np.float32)
    x[:, 0] = 1.0
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.as_tensor(x).to(
        torch.bfloat16)
    out = _np(tg.dense_q(tx, tk, tb))
    np.testing.assert_array_equal(out, _np(_interpret(jx, jk, jb)))
    assert (out == 1.015625).all()


def test_fallback_rounds_dequantized_weights_to_x_dtype():
    """gemm.py:34: the fallback casts q*scale to x's dtype before the dot:
    with q = (3, -2) and scale 1.005859375, bf16(3s) - bf16(2s) = 1.0,
    where the kernel branch gives bf16(1 * s) = 1.0078125."""
    q, s = _one_hot_weights(1000, 128, {0: 3, 1: -2}, S_UP)
    jk, tk, _, _ = _both(q, s)
    x = np.zeros((4, 128), np.float32)
    x[:, :2] = 1.0
    jx, tx = jnp.asarray(x).astype(jnp.bfloat16), torch.as_tensor(x).to(
        torch.bfloat16)
    out = _np(tops.dense(tx, tk))
    ref = _np(jax.jit(lambda v: jg.dense_q(v, jk))(jx))
    np.testing.assert_array_equal(out, ref)
    assert (out == 1.0).all()
    kern = _np(tg.dense_q_plain(tx, tk.q, tk.scale))
    assert (kern == 1.0078125).all()


# ------------------------------------------- kernel steps, copied in numpy
#
# csrc/gemm.cu runs only on the card.  These are numpy copies of its steps
# (decode, TMA swizzles, wgmma fragments and descriptors, the epilogue's
# staging and TMA store, the host tile plan) that must give known answers;
# a change of layout in the kernel goes with a change of these copies.

KBC, KBK = 128, 64     # csrc/gemm.cu: channels per tile, k per stage
R50_GEMMS = [(256, 128, 56), (512, 128, 28), (128, 512, 28), (512, 256, 28),
             (1024, 256, 14), (256, 1024, 14), (1024, 512, 14),
             (2048, 512, 7), (512, 2048, 7)]


def _byte_perm(a, b, sel):
    """CUDA's __byte_perm on uint32 values."""
    src = (np.asarray(b, np.uint64) << np.uint64(32)) \
        | np.asarray(a, np.uint64)
    out = np.zeros(np.broadcast(a, b).shape, np.uint64)
    for i in range(4):
        k = np.uint64(8 * ((sel >> (4 * i)) & 7))
        out |= ((src >> k) & np.uint64(0xFF)) << np.uint64(8 * i)
    return out.astype(np.uint32)


def _decode_int8(v):
    """decode2<W_INT8>: a byte pair (byte 0 low) -> bf16x2 bits."""
    u = v.astype(np.uint32) ^ np.uint32(0x8080)
    bias = np.float32(8388736.0)                       # 2^23 + 128
    f0 = _byte_perm(u, 0x4B000000, 0x7540).view(np.float32) - bias
    f1 = _byte_perm(u, 0x4B000000, 0x7541).view(np.float32) - bias
    return _byte_perm(f0.view(np.uint32), f1.view(np.uint32), 0x7632)


def _bf16_bits(f):
    """Round-to-nearest-even bf16 bits of float32 values."""
    b = np.asarray(f, np.float32).view(np.uint32).astype(np.uint64)
    b = (b + 0x7FFF + ((b >> 16) & 1)) >> 16
    return b.astype(np.uint32)


def _decode_e4m3(v):
    """decode2<W_E4M3>: cvt.rn.f16x2.e4m3x2 (each byte's sign, 4-bit
    exponent of bias 7, 3-bit mantissa, subnormal below exponent 1), f16 to
    f32, then __floats2bfloat162_rn (byte 0 -> the low half)."""
    def one(c):
        c = c.astype(np.int64)
        e, m = (c >> 3) & 15, c & 7
        val = np.where(e == 0, m * 2.0 ** -9, (1 + m / 8.0) * 2.0 ** (e - 7))
        val = np.where(c & 0x80, -val, val).astype(np.float16)
        return _bf16_bits(val.astype(np.float32))
    return one(v & 0xFF) | (one(v >> 8) << np.uint32(16))


def test_int8_decode_is_exact():
    """Every int8 value, in either byte of the pair, to the bf16 bits of the
    same integer (exact: |v| <= 128 needs 8 significant bits)."""
    b = np.arange(256, dtype=np.uint32)
    v = b | (b[::-1] << 8)                     # every byte in both positions
    got = _decode_int8(v)
    ints = b.astype(np.uint8).view(np.int8).astype(np.float32)
    want_lo = ints.view(np.uint32) >> 16
    want_hi = ints[::-1].view(np.uint32) >> 16
    assert (ints.view(np.uint32) & 0xFFFF == 0).all()      # exact in bf16
    np.testing.assert_array_equal(got & 0xFFFF, want_lo)
    np.testing.assert_array_equal(got >> 16, want_hi)
    t = torch.as_tensor(ints).to(torch.bfloat16).view(torch.int16)
    np.testing.assert_array_equal(want_lo, t.numpy().view(np.uint16))


def test_e4m3_decode_is_exact():
    """The 254 finite e4m3 codes, in either byte of the pair, to the bf16
    bits of the host codec's decoded values."""
    codes = np.array([c for c in range(256) if c & 0x7F != 0x7F], np.uint32)
    assert codes.size == 254
    got = _decode_e4m3(codes | (codes[::-1] << 8))
    dec = fp8.decode(codes.astype(np.uint8)).astype(np.float32)
    assert (dec.view(np.uint32) & 0xFFFF == 0).all()       # exact in bf16
    np.testing.assert_array_equal(got & 0xFFFF, dec.view(np.uint32) >> 16)
    np.testing.assert_array_equal(got >> 16,
                                  dec[::-1].view(np.uint32) >> 16)


def _sw128(off):
    """TMA's 128-byte swizzle (and wgmma's) of byte offsets in a 1024-byte
    aligned tile: 16-byte chunk bits 4-6 XOR bits 7-9."""
    return off ^ (((off >> 7) & 7) << 4)


def _sw64(off):
    """TMA's 64-byte swizzle: bits 4-5 XOR bits 7-8."""
    return off ^ (((off >> 7) & 3) << 4)


def _emulate(xb, qv, s, b, odt, bp):
    """dense_q_kernel<bp, odt> step by step on numpy arrays: xb (M, Kd)
    bf16 values as f32, qv (N, Kd) the decoded weights, s (N,), b (N,) in
    the output dtype or None.  Returns the output and how often each
    element was stored."""
    M, Kd = xb.shape
    N = qv.shape[0]
    es = 2 if odt == torch.bfloat16 else 4
    piece_ch = 128 // es
    tiles_n = N // KBC
    out = np.zeros((M, N), np.float32)
    stored = np.zeros((M, N), np.int64)
    lane = np.arange(32)
    g, t = lane >> 2, lane & 3
    for tile in range(-(-M // bp) * tiles_n):
        m0, n0 = (tile // tiles_n) * bp, (tile % tiles_n) * KBC
        acc = np.zeros((KBC, bp), np.float64)            # (channels, pixels)
        for kt in range(Kd // KBK):
            k0 = kt * KBK
            # the producer's TMA loads: x rows past M are zeros
            xs = np.zeros(bp * 128 // 2, np.float32)     # bf16 slots
            for r in range(min(bp, M - m0)):
                for c in range(8):
                    o = _sw128(r * 128 + 16 * c) // 2
                    xs[o:o + 8] = xb[m0 + r, k0 + 8 * c:k0 + 8 * c + 8]
            ws = np.zeros(KBC * KBK, np.float32)         # one byte a weight
            for r in range(KBC):
                for c in range(4):
                    o = _sw64(r * 64 + 16 * c)
                    ws[o:o + 16] = qv[n0 + r, k0 + 16 * c:k0 + 16 * c + 16]
            for wg in range(2):
                # A fragments read as consume() reads them
                A = np.full((4, 64, 16), np.nan)
                for w in range(4):
                    r0 = 64 * wg + 16 * w + g
                    wrow = r0 * KBK + 2 * t
                    for st in range(4):
                        c0 = wrow + ((st ^ ((r0 >> 1) & 3)) << 4)
                        c1 = c0 + 8 * KBK
                        for addr, dr, dk in ((c0, 0, 0), (c1, 8, 0),
                                             (c0 + 8, 0, 8), (c1 + 8, 8, 8)):
                            rows, ks = 16 * w + g + dr, 2 * t + dk
                            assert np.isnan(A[st, rows, ks]).all()
                            A[st, rows, ks] = ws[addr]       # byte 0: low k
                            A[st, rows, ks + 1] = ws[addr + 1]
                assert not np.isnan(A).any()
                # B through the descriptor: start + 32 bytes per k16 step,
                # 1024 bytes per 8 pixel rows, 128 per row, swizzled
                n = np.arange(bp)[None, :]
                for st in range(4):
                    k = np.arange(16)[:, None]
                    addr = 32 * st + (n // 8) * 1024 + (n % 8) * 128 + 2 * k
                    B = xs[_sw128(addr) // 2]
                    acc[64 * wg:64 * wg + 64] += A[st].astype(np.float64) @ B
        acc32 = acc.astype(np.float32)
        # epilogue: each thread's accumulator fragment, scaled, cast, plus
        # bias, put into the swizzled staging pieces
        stage = np.full(bp * KBC, np.nan, np.float32)
        for wg in range(2):
            for w in range(4):
                r0 = 64 * wg + 16 * w + g
                for j in range(bp // 8):
                    p = 8 * j + 2 * t
                    for i, (pp, cc) in enumerate(((p, r0), (p + 1, r0),
                                                  (p, r0 + 8),
                                                  (p + 1, r0 + 8))):
                        # the wgmma D layout of acc[4 j + i]
                        row = 16 * w + g + 8 * (i // 2) + 64 * wg
                        col = 8 * j + 2 * t + (i % 2)
                        assert (row == cc).all() and (col == pp).all()
                        y = torch.as_tensor(acc32[row, col]
                                            * s[n0 + cc]).to(odt)
                        if b is not None:
                            y = (y.float() + torch.as_tensor(
                                b[n0 + cc]).to(odt).float()).to(odt)
                        byte = (cc % piece_ch) * es
                        o = (cc // piece_ch) * (bp * 128) + pp * 128 \
                            + (byte ^ ((pp & 7) << 4))
                        assert np.isnan(stage[o // es]).all()
                        stage[o // es] = y.float().numpy()
        assert not np.isnan(stage).any()
        # the TMA stores: one per piece, rows past M clipped
        for h in range(KBC // piece_ch):
            for r in range(min(bp, M - m0)):
                for c in range(8):
                    o = h * bp * 128 + _sw128(r * 128 + 16 * c)
                    col = n0 + h * piece_ch + c * (16 // es)
                    out[m0 + r, col:col + 16 // es] = \
                        stage[o // es:o // es + 16 // es]
                    stored[m0 + r, col:col + 16 // es] += 1
    return out, stored


@pytest.mark.parametrize("M,N,Kd,dtype,bias,bp", [
    (200, 256, 256, "bfloat16", True, 64),
    (130, 128, 128, "float32", True, 128),
    (77, 256, 128, "bfloat16", False, 128)])
def test_kernel_layouts_give_plain_result(M, N, Kd, dtype, bias, bp):
    """The swizzled TMA tiles, the A fragments read from the weight tile, the
    B descriptor walk, the accumulator fragments, the staging swizzle and
    the TMA stores together give dense_q_plain's (M, N) result at a ragged
    M, every element stored once."""
    rng = np.random.default_rng(M + bp)
    q, s, b = _weights(rng, N, Kd)
    x = rng.standard_normal((M, Kd)).astype(np.float32)
    tx = torch.as_tensor(x).to(getattr(torch, dtype))
    odt = tx.dtype
    tb = torch.as_tensor(b).to(odt) if bias else None
    xb = tx.to(torch.bfloat16).float().numpy()
    out, stored = _emulate(xb, q.astype(np.float32), s.reshape(-1),
                           b if bias else None, odt, bp)
    assert (stored == 1).all()
    ref = tg.dense_q_plain(tx, torch.as_tensor(q), torch.as_tensor(s), tb)
    _assert_close(torch.as_tensor(out).to(odt), ref, dtype, tb)


@pytest.mark.parametrize("batch", [1, 64])
def test_kernel_plan_covers_path4_shapes(batch):
    """kernel_plan (the copy of csrc/gemm.cu's make_plan) at path 4's nine
    shapes: tiles cover M, N and Kd exactly once, every tile goes to one
    block of the persistent grid, and at batch 64 there are at least 132
    tiles (one full wave on the H100) with no K split."""
    want64 = [(128, 1568), (128, 392), (128, 1568), (128, 784), (128, 196),
              (128, 784), (128, 392), (64, 196), (128, 400)]
    got = []
    for kd, n, side in R50_GEMMS:
        M = batch * side * side
        assert tg.tile_plan(M, n, kd) is not None
        bp, tiles, grid = tg.kernel_plan(M, n, kd)
        got.append((bp, tiles))
        tiles_n, tiles_m = n // KBC, -(-M // bp)
        assert tiles == tiles_m * tiles_n and grid == min(tiles, 132)
        ids = np.arange(tiles)
        m0, n0 = (ids // tiles_n) * bp, (ids % tiles_n) * KBC
        assert len(set(zip(m0.tolist(), n0.tolist()))) == tiles
        assert m0.max() < M <= m0.max() + bp and n0.max() + KBC == n
        rows = np.zeros(tiles_m * bp, np.int64)
        for a in np.unique(m0):
            rows[a:a + bp] += 1
        assert (rows[:M] == 1).all()
        # block b takes tiles b, b + grid, ...: each tile once
        owner = np.concatenate([np.arange(blk, tiles, grid)
                                for blk in range(grid)])
        assert np.array_equal(np.sort(owner), ids)
        # K: whole stages of 64, an even count (the double-buffered loop)
        assert kd % KBK == 0 and (kd // KBK) % 2 == 0
        if batch == 64:
            assert tiles >= 132
    if batch == 64:
        assert got == want64


def test_kernel_plan_wide_and_narrow():
    """Where 128-pixel tiles would leave SMs idle the plan takes 64; the
    SM count is a parameter (the C side reads the card's)."""
    assert tg.kernel_plan(3136, 512, 2048) == (64, 196, 132)
    assert tg.kernel_plan(3136, 512, 2048, sms=64) == (128, 100, 64)
    assert tg.kernel_plan(8, 128, 128) == (64, 1, 1)
    assert tg.kernel_plan(16896, 128, 128) == (128, 132, 132)
    assert tg.kernel_plan(16895, 128, 128) == (128, 132, 132)
    assert tg.kernel_plan(16768, 128, 128) == (64, 262, 132)


# ------------------------------------------------------------- conv route

CONV_CASES = {
    # name: (x shape, out channels, strides, pads, route target)
    "tile": ((2, 128, 8, 8), 256, (1, 1), (0, 0, 0, 0), "kernel"),
    "kd64": ((2, 64, 8, 8), 256, (1, 1), (0, 0, 0, 0), "fallback"),
    "strided": ((2, 128, 8, 8), 256, (2, 2), (0, 0, 0, 0), "conv"),
    "padded": ((2, 128, 8, 8), 256, (1, 1), (1, 1, 1, 1), "conv"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_conv1x1_route_matches_reference(case, dtype, monkeypatch):
    """conv2d with the 1x1 route on both sides: a tiling 1x1 conv takes the
    kernel branch, a Kd = 64 one the fallback GEMM (never a conv), strided
    and padded ones the ordinary conv."""
    shape, o, strides, pads, target = CONV_CASES[case]
    rng = np.random.default_rng(len(case))
    q, s, b = _weights(rng, o, shape[1])
    q, s = q.reshape(o, shape[1], 1, 1), s.reshape(o, 1, 1, 1)
    jk, tk, jb, tb = _both(q, s, b)
    jx, tx = _x(rng, shape, dtype)
    monkeypatch.setattr(jops, "_PALLAS_CONV1X1", True)
    monkeypatch.setattr(jg, "dense_q", functools.partial(jg.dense_q,
                                                         interpret=True))
    monkeypatch.setattr(tops, "_PALLAS_CONV1X1", True)
    seen = []
    for name in ("dense_q_plain", "fallback_dense"):
        f = getattr(tg, name)
        monkeypatch.setattr(tg, name, lambda *a, _f=f, _n=name:
                            seen.append(_n) or _f(*a))
    conv = torch.nn.functional.conv2d
    monkeypatch.setattr(torch.nn.functional, "conv2d",
                        lambda *a, **k: seen.append("conv") or conv(*a, **k))
    out = tops.conv2d(tx, tk, tb, strides=strides, pads=pads)
    want = {"kernel": "dense_q_plain", "fallback": "fallback_dense",
            "conv": "conv"}[target]
    assert seen == [want]
    ref = jax.jit(lambda v: jops.conv2d(v, jk, jb, strides=strides,
                                        pads=pads))(jx)
    assert tuple(out.shape) == ref.shape and out.dtype == tx.dtype
    if target == "conv":      # XLA's conv against torch's: another sum order
        d = np.abs(_np(out) - _np(ref)).max() / np.abs(_np(ref)).max()
        assert d <= (1e-5 if dtype == "float32" else 2.0 ** -7)
    else:
        _assert_close(out, ref, dtype, tb.reshape(1, -1, 1, 1))


# ------------------------------------------------------------ whole slice

SIZE = 64


@pytest.fixture(scope="module")
def wo_net():
    """Weight-only INT8 ResNet-50 built by the JAX package: optimized and
    ``quantize("int8")`` with no activation scales."""
    net = jm.resnet50()
    net.optimize()
    net.quantize("int8")
    return net


def test_weight_only_resnet50_matches_reference(wo_net, monkeypatch):
    """Weight-only INT8 ResNet-50 at full width and depth, 64x64, b2, bf16
    compute, with the 1x1 route on both sides: all 26 routed convs of
    layers 2-4 tile (M = 512, 128, 32 and 8) and take the kernel branch —
    the JAX side's in interpret mode — layer1's seven 1x1 convs (Kd or
    N = 64) and the fc (N = 1000) the fallback.  Measured: p99 rel
    0.0051 (bound 0.02)."""
    xs = next(jev.synthetic_images(2, (3, SIZE, SIZE), seed=31, batch=2))
    monkeypatch.setattr(jops, "_PALLAS_CONV1X1", True)
    jcalls = []
    jdense = jg.dense_q

    def jspy(x, K, B=None, **kw):
        n, kd = K.q.shape
        jcalls.append(jg._tile_plan(x.size // kd, n, kd) is not None)
        return jdense(x, K, B, interpret=True)
    monkeypatch.setattr(jg, "dense_q", jspy)
    prog = j_program(wo_net.graph, wo_net.weights, compute_dtype="bfloat16")
    yj = np.asarray(prog(xs))
    assert sum(jcalls) == 26 and len(jcalls) == 26 + 8
    monkeypatch.setattr(tops, "_PALLAS_CONV1X1", True)
    seen = []
    for name in ("dense_q_plain", "fallback_dense"):
        f = getattr(tg, name)
        monkeypatch.setattr(tg, name, lambda *a, _f=f, _n=name:
                            seen.append(_n) or _f(*a))
    tnet = pt.net_from_arrays(wo_net.graph.to_json_dict(), wo_net.weights,
                              device="cpu", compute_dtype="bfloat16")
    yt = tnet(xs)
    assert seen.count("dense_q_plain") == 26
    assert seen.count("fallback_dense") == 8
    assert yt.dtype == np.float32 and yt.shape == yj.shape == (2, 1000)
    assert np.isfinite(yt).all()
    rels = np.abs(yt - yj).max(1) / (np.abs(yj).max(1) + 1e-9)
    p99 = float(np.percentile(rels, 99))
    srt = np.sort(yj, axis=1)
    keep = (srt[:, -1] - srt[:, -2]) / (np.abs(yj).max(1) + 1e-9) >= MARGIN
    print(f"weight-only resnet50 bf16 logits: p99 rel {p99:.3g}, "
          f"{int(keep.sum())} decisive images")
    assert p99 <= 0.02
    assert (yt.argmax(1) == yj.argmax(1))[keep].all()


def test_route_off_keeps_convs(wo_net, monkeypatch):
    """With the flag off (the default) no conv reaches dense_q: only the fc
    does, through the fallback."""
    seen = []
    monkeypatch.setattr(tg, "dense_q", lambda *a, _f=tg.dense_q, **k:
                        seen.append(a[1].q.shape) or _f(*a, **k))
    tnet = pt.net_from_arrays(wo_net.graph.to_json_dict(), wo_net.weights,
                              device="cpu", compute_dtype="bfloat16")
    xs = next(jev.synthetic_images(1, (3, SIZE, SIZE), seed=32, batch=1))
    assert tnet(xs).shape == (1, 1000)
    assert seen == [(1000, 2048)]
