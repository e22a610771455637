"""The port's fused entry stage (planer_tpu_torch/ops/kernels/stage64.py)
against the JAX package's Pallas kernels run in interpret mode.

The reference runs under ``jax.jit`` with the scales and biases as host
constants, as the JAX package's quantized program runs it (there XLA
compiles the prologue's division by the constant input scale into a
multiply by its float32 reciprocal, which the port reproduces).

On the CPU the port's wrappers run the kernels' plain PyTorch versions, which
carry the same integer arithmetic as the CUDA kernels; chip_smoke.py holds the
kernels against those versions on the card.  Inputs are random QTensors made
with numpy, as in tests/test_stage64.py.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from planer_tpu.ops.qtypes import QTensor as JQ
from planer_tpu.ops.pallas import stage64 as jst

from planer_tpu_torch.ops.qtypes import QTensor as TQ
from planer_tpu_torch.ops.kernels import stage64 as tst

BF16_EPS = 2.0 ** -8     # bf16 keeps 8 significant bits


def _fma_bound(ref):
    """What contracting the f32 epilogue into FMAs can move a bf16 result:
    one bf16 ulp of the result, plus float32 rounding of the terms, which
    are at most the plane's magnitude (cancellation leaves tiny results)."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    return ulp + 2.0 ** -20 * np.abs(ref).max()


def _rand_q(rng, shape, act_scale):
    q = rng.integers(-127, 128, size=shape, dtype=np.int8)
    scale = (0.5 + rng.random((shape[0], 1, 1, 1))).astype(np.float32) / 256.0
    return q, scale, float(act_scale)


def _inputs(rng, size, batch):
    """numpy stage inputs: x, stem (q, scale, act), stem bias, and per block
    ((q, scale, act), bias, (q, scale, act), bias)."""
    x = rng.standard_normal((batch, 3, size, size)).astype(np.float32)
    ws = _rand_q(rng, (64, 3, 7, 7), np.abs(x).max() / 127.0)
    bs = rng.standard_normal(64).astype(np.float32) * 0.1
    blocks = []
    for a1, a2 in ((0.9, 0.8), (0.7, 0.6)):
        blocks.append((_rand_q(rng, (64, 64, 3, 3), a1),
                       rng.standard_normal(64).astype(np.float32) * 0.1,
                       _rand_q(rng, (64, 64, 3, 3), a2),
                       rng.standard_normal(64).astype(np.float32) * 0.1))
    return x, ws, bs, blocks


def _jax_args(ws, bs, blocks):
    """Reference args as the quantized program materializes them: int8
    payloads as arrays, scales and biases as host numpy constants."""
    jq = lambda w: JQ(jnp.asarray(w[0]), w[1], act_dynamic=True,
                      act_scale=w[2])
    bw = []
    for w1, b1, w2, b2 in blocks:
        bw += [jq(w1), b1, jq(w2), b2]
    return [jq(ws), bs] + bw


def _torch_args(ws, bs, blocks):
    tq = lambda w: TQ(torch.as_tensor(w[0]), torch.as_tensor(w[1]),
                      act_dynamic=True, act_scale=w[2])
    bw = []
    for w1, b1, w2, b2 in blocks:
        bw += [tq(w1), torch.as_tensor(b1), tq(w2), torch.as_tensor(b2)]
    return [tq(ws), torch.as_tensor(bs)] + bw


def _run_both(x, ws, bs, blocks, out_scale=None, dtype="float32"):
    args = _jax_args(ws, bs, blocks)
    ref = jax.jit(lambda v: jst.stage64(v, *args, out_scale=out_scale,
                                        interpret=True))(
        jnp.asarray(x).astype(dtype))
    out = tst.stage64(torch.as_tensor(x).to(getattr(torch, dtype)),
                      *_torch_args(ws, bs, blocks), out_scale=out_scale)
    return np.asarray(ref.astype(jnp.float32)), out.float().numpy(), \
        out.dtype, ref.dtype


CASES = [(64, 1, "float32"), (64, 2, "float32"), (96, 1, "float32"),
         (96, 2, "bfloat16")]


@pytest.mark.parametrize("size,batch,dtype", CASES)
def test_int8_chain_bit_exact(size, batch, dtype):
    """With out_scale every plane is an fxp int8 plane: bit-exact."""
    rng = np.random.default_rng(7 + size + batch)
    x, ws, bs, blocks = _inputs(rng, size, batch)
    ref, out, odt, rdt = _run_both(x, ws, bs, blocks, out_scale=0.11,
                                   dtype=dtype)
    assert odt == torch.int8 and rdt == jnp.int8
    assert out.shape == ref.shape == (batch, 64, size // 4, size // 4)
    assert 0 < (out != 0).mean() < 1          # a plane with real content
    np.testing.assert_array_equal(out, ref)


@pytest.mark.parametrize("size,batch,dtype", CASES)
def test_bf16_last_plane_within_one_ulp(size, batch, dtype):
    """Without out_scale the last block emits exact f32 -> bf16; the only
    allowed difference is FMA contraction in the reference's f32 epilogue:
    one bf16 ulp per element (more only where the terms cancel), and
    max|d| / max|ref| <= 2^-8."""
    rng = np.random.default_rng(11 + size + batch)
    x, ws, bs, blocks = _inputs(rng, size, batch)
    ref, out, odt, rdt = _run_both(x, ws, bs, blocks, dtype=dtype)
    assert odt == getattr(torch, dtype) and str(rdt) == dtype
    diff = np.abs(out - ref)
    assert (diff <= _fma_bound(ref)).all()
    rel = diff.max() / np.abs(ref).max()
    print(f"bf16 plane: max rel {rel:.3g}, "
          f"{int((diff > 0).sum())} of {diff.size} elements differ")
    assert rel <= BF16_EPS


@pytest.mark.parametrize("out_scale", [None, 0.05])
def test_stem_only_stage(out_scale):
    """The 0-block stage (ResNet-50's stem) uses the f32 epilogue
    acc*f + b, not fxp: bf16 out within one ulp, or, with out_scale, int8
    codes by truncation.  The port rounds the product and then the sum, as
    the kernel's arithmetic reads; the reference in interpret mode may
    contract them into one FMA.  So every int8 code must match, except where
    the FMA-rounded value truncates to the other integer — and there the
    reference must equal exactly the FMA result."""
    rng = np.random.default_rng(5)
    x, ws, bs, _ = _inputs(rng, 64, 2)
    ref, out, odt, _ = _run_both(x, ws, bs, [], out_scale=out_scale)
    if not out_scale:
        assert (np.abs(out - ref) <= _fma_bound(ref)).all()
        return
    assert odt == torch.int8
    args = _torch_args(ws, bs, [])
    plan = tst._fold(args[0], args[1], [], out_scale, torch.device("cpu"))
    xq = tst.stem_prologue(torch.as_tensor(x), plan.s_in)
    acc = tst.conv_s8(xq, args[0].q, (2, 2), (3, 3, 3, 3))
    pooled = tst._window_max(acc, 3, 3, 2, 2, (1, 1, 1, 1), tst._NEG).numpy()
    f = plan.stem_table[0].numpy().reshape(1, -1, 1, 1)
    b = plan.stem_table[1].numpy().reshape(1, -1, 1, 1)
    fused = (pooled.astype(np.float64) * f + b).astype(np.float32)
    fma_codes = np.clip(fused, 0.0, np.float32(127.99)).astype(np.int8)
    diff = out != ref
    print(f"stem-only trunc: {int(diff.sum())} of {diff.size} codes differ "
          f"by FMA contraction")
    assert diff.mean() < 1e-3
    np.testing.assert_array_equal(ref[diff], fma_codes[diff])
    assert (np.abs(out - ref) <= 1).all()


def test_fxp_pack_matches_reference():
    rng = np.random.default_rng(3)
    for sx in (0.0, 0.37, 1.9):
        f = ((0.5 + rng.random(64)) / 256.0 * rng.uniform(0.1, 3.0)
             ).astype(np.float32)
        b = (rng.standard_normal(64) * rng.uniform(0.1, 50.0)
             ).astype(np.float32)
        np.testing.assert_array_equal(tst._fxp_pack(f, b, sx=sx),
                                      np.asarray(jst._fxp_pack(f, b, sx=sx)))


@pytest.mark.parametrize("size,batch,dtype", CASES[:2])
def test_fxp_int32_headroom(size, batch, dtype):
    """Every fxp table folded for the test stages keeps the int32 epilogue
    clear of overflow at the worst-case accumulator (|acc| <= 127^2 * K)."""
    rng = np.random.default_rng(7 + size + batch)
    x, ws, bs, blocks = _inputs(rng, size, batch)
    args = _torch_args(ws, bs, blocks)
    bw = [tuple(args[2 + i:6 + i]) for i in range(0, len(args) - 2, 4)]
    for out_scale in (None, 0.11):
        plan = tst._fold(args[0], args[1], bw, out_scale, torch.device("cpu"))
        tables = [(plan.stem_table, 147)]
        tables += [(b.q1, 576) for b in plan.blocks]
        tables += [(b.e2, 576) for b in plan.blocks if not b.last]
        for tab, k in tables:
            m, B, s, mr = (tab[:, i].long() for i in range(4))
            worst = 127 * 127 * k * m.abs() + B.abs() + 127 * mr.abs()
            assert (m.abs() * 127 * 127 * k <= 2 ** 30).all()
            assert (B.abs() <= 2 ** 28).all() and (127 * mr.abs() <= 2 ** 29).all()
            assert (worst < 2 ** 31).all() and (s >= 0).all()


def test_falloff_and_geometry_match_reference():
    """The port fuses at exactly the reference's geometries; an ineligible
    input falls back to the decomposed chain and is counted."""
    for H in range(16, 420, 4):
        g = jst._geometry(H)
        assert tst._geometry(H) == (None if g is None else g.R), H
    rng = np.random.default_rng(3)
    x, ws, bs, blocks = _inputs(rng, 64, 1)
    x = rng.standard_normal((1, 3, 50, 50)).astype(np.float32)
    tst.FALLOFF.clear()
    y = tst.stage64(torch.as_tensor(x), *_torch_args(ws, bs, blocks))
    assert y.shape == (1, 64, 13, 13) and y.dtype == torch.float32
    assert sum(tst.FALLOFF.values()) == 1 and tst.FALLOFF["geometry"] == 1
    tst.FALLOFF.clear()


# ------------------------------------- the REQUANT="trunc" and one-call forms

def _fma_affine(acc, f, b):
    """acc*f + b with one rounding, as an FMA computes it (the product is
    exact in float64)."""
    return (acc.double() * f.double().reshape(1, -1, 1, 1)
            + b.double().reshape(1, -1, 1, 1)).float()


def _fma_block_sum(acc, f, b, res, sx):
    """fma(res, sx, fma(acc, f, b)): the block sum as the interpret run
    contracts it."""
    t = _fma_affine(acc, f, b).double()
    return (t + res.double() * float(np.float32(sx))).float()


def _set_flags(mp, split, requant):
    for mod in (jst, tst):
        mp.setattr(mod, "SPLIT", split)
        mp.setattr(mod, "REQUANT", requant)


def _port(x, ws, bs, blocks, out_scale, dtype, fma=False):
    """The port's stage (plain versions on the CPU); with ``fma`` the
    epilogues contracted as the interpret run contracts them."""
    with pytest.MonkeyPatch.context() as mp:
        if fma:
            mp.setattr(tst, "_affine", _fma_affine)
            mp.setattr(tst, "_block_sum", _fma_block_sum)
        out = tst.stage64(torch.as_tensor(x).to(getattr(torch, dtype)),
                          *_torch_args(ws, bs, blocks), out_scale=out_scale)
    return out.float().numpy(), out.dtype


def _check_against_reference(x, ws, bs, blocks, out_scale, dtype, label):
    """int8 planes bit-exact and the bf16 last plane within one bf16 ulp of
    the interpret run once the port replays its FMA contractions; the
    port's own arithmetic (product and sum rounded apart, the CUDA kernel's)
    is printed beside it.  Returns the output dtype."""
    args = _jax_args(ws, bs, blocks)
    ref = jax.jit(lambda v: jst.stage64(v, *args, out_scale=out_scale,
                                        interpret=True))(
        jnp.asarray(x).astype(dtype))
    ref = np.asarray(ref.astype(jnp.float32))
    out, odt = _port(x, ws, bs, blocks, out_scale, dtype)
    rep, _ = _port(x, ws, bs, blocks, out_scale, dtype, fma=True)
    assert out.shape == ref.shape == (x.shape[0], 64, x.shape[2] // 4,
                                      x.shape[3] // 4)
    if odt == torch.int8:
        np.testing.assert_array_equal(rep, ref)
        assert 0 < (ref != 0).mean() < 1
    else:
        assert (np.abs(rep - ref) <= _fma_bound(ref)).all()
        assert (ref > 0).mean() > 0.2
    print(f"{label}: {int((out != ref).sum())} of {ref.size} elements differ "
          f"without the FMA replay, {int((rep != ref).sum())} with it")
    return odt


@pytest.mark.parametrize("out_scale", [None, 0.11])
@pytest.mark.parametrize("size,batch,dtype", [CASES[1], CASES[3]])
def test_trunc_form_matches_interpret_run(size, batch, dtype, out_scale,
                                          monkeypatch):
    """REQUANT = "trunc": trunc stem, trunc blocks (stage64.py:627-629,
    :644-648) and, without out_scale, the exact-f32 bf16 last plane."""
    _set_flags(monkeypatch, True, "trunc")
    rng = np.random.default_rng(13 + size + batch)
    x, ws, bs, blocks = _inputs(rng, size, batch)
    odt = _check_against_reference(x, ws, bs, blocks, out_scale, dtype,
                                   f"trunc out_scale={out_scale}")
    assert odt == (torch.int8 if out_scale else getattr(torch, dtype))


@pytest.mark.parametrize("out_scale", [None, 0.11])
@pytest.mark.parametrize("size,batch,dtype", [CASES[1], CASES[3]])
def test_one_call_form_matches_interpret_run(size, batch, dtype, out_scale,
                                             monkeypatch):
    """SPLIT = False: the reference's one-call kernel, which ignores
    out_scale for the output (bf16, cast to x's dtype) but folds the last
    block's tables with it; the port runs the same function as its trunc
    chain."""
    _set_flags(monkeypatch, False, "fxp")
    rng = np.random.default_rng(17 + size + batch)
    x, ws, bs, blocks = _inputs(rng, size, batch)
    odt = _check_against_reference(x, ws, bs, blocks, out_scale, dtype,
                                   f"one-call out_scale={out_scale}")
    assert odt == getattr(torch, dtype)


@pytest.mark.parametrize("requant", ["fxp", "trunc"])
def test_reference_one_call_equals_split_trunc(requant, monkeypatch):
    """On the JAX side the one-call kernel and the split trunc chain compute
    the same function without out_scale, bit for bit (whatever REQUANT says:
    the one-call kernel has trunc epilogues only); with out_scale they part
    (bf16 in the out_scale code domain vs int8 codes)."""
    rng = np.random.default_rng(19)
    x, ws, bs, blocks = _inputs(rng, 64, 2)
    args = _jax_args(ws, bs, blocks)
    outs = {}
    for split, rq in ((False, requant), (True, "trunc")):
        for out_scale in (None, 0.11):
            _set_flags(monkeypatch, split, rq)
            y = jax.jit(lambda v: jst.stage64(v, *args, out_scale=out_scale,
                                              interpret=True))(jnp.asarray(x))
            outs[split, out_scale] = np.asarray(y.astype(jnp.float32)), y.dtype
    (mega, mdt), (split, sdt) = outs[False, None], outs[True, None]
    assert mdt == sdt == jnp.float32
    np.testing.assert_array_equal(mega, split)
    (mega_q, mqdt), (split_q, sqdt) = outs[False, 0.11], outs[True, 0.11]
    assert mqdt == jnp.float32 and sqdt == jnp.int8
    # the one-call output is the unclipped plane in out_scale's code domain
    # (+0.5 folded for truncation), rounded to bf16: the split chain's codes
    # are its floor, clipped at 127
    low = mega_q < 127
    print(f"one-call with out_scale: max {mega_q.max()}, "
          f"{float((~low).mean()):.3f} of elements >= 127")
    assert np.abs(mega_q - 0.5 - split_q)[low].max() <= 0.75
    assert (split_q[mega_q >= 128] == 127).all() and (~low).any()


def test_trunc_block_wrapper_tables(monkeypatch):
    """The trunc block takes f32 (2, 64) tables for both requants; the
    wrapper refuses fxp tables in that form and counts nothing on the
    CPU."""
    _set_flags(monkeypatch, True, "trunc")
    rng = np.random.default_rng(23)
    x, ws, bs, blocks = _inputs(rng, 64, 1)
    args = _torch_args(ws, bs, blocks)
    bw = [tuple(args[2 + i:6 + i]) for i in range(0, len(args) - 2, 4)]
    plan = tst._fold(args[0], args[1], bw, None, torch.device("cpu"),
                     "trunc", True)
    assert plan.stem_mode == "trunc"
    b0, b1 = plan.blocks
    assert (b0.trunc, b0.last, b1.trunc, b1.last) == (True, False, True, True)
    for t in (b0.q1, b0.e2, b1.q1, b1.e2):
        assert t.dtype == torch.float32 and tuple(t.shape) == (2, 64)
    y = torch.as_tensor(rng.integers(0, 128, (1, 64, 16, 16), dtype=np.int8))
    tst.LAUNCHES.clear()
    out = tst.basic_block(y, b0.w1, b0.q1, b0.w2, b0.e2, b0.sx, False, True)
    assert torch.equal(out, tst.basic_block_plain(
        y, b0.w1, b0.q1, b0.w2, b0.e2, b0.sx, False, True))
    assert out.dtype == torch.int8 and not tst.LAUNCHES
    fxp = tst._fold(args[0], args[1], bw, None, torch.device("cpu"))
    with pytest.raises(TypeError):
        tst.basic_block(y, b0.w1, fxp.blocks[0].q1, b0.w2, b0.e2, b0.sx,
                        False, True)


# ------------------------------ the kernels' operand packing and indexing
#
# numpy copies of csrc/stage64.cu's shared-memory layouts and of the
# mma.sync m16n8k32 fragments its ldmatrix loads hold (A word h of row
# g + 8*(h % 2) at byte 16*(h // 2) + 4*t4 of the k-step, B word j of
# column g at byte 16*j + 4*t4), computing each conv from the packed
# operands exactly as the kernels index them; the int32 accumulators must
# equal conv_s8's.

ST_PR, ST_PC, ST_CR, ST_CC = 7, 8, 15, 17
ST_IR, ST_IW, ST_KP = 35, 11, 176
ST_ICP = 4 * ST_IW
BT, BMID, BI = 14, 16, 18


def _swz(r, chunk):
    return (r << 6) | ((chunk ^ ((r >> 1) & 3)) << 4)


def _frag_bytes():
    """(g, h, t4, e) -> the A row (g + 8*(h % 2)) and byte within the
    32-byte k-step (16*(h // 2) + 4*t4 + e) a lane's fragment holds."""
    g, h, t4, e = np.meshgrid(np.arange(8), np.arange(4), np.arange(4),
                              np.arange(4), indexing="ij")
    return (g + 8 * (h % 2)).ravel(), (16 * (h // 2) + 4 * t4 + e).ravel()


def _mma(a_at, b_at, rows, ksteps):
    """acc[row, o] = sum over k-steps of the fragments the kernel loads:
    ``a_at(row, kstep, kbyte)`` and ``b_at(o, kstep, kbyte)`` return the
    int8 bytes at those coordinates (arrays of indices in, values out)."""
    frow, fk = _frag_bytes()
    acc = np.zeros((rows, 64), np.float64)   # exact: |acc| < 2^53
    for mt in range(rows // 16):
        for ks in range(ksteps):
            A = np.zeros((16, 32))
            A[frow, fk] = a_at(16 * mt + frow, ks, fk)
            o, kb = np.meshgrid(np.arange(64), np.arange(32), indexing="ij")
            B = b_at(o, ks, kb).astype(np.float64)       # (64, 32): col-major
            acc[16 * mt:16 * mt + 16] += A @ B.T
    return acc.astype(np.int64)


def _stem_emulated(xq, wpack):
    """The stem kernel's conv accumulators for every conv pixel of every
    tile: the 3 x 35 x 11-word input patch from the 4-aligned column
    ic0 - 3, the A tile gathered row by row in (c, ky, kx) order, W at the
    176-byte pitch; -> (N, 64, H/2, H/2)."""
    n, _, H, _ = xq.shape
    R, Hc = H // 4, H // 2
    tr, tc = -(-R // ST_PR), -(-R // ST_PC)
    ws = np.zeros(64 * ST_KP, np.int8)
    i = np.arange(64 * 160)
    ws[(i // 160) * ST_KP + i % 160] = wpack.numpy().reshape(-1)
    k = np.arange(147)
    koff = ((k // 49) * ST_IR + (k // 7) % 7) * ST_ICP + k % 7
    out = np.zeros((n, 64, Hc, Hc), np.int64)
    seen = np.zeros((n, Hc, Hc), bool)
    xp = np.pad(xq.numpy(), ((0, 0), (0, 0), (64, 64), (64, 64)))
    for b in range(n):
        for t in range(tr * tc):
            pr0, pc0 = (t // tc) * ST_PR, (t % tc) * ST_PC
            cr0, cc0 = 2 * pr0 - 1, 2 * pc0 - 1
            ir0, iw0 = 2 * cr0 - 3, 2 * cc0 - 6
            assert iw0 % 4 == 0
            patch = xp[b, :, 64 + ir0:64 + ir0 + ST_IR,
                       64 + iw0:64 + iw0 + ST_ICP]
            iy = np.arange(ir0, ir0 + ST_IR)[:, None]
            ix = np.arange(iw0, iw0 + ST_ICP)[None, :]
            xs = np.where((iy >= 0) & (iy < H) & (ix >= 0) & (ix < H),
                          patch, 0).astype(np.int8).reshape(-1)
            A = np.zeros(256 * ST_KP, np.int8)
            tid = np.arange(ST_CR * ST_CC)
            base = 2 * (tid // ST_CC) * ST_ICP + 2 * (tid % ST_CC) + 3
            A[(tid * ST_KP)[:, None] + k[None, :]] = xs[base[:, None]
                                                        + koff[None, :]]
            acc = _mma(lambda r, ks, kb: A[r * ST_KP + 32 * ks + kb],
                       lambda o, ks, kb: ws[o * ST_KP + 32 * ks + kb],
                       256, 5)
            for row in tid:
                cy, cx = cr0 + row // ST_CC, cc0 + row % ST_CC
                if 0 <= cy < Hc and 0 <= cx < Hc:
                    out[b, :, cy, cx] = acc[row]
                    seen[b, cy, cx] = True
    assert seen.all()
    return out


def _tile_bytes(plane, y0, x0, side):
    """The channel-last swizzled tile of (64, R, R) ``plane`` whose pixel 0
    sits at (y0, x0), zero outside the plane."""
    R = plane.shape[1]
    buf = np.zeros(side * side * 64, np.int8)
    p = np.arange(side * side)
    gy, gx = y0 + p // side, x0 + p % side
    ok = (gy >= 0) & (gy < R) & (gx >= 0) & (gx < R)
    c = np.arange(64)
    vals = np.zeros((side * side, 64), np.int8)
    vals[ok] = plane[:, gy[ok], gx[ok]].T
    buf[_swz(p[:, None], c[None, :] >> 4) + (c[None, :] & 15)] = vals
    return buf


def _block_weights(wpack):
    """The block kernel's resident weights: int4 k of (9, 64, 64) to
    ``_swz(k >> 2, k & 3)``."""
    w = np.zeros(9 * 64 * 64, np.int8)
    src = wpack.numpy().reshape(-1, 16)
    kk = np.arange(src.shape[0])
    w[_swz(kk >> 2, kk & 3)[:, None] + np.arange(16)[None, :]] = src
    return w


def _block_conv_emulated(src_tile, side, px, ws):
    """conv3x3_mma: rows read source pixel px[row] + dy*side + dx at tap
    (dy, dx); B row tap*64 + o at the kernel's (g >> 1) & 3 swizzle."""
    def a_at(r, ks, kb):
        t, kh = ks // 2, ks % 2
        p = px[r] + (t // 3) * side + t % 3
        c = 32 * kh + kb
        return src_tile[_swz(p, c >> 4) + (c & 15)]

    def b_at(o, ks, kb):
        # the ldmatrix lane of row (o & 7) + 8*(pair half) reads chunk
        # 2*kh + kb // 16 at the swizzle of its row, ((o & 7) >> 1) & 3
        t, kh = ks // 2, ks % 2
        g, chunk = o & 7, 2 * kh + kb // 16
        return ws[(t * 64 + o) * 64 + ((chunk ^ ((g >> 1) & 3)) << 4)
                  + (kb & 15)]
    return _mma(a_at, b_at, len(px), 18)


def _block_emulated(y, z, w1p, w2p):
    """The block kernel's conv1 accumulators over each 16 x 16 mid tile (of
    y) and conv2's over each 14 x 14 output tile (of the plane z in the mid
    tile's place), written back into (N, 64, R, R) planes."""
    n, _, R, _ = y.shape
    tiles = -(-R // BT)
    ws1, ws2 = _block_weights(w1p), _block_weights(w2p)
    a1 = np.zeros(y.shape, np.int64)
    a2 = np.zeros(y.shape, np.int64)
    m = np.minimum(np.arange(208), BT * BT - 1)
    px1 = np.array([(mt * BI + r) for mt in range(16) for r in range(16)])
    px2 = (m // BT) * BMID + m % BT
    for b in range(n):
        for t in range(tiles * tiles):
            y0, x0 = (t // tiles) * BT, (t % tiles) * BT
            xin = _tile_bytes(y[b].numpy(), y0 - 2, x0 - 2, BI)
            acc1 = _block_conv_emulated(xin, BI, px1, ws1)
            mid = _tile_bytes(z[b].numpy(), y0 - 1, x0 - 1, BMID)
            acc2 = _block_conv_emulated(mid, BMID, px2, ws2)
            for row in range(256):
                gy, gx = y0 - 1 + row // 16, x0 - 1 + row % 16
                if 0 <= gy < R and 0 <= gx < R:
                    a1[b, :, gy, gx] = acc1[row]
            for row in range(BT * BT):
                gy, gx = y0 + row // BT, x0 + row % BT
                if gy < R and gx < R:
                    a2[b, :, gy, gx] = acc2[row]
    return a1, a2


@pytest.mark.parametrize("H", [112, 200])
def test_stem_packing_and_fragments_equal_conv_s8(H):
    """The stem's (64, 160) packed weights, read through the A-tile gather
    and the fragment layout, give conv_s8's accumulators at every conv
    pixel (H = 200: R = 50 is a multiple of neither tile side)."""
    rng = np.random.default_rng(31 + H)
    xq = torch.as_tensor(rng.integers(-127, 128, (2, 3, H, H), dtype=np.int8))
    wq = torch.as_tensor(rng.integers(-127, 128, (64, 3, 7, 7),
                                      dtype=np.int8))
    wpack = tst._pack_stem(wq)
    assert wpack.shape == (64, tst.STEM_K) and wpack.dtype == torch.int8
    assert torch.equal(wpack[:, :147], wq.reshape(64, 147))
    assert not wpack[:, 147:].any()
    ref = tst.conv_s8(xq, wq, (2, 2), (3, 3, 3, 3)).numpy()
    np.testing.assert_array_equal(_stem_emulated(xq, wpack), ref)


@pytest.mark.parametrize("R", [28, 50])
def test_block_packing_and_fragments_equal_conv_s8(R):
    """The blocks' [tap][o][c] packed weights, resident in the swizzled
    layout, read through the implicit-im2col fragments of both convs, give
    conv_s8's accumulators (R = 28: whole 14 x 14 tiles; R = 50: ragged)."""
    rng = np.random.default_rng(37 + R)
    y = torch.as_tensor(rng.integers(-127, 128, (2, 64, R, R), dtype=np.int8))
    z = torch.as_tensor(rng.integers(0, 128, (2, 64, R, R), dtype=np.int8))
    w1, w2 = (torch.as_tensor(rng.integers(-127, 128, (64, 64, 3, 3),
                                           dtype=np.int8)) for _ in range(2))
    w1p, w2p = tst._pack_block(w1), tst._pack_block(w2)
    assert w1p.shape == (9, 64, 64) and w1p.is_contiguous()
    for t in range(9):
        assert torch.equal(w1p[t], w1[:, :, t // 3, t % 3])
    a1, a2 = _block_emulated(y, z, w1p, w2p)
    pad = (1, 1, 1, 1)
    np.testing.assert_array_equal(a1, tst.conv_s8(y, w1, (1, 1), pad).numpy())
    np.testing.assert_array_equal(a2, tst.conv_s8(z, w2, (1, 1), pad).numpy())


def _cpu_plan(requant="fxp", out_scale=None):
    rng = np.random.default_rng(41)
    _, ws, bs, blocks = _inputs(rng, 64, 1)
    args = _torch_args(ws, bs, blocks)
    bw = [tuple(args[2 + i:6 + i]) for i in range(0, len(args) - 2, 4)]
    return tst._fold(args[0], args[1], bw, out_scale, torch.device("cpu"),
                     requant, True)


@pytest.mark.parametrize("requant", ["fxp", "trunc"])
def test_fold_carries_packed_weights(requant):
    plan = _cpu_plan(requant)
    assert torch.equal(plan.ws_pack, tst._pack_stem(plan.ws))
    for b in plan.blocks:
        assert torch.equal(b.w1p, tst._pack_block(b.w1))
        assert torch.equal(b.w2p, tst._pack_block(b.w2))
        assert b.w1p.is_contiguous() and b.w2p.is_contiguous()


def test_run_hands_packed_weights_and_repacks_nothing(monkeypatch):
    """_run on the kernel path passes the plan's packed tensors themselves
    to the wrappers (mocked: this machine has no card) and permutes, pads
    or packs no weight on the way."""
    plan = _cpu_plan()
    calls = []

    def stem(xq, wq, table, mode, wpack=None):
        calls.append(("stem", wpack))
        n, _, h, _ = xq.shape
        return torch.zeros((n, 64, h // 4, h // 4), dtype=torch.int8)

    def block(y, w1, q1, w2, e2, sx, last, trunc, w1p=None, w2p=None):
        calls.append(("block", w1p, w2p))
        return torch.zeros(y.shape, dtype=torch.bfloat16 if last
                           else torch.int8)

    def refuse(*a, **k):
        raise AssertionError("a weight was repacked on the program path")

    monkeypatch.setattr(tst, "stem_pool_requant", stem)
    monkeypatch.setattr(tst, "basic_block", block)
    for name in ("_pack_stem", "_pack_block"):
        monkeypatch.setattr(tst, name, refuse)
    monkeypatch.setattr(torch.Tensor, "permute", refuse)
    monkeypatch.setattr(tst.F, "pad", refuse)
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (2, 3, 64, 64)).astype(np.float32))
    y = tst._run(x, plan)
    assert y.shape == (2, 64, 16, 16)
    assert calls[0] == ("stem", plan.ws_pack) and calls[0][1] is plan.ws_pack
    assert len(calls) == 1 + len(plan.blocks)
    for (kind, w1p, w2p), b in zip(calls[1:], plan.blocks):
        assert kind == "block" and w1p is b.w1p and w2p is b.w2p


def test_wrappers_check_packed_operands():
    """A packed operand is checked like the others; on the CPU the wrapper
    still runs the plain version."""
    plan = _cpu_plan()
    b = plan.blocks[0]
    y = torch.as_tensor(np.random.default_rng(4).integers(
        0, 128, (1, 64, 16, 16), dtype=np.int8))
    ref = tst.basic_block_plain(y, b.w1, b.q1, b.w2, b.e2, b.sx)
    out = tst.basic_block(y, b.w1, b.q1, b.w2, b.e2, b.sx, w1p=b.w1p,
                          w2p=b.w2p)
    assert torch.equal(out, ref)
    with pytest.raises(ValueError, match="both"):
        tst.basic_block(y, b.w1, b.q1, b.w2, b.e2, b.sx, w1p=b.w1p)
    with pytest.raises(ValueError):
        tst.basic_block(y, b.w1, b.q1, b.w2, b.e2, b.sx, w1p=b.w1,
                        w2p=b.w2p)
    with pytest.raises(TypeError):
        tst.basic_block(y, b.w1, b.q1, b.w2, b.e2, b.sx,
                        w1p=b.w1p.float(), w2p=b.w2p)
    with pytest.raises(ValueError):     # an odd side: no eligible stage has one
        tst.basic_block(y[:, :, :15, :15].contiguous(), b.w1, b.q1, b.w2,
                        b.e2, b.sx)
    xq = torch.as_tensor(np.random.default_rng(5).integers(
        -127, 128, (1, 3, 64, 64), dtype=np.int8))
    assert torch.equal(
        tst.stem_pool_requant(xq, plan.ws, plan.stem_table, "fxp",
                              wpack=plan.ws_pack),
        tst.stem_pool_requant_plain(xq, plan.ws, plan.stem_table))
    with pytest.raises(ValueError):
        tst.stem_pool_requant(xq, plan.ws, plan.stem_table, "fxp",
                              wpack=plan.ws_pack[:, :148].contiguous())
