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
