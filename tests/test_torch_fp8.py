"""``quantize("fp8")`` in the port against the JAX package on the CPU: the
port's own e4m3 codec (``planer_tpu_torch/ops/fp8.py``, no ``ml_dtypes``),
``quantize_net``'s bytes, the fp8 weight form of ``dense_q`` and weight-only
FP8 ResNet-50 with the 1x1 route.

The JAX side runs its Pallas GEMM in interpret mode, as in
``tests/test_torch_gemm.py``: ``gemm.dense_q(..., interpret=True)`` for one
call, and ``gemm.dense_q`` patched to that, with ``jax_ops._PALLAS_CONV1X1``
on, for a whole program.  fp8 weights cross between the packages as uint8
bit patterns on the port's side and ``ml_dtypes.float8_e4m3fn`` arrays on
the JAX side; ``net_from_arrays`` takes either.

Tolerances are those of ``tests/test_torch_gemm.py`` (the kernel branch
sums exact bf16 products in f32 in another order than XLA): f32 outputs
max|d|/max|y| <= 1e-5; bf16 outputs within one bf16 ulp of the product
before the bias plus 1e-5 of the largest product, plus one ulp of the
result where a bias is added after the cast.  Whole programs: p99 over
images of max|d|/max|y| <= 0.02 and argmax equal on decisive images (bf16);
1e-5 for the f32 program.
"""
import functools
import os
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from planer_tpu import io as jio
from planer_tpu import models as jm
from planer_tpu.models import eval as jev
from planer_tpu.ops import jax_ops as jops
from planer_tpu.ops.pallas import gemm as jg
from planer_tpu.ops.qtypes import QTensor as JQ
from planer_tpu.quant import calibrate_act_scales as j_calibrate
from planer_tpu.quant import dequant_weights as j_dequant
from planer_tpu.quant import make_quant_program as j_program

import planer_tpu_torch as pt
from planer_tpu_torch import io as tio
from planer_tpu_torch.ops import fp8
from planer_tpu_torch.ops import torch_ops as tops
from planer_tpu_torch.ops.kernels import gemm as tg
from planer_tpu_torch.ops.kernels import stage64 as tst64
from planer_tpu_torch.ops.kernels import stagen as tsg
from planer_tpu_torch.ops.qtypes import QTensor as TQ
from planer_tpu_torch.quant import dequant_weights as t_dequant

# the int8 form's shapes, bounds and helpers
from test_torch_gemm import (FALLBACK, MARGIN, SHAPES, _assert_close,
                             _interpret, _np, _x)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E4M3 = ml_dtypes.float8_e4m3fn


def _ml(v):
    """ml_dtypes' e4m3 bytes of float32 values."""
    return np.asarray(v, np.float32).astype(E4M3).view(np.uint8)


def _finite_values():
    codes = np.array([c for c in range(256) if c & 0x7F != 0x7F], np.uint8)
    return np.sort(codes.view(E4M3).astype(np.float32))


# ------------------------------------------------------------------ codec

def test_encode_matches_ml_dtypes_byte_for_byte():
    """Every finite value, every midpoint between neighbours (the ties) and
    one f32 step either side of it, the subnormal range, +-0 and
    log-spread values in [-448, 448]."""
    vals = np.unique(_finite_values())
    mids = (vals[:-1].astype(np.float64) + vals[1:]) / 2
    mids = mids.astype(np.float32)
    up = np.nextafter(mids, np.float32(np.inf))
    down = np.nextafter(mids, np.float32(-np.inf))
    sub = np.linspace(0, 2.0 ** -6, 4097, dtype=np.float32)
    rng = np.random.default_rng(0)
    spread = np.exp(rng.uniform(-12, np.log(448), 100_000)).astype(np.float32)
    spread *= rng.choice([-1, 1], spread.size).astype(np.float32)
    sweep = np.concatenate([vals, mids, up, down, sub, -sub, spread,
                            np.float32([0.0, -0.0, 448.0, -448.0])])
    assert np.abs(sweep).max() <= 448.0
    got = fp8.encode(sweep)
    assert got.dtype == np.uint8 and got.shape == sweep.shape
    np.testing.assert_array_equal(got, _ml(sweep))
    assert fp8.encode(np.float32([-0.0]))[0] == 0x80


def test_decode_matches_ml_dtypes_on_all_codes():
    codes = np.arange(256, dtype=np.uint8)
    got, ref = fp8.decode(codes), codes.view(E4M3).astype(np.float32)
    assert got.dtype == np.float32
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert sorted(np.flatnonzero(nan)) == [0x7F, 0xFF]
    np.testing.assert_array_equal(got[~nan].view(np.uint32),
                                  ref[~nan].view(np.uint32))   # -0.0 too
    t = fp8.to_tensor(codes)
    assert t.dtype == torch.float8_e4m3fn
    np.testing.assert_array_equal(t.float().numpy()[~nan], got[~nan])
    np.testing.assert_array_equal(t.to(torch.bfloat16).float().numpy()[~nan],
                                  got[~nan])


def test_encode_differs_from_ml_dtypes_only_above_464():
    """The one difference between the casts: above 464 (the tie between 448
    and the first value past the format) ml_dtypes gives NaN, torch
    saturates to 448.  ``quantize_net`` divides by absmax / 448, so it
    never gets there (its largest |w / scale| on ResNet-50 is checked in
    ``test_quantize_net_writes_the_reference_bytes``)."""
    v = np.float32([464.0, np.nextafter(np.float32(464), np.float32(1e9)),
                    480.0, 1e6])
    assert fp8.encode(v).tolist() == [0x7E] * 4
    assert fp8.encode(-v).tolist() == [0xFE] * 4
    assert _ml(v).tolist() == [0x7E, 0x7F, 0x7F, 0x7F]


# ------------------------------------------------------------ quantize_net

@pytest.mark.parametrize("model", ["resnet18", "resnet50"])
def test_quantize_net_writes_the_reference_bytes(model):
    """Full width: the same optimized float model quantized to fp8 by both
    packages gives the same payload bytes, ``~scale`` inits,
    ``graph.inits`` names, shapes and dtypes and ``graph.quant``;
    ``dequant_weights`` equal too."""
    jq = getattr(jm, model)()
    jq.optimize()
    tq = pt.net_from_arrays(jq.graph.to_json_dict(), jq.weights, device="cpu")
    floats = list(tq.weights)
    jq.quantize("fp8")
    tq.quantize("fp8")
    assert [tuple(i) for i in tq.graph.inits] == \
        [tuple(i) for i in jq.graph.inits]
    assert tq.graph.quant == jq.graph.quant
    n8 = 0
    for (name, shape, dtype), a, b in zip(tq.graph.inits, jq.weights,
                                          tq.weights):
        if dtype == fp8.NAME:
            n8 += 1
            assert a.dtype == E4M3 and b.dtype == np.uint8
            assert tq.graph.quant[name]["mode"] == "fp8"
        else:
            assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      b.view(np.uint8), err_msg=name)
    assert n8 == {"resnet18": 21, "resnet50": 54}[model]
    for a, b in zip(j_dequant(jq.graph, jq.weights),
                    t_dequant(tq.graph, tq.weights)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    # |w / scale| stays below 464, where the two casts part
    idx = tq.graph.init_index()
    for name, info in tq.graph.quant.items():
        w, s = floats[idx[name]], tq.weights[idx[info["scale"]]]
        assert np.abs(w / s).max() <= 448.0 * (1 + 2.0 ** -20)


# ------------------------------------------------------------------ the op

def _weights(rng, N, Kd):
    """fp8 weights as quantize_net makes them: per-row absmax / 448."""
    w = rng.standard_normal((N, Kd)).astype(np.float32) \
        * (0.5 + rng.random((N, 1))).astype(np.float32) * 0.05
    s = (np.abs(w).max(1, keepdims=True) / 448.0).astype(np.float32)
    q = fp8.encode(w / s)
    b = (rng.standard_normal(N) * 0.1).astype(np.float32)
    return q, s, b


def _both(q, s, b=None):
    """The same fp8 weights as a JAX and a port QTensor, and the bias."""
    jk = JQ(jnp.asarray(q.view(E4M3)), jnp.asarray(s))
    tk = TQ(fp8.to_tensor(q), torch.as_tensor(s))
    return jk, tk, (None if b is None else jnp.asarray(b)), \
        (None if b is None else torch.as_tensor(b))


@pytest.mark.parametrize("bias", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,Kd", SHAPES)
def test_dense_q_fp8_matches_interpret_run(M, N, Kd, dtype, bias):
    """The kernel branch on fp8 weights (plain version on CPU tensors)
    against the JAX kernel in interpret mode."""
    rng = np.random.default_rng(M + N + Kd + 8)
    q, s, b = _weights(rng, N, Kd)
    jk, tk, jb, tb = _both(q, s, b if bias else None)
    jx, tx = _x(rng, (M, Kd), dtype)
    calls = []
    orig = tg.dense_q_plain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tg, "dense_q_plain",
                   lambda *a: calls.append(a[1].dtype) or orig(*a))
        out = tg.dense_q(tx, tk, tb)
    assert calls == [torch.float8_e4m3fn] and out.dtype == tx.dtype
    _assert_close(out, _interpret(jx, jk, jb), dtype, tb)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,Kd", FALLBACK)
def test_fp8_fallback_shapes_match_reference(M, N, Kd, dtype):
    """Shapes the gate refuses take ``_fallback_dense``'s numerics on fp8
    weights too (``K.dequant`` of a float8 tensor)."""
    rng = np.random.default_rng(M * N + Kd + 8)
    q, s, b = _weights(rng, N, Kd)
    jk, tk, jb, tb = _both(q, s, b)
    jx, tx = _x(rng, (M, Kd), dtype)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tg, "dense_q_plain", None)
        out = tops.dense(tx, tk, tb)
    ref = jax.jit(lambda v: jg._fallback_dense(v, jk, jb))(jx)
    _assert_close(out, ref, dtype, tb)


def test_plain_versions_take_fp8_as_written():
    """``dense_q_plain`` and ``fallback_dense`` on a float8 tensor compute
    exactly what they compute on its decoded float32 values."""
    rng = np.random.default_rng(5)
    q, s, b = _weights(rng, 256, 128)
    tq, ts, tb = fp8.to_tensor(q), torch.as_tensor(s), torch.as_tensor(b)
    tf = torch.as_tensor(fp8.decode(q))
    for dt in (torch.float32, torch.bfloat16):
        x = torch.as_tensor(rng.standard_normal((16, 128)).astype(
            np.float32)).to(dt)
        assert torch.equal(tg.dense_q_plain(x, tq, ts, tb),
                           tg.dense_q_plain(x, tf, ts, tb))
        assert torch.equal(tg.fallback_dense(x, TQ(tq, ts), tb),
                           tg.fallback_dense(x, TQ(tf, ts), tb))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fp8_leading_dims_and_matmul_q(dtype):
    """x with leading dimensions, and ``matmul_q`` on (Kd, N)-layout fp8
    weights (the wrapper transposes a float8 tensor)."""
    rng = np.random.default_rng(4)
    q, s, b = _weights(rng, 256, 128)
    jk, tk, jb, tb = _both(q, s, b)
    jx, tx = _x(rng, (2, 3, 4, 128), dtype)
    out = tg.dense_q(tx, tk, tb)
    assert out.shape == (2, 3, 4, 256)
    _assert_close(out, _interpret(jx, jk, jb), dtype, tb)
    qt = np.ascontiguousarray(q.T)
    jkt = JQ(jnp.asarray(qt.view(E4M3)), jnp.asarray(s.reshape(1, -1)))
    tkt = TQ(fp8.to_tensor(qt), torch.as_tensor(s.reshape(1, -1)))
    out = tg.matmul_q(tx, tkt)
    ref = jax.jit(lambda v: jg.matmul_q(v, jkt, interpret=True))(jx)
    assert out.shape == ref.shape == (2, 3, 4, 256)
    _assert_close(out, ref, dtype)


CONV_CASES = {
    # name: (x shape, out channels, strides, pads, route target)
    # (48x48 at b2: N*H*W = 4608, past the W8A8 gate's 4096)
    "tile": ((2, 128, 48, 48), 256, (1, 1), (0, 0, 0, 0), "kernel"),
    "kd64": ((2, 64, 48, 48), 256, (1, 1), (0, 0, 0, 0), "fallback"),
    "strided": ((2, 128, 48, 48), 256, (2, 2), (0, 0, 0, 0), "conv"),
    "3x3": ((2, 128, 48, 48), 256, (1, 1), (1, 1, 1, 1), "conv"),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CONV_CASES))
def test_fp8_conv_route_matches_reference(case, dtype, monkeypatch):
    """conv2d on fp8 weights with the 1x1 route on both sides: a tiling 1x1
    conv takes the kernel branch, a Kd = 64 one the fallback GEMM, strided
    and 3x3 ones an ordinary conv on weights dequantized to x's dtype.  The
    activation scales are set (as after calibration), and the s8 paths
    stay closed: their gates test for int8 weights."""
    shape, o, strides, pads, target = CONV_CASES[case]
    rng = np.random.default_rng(len(case) + 8)
    k = 3 if case == "3x3" else 1
    w = rng.standard_normal((o, shape[1], k, k)).astype(np.float32) * 0.05
    s = (np.abs(w).max((1, 2, 3), keepdims=True) / 448.0).astype(np.float32)
    q = fp8.encode(w / s)
    b = (rng.standard_normal(o) * 0.1).astype(np.float32)
    jk = JQ(jnp.asarray(q.view(E4M3)), jnp.asarray(s), act_dynamic=True,
            act_scale=0.05)
    tk = TQ(fp8.to_tensor(q), torch.as_tensor(s), act_dynamic=True,
            act_scale=0.05)
    jx, tx = _x(rng, shape, dtype)
    monkeypatch.setattr(jops, "_PALLAS_CONV1X1", True)
    monkeypatch.setattr(jg, "dense_q", functools.partial(jg.dense_q,
                                                         interpret=True))
    monkeypatch.setattr(tops, "_PALLAS_CONV1X1", True)
    monkeypatch.setattr(tops, "_conv_w8a8", None)
    seen = []
    for name in ("dense_q_plain", "fallback_dense"):
        f = getattr(tg, name)
        monkeypatch.setattr(tg, name, lambda *a, _f=f, _n=name:
                            seen.append(_n) or _f(*a))
    conv = torch.nn.functional.conv2d
    monkeypatch.setattr(torch.nn.functional, "conv2d",
                        lambda *a, **k: seen.append("conv") or conv(*a, **k))
    tb = torch.as_tensor(b)
    out = tops.conv2d(tx, tk, tb, strides=strides, pads=pads)
    want = {"kernel": "dense_q_plain", "fallback": "fallback_dense",
            "conv": "conv"}[target]
    assert seen == [want]
    ref = jax.jit(lambda v: jops.conv2d(v, jk, jnp.asarray(b),
                                        strides=strides, pads=pads))(jx)
    assert tuple(out.shape) == ref.shape and out.dtype == tx.dtype
    if target == "conv":
        # the dequantized weights in x's dtype, then a plain conv
        kd = tk.dequant(tx.dtype)
        direct = conv(tx, kd, None, strides, pads[:2]) \
            + tb.reshape(1, -1, 1, 1).to(tx.dtype)
        assert torch.equal(out, direct)
        d = np.abs(_np(out) - _np(ref)).max() / np.abs(_np(ref)).max()
        assert d <= (1e-5 if dtype == "float32" else 2.0 ** -7)
    else:
        _assert_close(out, ref, dtype, tb.reshape(1, -1, 1, 1))


# ------------------------------------------------------------ whole slice

SIZE = 64


@pytest.fixture(scope="module")
def wo_net():
    """Weight-only FP8 ResNet-50 built by the JAX package: optimized and
    ``quantize("fp8")``."""
    net = jm.resnet50()
    net.optimize()
    net.quantize("fp8")
    return net


@pytest.fixture
def jax_bf16_fp8(monkeypatch):
    """Lets the JAX package run an fp8 program in bf16.  Its tracer casts
    every param whose ``dtype`` is floating to the compute dtype
    (tracer.py:203-206); a QTensor reports its payload's dtype, so an fp8
    QTensor is sent to ``astype``, which it lacks, and the program raises
    (an int8 QTensor is not floating and passes as it is).  The port's
    Program casts tensors only and leaves every QTensor as it is; this
    gives the JAX QTensor the same treatment, for the test's duration."""
    monkeypatch.setattr(JQ, "astype", lambda self, dtype: self,
                        raising=False)


def _dtype(a):
    return a.q.dtype if isinstance(a, TQ) else a.dtype


def _rels(yt, yj):
    rels = np.abs(yt - yj).max(1) / (np.abs(yj).max(1) + 1e-9)
    srt = np.sort(yj, axis=1)
    keep = (srt[:, -1] - srt[:, -2]) / (np.abs(yj).max(1) + 1e-9) >= MARGIN
    return float(np.percentile(rels, 99)), keep


def test_weight_only_fp8_resnet50_matches_reference(wo_net, monkeypatch,
                                                    jax_bf16_fp8):
    """Weight-only FP8 ResNet-50 at full width and depth, 64x64, b2, bf16
    compute, with the 1x1 route on both sides: the 26 routed convs of
    layers 2-4 take the kernel branch (the JAX side's in interpret mode),
    layer1's seven 1x1 convs and the fc the fallback."""
    xs = next(jev.synthetic_images(2, (3, SIZE, SIZE), seed=31, batch=2))
    monkeypatch.setattr(jops, "_PALLAS_CONV1X1", True)
    jcalls = []
    jdense = jg.dense_q

    def jspy(x, K, B=None, **kw):
        n, kd = K.q.shape
        assert K.q.dtype == E4M3
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
                            seen.append((_n, _dtype(a[1]))) or _f(*a))
    tnet = pt.net_from_arrays(wo_net.graph.to_json_dict(), wo_net.weights,
                              device="cpu", compute_dtype="bfloat16")
    yt = tnet(xs)
    assert seen.count(("dense_q_plain", torch.float8_e4m3fn)) == 26
    assert seen.count(("fallback_dense", torch.float8_e4m3fn)) == 8
    assert yt.dtype == np.float32 and yt.shape == yj.shape == (2, 1000)
    assert np.isfinite(yt).all()
    p99, keep = _rels(yt, yj)
    print(f"weight-only fp8 resnet50 bf16 logits: p99 rel {p99:.3g}, "
          f"{int(keep.sum())} decisive images")
    assert p99 <= 0.02
    assert (yt.argmax(1) == yj.argmax(1))[keep].all()


def test_reference_fp8_case_resnet18():
    """The JAX package's own fp8 case (tests/test_compat.py:78): ResNet-18,
    10 classes, 32x32, the default path in f32 (no route).  The port,
    quantizing the same float weights itself, matches the JAX package's
    quantized net within the f32 bound, and stays within test_compat's 0.1
    of the float model."""
    rng = np.random.default_rng(42)
    jnet = jm.resnet18(num_classes=10)
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    tnet = pt.net_from_arrays(jnet.graph.to_json_dict(), jnet.weights,
                              device="cpu")
    ref = tnet(x)
    jnet.quantize("fp8")
    tnet.quantize("fp8")
    assert tnet.weights[0].dtype == np.uint8
    assert tnet.graph.inits[0][2] == fp8.NAME
    yj, yt = np.asarray(jnet.forward(x)), tnet(x)
    rel = np.abs(yt - yj).max() / np.abs(yj).max()
    print(f"port vs JAX fp8 resnet18 f32: max rel {rel:.3g}")
    assert rel <= 1e-5
    assert np.abs(yt - ref).max() / (np.abs(ref).max() + 1e-9) < 0.1


@pytest.mark.parametrize("fuse", [True, "all"])
def test_fp8_fused_stages_run_the_decomposed_chain(fuse, monkeypatch,
                                                   jax_bf16_fp8):
    """``quantize("fp8", activations="static", fuse=...)`` on a calibrated
    ResNet-18 fuses a stage64 op (and, with ``fuse="all"``, three stagen
    ops), which the int8-only eligibility gates send down their decomposed
    chains (``FALLOFF["weights"]`` once a forward per op); no stage64 or
    stagen kernel wrapper runs, nothing is annotated
    (``annotate_output_quant`` takes int8 only).  The port matches the JAX
    package at bf16 within the slice bound."""
    jnet = jm.resnet18()
    jnet.optimize()
    j_calibrate(jnet, jev.synthetic_images(2, (3, SIZE, SIZE), seed=3,
                                           batch=2))
    jnet.quantize("fp8", activations="static", fuse=fuse)
    ops = [l.op for l in jnet.graph.layers]
    nstagen = 3 if fuse == "all" else 0
    assert ops.count("stage64") == 1 and ops.count("stagen") == nstagen
    assert not any("out_scale" in l.kwargs for l in jnet.graph.layers)
    xs = next(jev.synthetic_images(4, (3, SIZE, SIZE), seed=5, batch=4))
    yj = np.asarray(j_program(jnet.graph, jnet.weights,
                              compute_dtype="bfloat16")(xs))
    for name in ("stem_pool_requant", "basic_block", "_run"):
        monkeypatch.setattr(tst64, name, None)
    for name in ("stagen_stage", "stagen_plain"):
        monkeypatch.setattr(tsg, name, None)
    tst64.FALLOFF.clear()
    tsg.FALLOFF.clear()
    tnet = pt.net_from_arrays(jnet.graph.to_json_dict(), jnet.weights,
                              device="cpu", compute_dtype="bfloat16")
    yt = tnet(xs)
    assert dict(tst64.FALLOFF) == {"weights": 1}
    assert dict(tsg.FALLOFF) == ({"weights": nstagen} if nstagen else {})
    p99, keep = _rels(yt, yj)
    print(f"fp8 fuse={fuse!r} resnet18 bf16: p99 rel {p99:.3g}")
    assert p99 <= 0.02
    assert (yt.argmax(1) == yj.argmax(1))[keep].all()
    # the port's own pipeline builds the same graph structure
    own = pt.models.resnet18(device="cpu")
    own.optimize()
    pt.calibrate_act_scales(own, jev.synthetic_images(2, (3, SIZE, SIZE),
                                                      seed=3, batch=2))
    own.quantize("fp8", activations="static", fuse=fuse)
    assert [l.op for l in own.graph.layers] == ops
    assert own.graph.quant == jnet.graph.quant


def test_fp8_pla_round_trips_both_ways(tmp_path):
    """An fp8 .pla written by planer_tpu loads in the port with the same
    bytes and outputs; one written by the port loads in planer_tpu with
    identical bytes and float8_e4m3fn arrays."""
    jnet = jm.resnet18(num_classes=10)
    jnet.quantize("fp8")
    x = np.random.default_rng(7).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    p = jio.save_pla(str(tmp_path / "jax_written.pla"), jnet.graph,
                     jnet.weights)
    loaded = tio.read_net(p, device="cpu")
    direct = pt.net_from_arrays(jnet.graph.to_json_dict(), jnet.weights,
                                device="cpu")
    for a, b in zip(jnet.weights, loaded.weights):
        np.testing.assert_array_equal(np.asarray(a).view(np.uint8),
                                      b.view(np.uint8))
    np.testing.assert_array_equal(loaded(x), direct(x))
    yj = np.asarray(jnet.forward(x))
    assert np.abs(loaded(x) - yj).max() / np.abs(yj).max() <= 1e-5
    p2 = tio.save_pla(str(tmp_path / "port_written.pla"), direct.graph,
                      direct.weights)
    back = jio.read_net(p2)
    for (name, _, dtype), a, b in zip(direct.graph.inits, direct.weights,
                                      back.weights):
        if dtype == fp8.NAME:
            assert b.dtype == E4M3
        np.testing.assert_array_equal(a.view(np.uint8),
                                      np.asarray(b).view(np.uint8))
    np.testing.assert_array_equal(np.asarray(back.forward(x)), yj)


def test_port_runs_fp8_without_ml_dtypes():
    """With ``ml_dtypes`` and ``jax`` blocked, the port quantizes a small
    ResNet-50 to fp8, runs it with the 1x1 route, saves and reloads a .pla
    and runs the float32 executor, all on the CPU."""
    code = """
import os, sys, tempfile
sys.modules["ml_dtypes"] = None
sys.modules["jax"] = None
import numpy as np
import planer_tpu_torch as pt
from planer_tpu_torch.models.eval import synthetic_images
from planer_tpu_torch.ops import torch_ops as tops
from planer_tpu_torch.ops.kernels import gemm as tg
net = pt.models.resnet50(num_classes=10, device="cpu")
net.optimize()
net.quantize("fp8")
assert sum(d == "float8_e4m3fn" for _, _, d in net.graph.inits) == 54
x = next(synthetic_images(2, (3, 64, 64), seed=1, batch=2))
tops._PALLAS_CONV1X1 = True
calls = []
orig = tg.dense_q_plain
tg.dense_q_plain = lambda *a: calls.append(str(a[1].dtype)) or orig(*a)
y = net(x)
assert calls == ["torch.float8_e4m3fn"] * 26, calls
tops._PALLAS_CONV1X1 = False
yo = net(x, engine="oracle")
d = tempfile.mkdtemp()
p = pt.save_pla(os.path.join(d, "fp8"), net.graph, net.weights)
back = pt.read_net(p, device="cpu")
assert all(np.array_equal(a, b) for a, b in zip(net.weights, back.weights))
assert np.array_equal(back(x), net(x))
assert np.isfinite(y).all() and y.shape == (2, 10)
rel = np.abs(y - yo).max() / np.abs(yo).max()
assert rel <= 0.02, rel
bad = [m for m in sys.modules if m.split(".")[0] in ("jax", "ml_dtypes",
       "planer_tpu") and sys.modules[m] is not None]
assert not bad, bad
print("ok", rel)
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("ok")
