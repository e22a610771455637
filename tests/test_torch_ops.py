"""The port's main-path ops (planer_tpu_torch/ops/torch_ops.py) against the
JAX package's (planer_tpu/ops/jax_ops.py), branch by branch.

conv2d's precision branch depends on dtype, channels and batch; each case
below sits on one side of a gate, and the port must take the reference's
branch there.  s8 branches accumulate exactly (test_s8_conv_accumulators_
exact).  Past the accumulator the compiled reference may contract a multiply
and the following add into one FMA, and in bf16 may skip an intermediate
bf16 rounding (XLA's excess-precision default); the port rounds every step
as the source reads.  So f32 outputs agree to two f32 ulps of the operands'
magnitude, bf16 outputs to one bf16 rounding, emitted int8 codes are
identical in f32 and at most one apart in bf16.

The reference ops run under ``jax.jit`` as the quantized program runs them:
static scales are compile-time constants there, which decides how XLA
compiles a division by them (torch_ops.quantize).
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from planer_tpu.ops import jax_ops as jops
from planer_tpu.ops.qtypes import QTensor as JQ

from planer_tpu_torch.ops import torch_ops as tops
from planer_tpu_torch.ops.qtypes import QTensor as TQ


def _q(rng, shape, act_scale=None, act_dynamic=False):
    q = rng.integers(-127, 128, size=shape, dtype=np.int8)
    scale = (0.5 + rng.random((shape[0],) + (1,) * (len(shape) - 1))
             ).astype(np.float32) / 256.0
    return (JQ(jnp.asarray(q), jnp.asarray(scale), act_dynamic=act_dynamic,
               act_scale=act_scale),
            TQ(torch.as_tensor(q), torch.as_tensor(scale),
               act_dynamic=act_dynamic, act_scale=act_scale))


def _pair(a, dtype="float32"):
    """numpy array -> (jnp, torch) in ``dtype`` (int8 stays int8)."""
    if a.dtype == np.int8:
        return jnp.asarray(a), torch.as_tensor(a)
    return (jnp.asarray(a).astype(dtype),
            torch.as_tensor(a).to(getattr(torch, dtype)))


def _jit(fn, *args, **kw):
    """fn(*args, **kw) compiled, with the kwargs as constants."""
    return jax.jit(lambda *a: fn(*a, **kw))(*args)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy() if v.dtype != torch.int8 else v.numpy()
    return np.asarray(v.astype(jnp.float32) if v.dtype != jnp.int8 else v)


# name, x shape, x kind, weight shape, weight kind, conv kwargs, branch
CONV_CASES = [
    ("codes_s8", (2, 128, 8, 8), "codes", (64, 128, 3, 3), "static",
     dict(strides=(1, 1), pads=(1, 1, 1, 1)), "s8"),
    ("codes_s8_b1_stride2", (1, 256, 8, 8), "codes", (128, 256, 3, 3),
     "static", dict(strides=(2, 2), pads=(1, 1, 1, 1)), "s8"),
    ("codes_decode_c64", (2, 64, 10, 10), "codes", (32, 64, 3, 3), "static",
     dict(strides=(2, 2), pads=(1, 1, 1, 1)), "float"),
    ("w8a8_static_b4", (4, 128, 32, 32), "float", (64, 128, 1, 1), "static",
     dict(strides=(1, 1)), "s8"),
    ("w8a8_dynamic_b4", (4, 128, 32, 32), "float", (64, 128, 3, 3),
     "dynamic", dict(strides=(2, 2), pads=(1, 1, 1, 1)), "s8"),
    ("below_4096_b1", (1, 128, 32, 32), "float", (64, 128, 1, 1), "static",
     dict(strides=(1, 1)), "float"),
    ("stacked_b32", (32, 16, 56, 56), "float", (16, 16, 3, 3), "static",
     dict(strides=(1, 1), pads=(1, 1, 1, 1)), "s8"),
    ("not_stacked_b8", (8, 16, 56, 56), "float", (16, 16, 3, 3), "static",
     dict(strides=(1, 1), pads=(1, 1, 1, 1)), "float"),
    ("not_stacked_w130", (8, 16, 100, 130), "float", (16, 16, 3, 3),
     "static", dict(strides=(1, 1), pads=(1, 1, 1, 1)), "float"),
    ("weight_only", (2, 64, 16, 16), "float", (32, 64, 3, 3), "none",
     dict(strides=(1, 1), pads=(1, 1, 1, 1)), "float"),
    ("stem_dequant", (1, 3, 32, 32), "float", (64, 3, 7, 7), "static",
     dict(strides=(2, 2), pads=(3, 3, 3, 3)), "float"),
]


def _conv_inputs(case, seed):
    name, xs, xkind, wsh, wkind, kw, branch = case
    rng = np.random.default_rng(seed)
    if xkind == "codes":
        x = rng.integers(-127, 128, size=xs, dtype=np.int8)
    else:
        x = np.abs(rng.standard_normal(xs)).astype(np.float32)
    act = {"static": 0.02, "dynamic": None, "none": None}[wkind]
    jk, tk = _q(rng, wsh, act_scale=act, act_dynamic=wkind == "dynamic")
    b = (rng.standard_normal(wsh[0]) * 0.1).astype(np.float32)
    return x, jk, tk, b, kw, branch


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_conv2d_branches(case, cdt):
    x, jk, tk, b, kw, branch = _conv_inputs(case, seed=len(case[0]))
    jx, tx = _pair(x, cdt)
    jb, tb = _pair(b, cdt)
    cd = None if cdt == "float32" else cdt
    ref = _jit(jops.conv2d, jx, jk, jb, compute_dtype=cd, **kw)
    out = tops.conv2d(tx, tk, tb, compute_dtype=cd, **kw)
    assert str(out.dtype).split(".")[-1] == str(ref.dtype), (out.dtype,
                                                              ref.dtype)
    assert tuple(out.shape) == tuple(ref.shape)
    r, o = _np(ref), _np(out)
    if branch == "s8" and cdt == "float32":
        # exact accumulators; acc*scale + bias rounded once or twice
        bound = 2 * np.spacing(np.abs(r) + np.abs(b).reshape(1, -1, 1, 1))
        assert (np.abs(o - r) <= bound).all()
    elif cdt == "float32":
        np.testing.assert_allclose(o, r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())
    else:
        # one bf16 rounding (of differently ordered sums, or skipped)
        np.testing.assert_allclose(o, r, rtol=2 ** -7,
                                   atol=2 ** -8 * np.abs(r).max())


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_conv2d_out_scale_codes(case, cdt):
    x, jk, tk, b, kw, branch = _conv_inputs(case, seed=len(case[0]) + 1)
    jx, tx = _pair(x, cdt)
    jb, tb = _pair(b, cdt)
    cd = None if cdt == "float32" else cdt
    ref = _jit(jops.conv2d, jx, jk, jb, compute_dtype=cd, **kw)
    s_out = float(np.abs(_np(ref)).max()) / 100.0
    rq = np.asarray(_jit(jops.conv2d, jx, jk, jb, compute_dtype=cd,
                         out_scale=s_out, **kw))
    oq = tops.conv2d(tx, tk, tb, compute_dtype=cd, out_scale=s_out,
                     **kw).numpy()
    assert oq.dtype == rq.dtype == np.int8
    ndiff = int((oq != rq).sum())
    print(f"{case[0]} {cdt}: {ndiff} of {oq.size} codes differ")
    if cdt == "float32":
        np.testing.assert_array_equal(oq, rq)
    else:
        assert np.abs(oq.astype(int) - rq.astype(int)).max() <= 1


def test_s8_conv_accumulators_exact():
    """conv_s8 equals an int64 reference conv at the K = 4608 worst case."""
    rng = np.random.default_rng(0)
    x = np.full((1, 512, 5, 5), -127, np.int8)
    w = np.full((8, 512, 3, 3), 127, np.int8)
    w[1] = rng.integers(-127, 128, size=(512, 3, 3), dtype=np.int8)
    acc = tops.conv_s8(torch.as_tensor(x), torch.as_tensor(w), (1, 1),
                       (1, 1, 1, 1)).numpy()
    ref = torch.nn.functional.conv2d(torch.as_tensor(x, dtype=torch.float64),
                                     torch.as_tensor(w, dtype=torch.float64),
                                     padding=1).numpy()
    assert acc.dtype == np.int32 and abs(int(acc.min())) == 127 * 127 * 4608
    np.testing.assert_array_equal(acc, ref.astype(np.int64))


@pytest.mark.parametrize("k,stride", [(1, 1), (1, 2), (3, 1)])
def test_s8_conv_hands_int_mm_a_row_major_matrix(k, stride, monkeypatch):
    """cuBLASLt's int8 GEMM refuses a column-major patch matrix, which a
    1x1 conv's im2col view is (ResNet-50 layer4 at batch 1 raised
    CUBLAS_STATUS_NOT_SUPPORTED on the card): conv_s8 passes _int_mm a
    row-major matrix for every kernel size, and the sums stay exact."""
    seen = []
    orig = torch._int_mm

    def spy(a, b):
        seen.append(a.is_contiguous())
        return orig(a, b)
    monkeypatch.setattr(torch, "_int_mm", spy)
    rng = np.random.default_rng(k + stride)
    x = rng.integers(-127, 128, size=(1, 64, 7, 7), dtype=np.int8)
    w = rng.integers(-127, 128, size=(32, 64, k, k), dtype=np.int8)
    acc = tops.conv_s8(torch.as_tensor(x), torch.as_tensor(w),
                       (stride, stride), (k // 2,) * 4).numpy()
    ref = torch.nn.functional.conv2d(
        torch.as_tensor(x, dtype=torch.float64),
        torch.as_tensor(w, dtype=torch.float64), stride=stride,
        padding=k // 2).numpy()
    assert seen == [True]
    np.testing.assert_array_equal(acc, ref.astype(np.int64))


def _conv_s8_nchw(q, wq, strides=(1, 1), pads=(0, 0, 0, 0),
                  dilations=(1, 1)):
    """The s8 conv as the port ran it before it read channels-last codes:
    the padded input made NCHW-contiguous, a byte-wise (c, ky, kx) patch
    matrix, the OIHW weight as it lies.  The oracle of the gather."""
    o, c, kh, kw = wq.shape
    pt, pl, pb, pr = pads
    x = torch.nn.functional.pad(q, (pl, pr, pt, pb)).contiguous()
    n, _, h, w = x.shape
    (sh, sw), (dh, dw) = strides, dilations
    ho = (h - (kh - 1) * dh - 1) // sh + 1
    wo = (w - (kw - 1) * dw - 1) // sw + 1
    sn, sc, sy, sx = x.stride()
    a = x.as_strided((n, ho, wo, c, kh, kw),
                     (sn, sy * sh, sx * sw, sc, sy * dh, sx * dw))
    a = a.reshape(n * ho * wo, c * kh * kw)
    b = wq.reshape(o, c * kh * kw)
    m, k = a.shape
    kpad, opad = (-k) % 8, (-o) % 8
    a = torch.nn.functional.pad(a, (0, kpad))
    b = torch.nn.functional.pad(b, (0, kpad, 0, opad))
    acc = torch._int_mm(a, b.t())[:m, :o]
    return acc.reshape(n, ho, wo, o).permute(0, 3, 1, 2)


# name -> (k, stride, dilation, pads)
S8_GEOMETRIES = {
    "1x1": (1, 1, 1, (0, 0, 0, 0)),
    "1x1_s2": (1, 2, 1, (0, 0, 0, 0)),
    "3x3": (3, 1, 1, (1, 1, 1, 1)),
    "3x3_s2_upper": (3, 2, 1, (0, 0, 1, 1)),
    "3x3_d2": (3, 1, 2, (2, 2, 2, 2)),
    "7x7_s2": (7, 2, 1, (3, 3, 3, 3)),
}
# name -> (batch, side): M = 4..16 rows, under _int_mm's 17; or M >= 50
S8_SIZES = {"m_under_17": (1, 4), "batch2": (2, 9)}


@pytest.mark.parametrize("size", list(S8_SIZES))
@pytest.mark.parametrize("c", [3, 12, 128, 512])
@pytest.mark.parametrize("geometry", list(S8_GEOMETRIES))
@pytest.mark.parametrize("layout", ["channels_last", "nchw"])
def test_s8_conv_equals_int64_reference(layout, geometry, c, size):
    """conv_s8 equals an int64 reference conv and the NCHW byte gather it
    replaced, bit for bit, on channels-last codes (the W8A8 chain's) and
    NCHW ones, for byte (C = 3), int32-word (12) and int64-word (128, 512)
    gathers, K % 8 != 0 and M under 17 included."""
    k, s, d, pads = S8_GEOMETRIES[geometry]
    n, side = S8_SIZES[size]
    rng = np.random.default_rng(k * 1000 + c + side)
    x = torch.as_tensor(rng.integers(-127, 128, size=(n, c, side, side),
                                     dtype=np.int8))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    w = torch.as_tensor(rng.integers(-127, 128, size=(20, c, k, k),
                                     dtype=np.int8))
    acc = tops.conv_s8(x, w, (s, s), pads, (d, d))
    pt, pl, pb, pr = pads
    ref = torch.nn.functional.conv2d(
        torch.nn.functional.pad(x.double(), (pl, pr, pt, pb)), w.double(),
        stride=s, dilation=d)
    assert acc.dtype == torch.int32
    np.testing.assert_array_equal(acc.numpy(), ref.numpy().astype(np.int64))
    torch.testing.assert_close(acc, _conv_s8_nchw(x, w, (s, s), pads, (d, d)),
                               rtol=0, atol=0)


# layout, k, C -> the counters of one call
S8_PATHS = [
    ("channels_last", 1, 128, {"conv_s8.in_place": 1}),
    ("nchw", 1, 128, {"conv_s8.in_place": 1, "conv_s8.relayout": 1}),
    ("channels_last", 3, 128, {"conv_s8.words": 1}),
    ("nchw", 3, 12, {"conv_s8.words": 1, "conv_s8.relayout": 1}),
    ("channels_last", 3, 3, {"conv_s8.bytes": 1}),
]


@pytest.mark.parametrize("layout,k,c,want", S8_PATHS)
def test_s8_conv_counts_its_path(layout, k, c, want, monkeypatch):
    """Under ``profiler.record`` conv_s8 counts the patch matrix it made:
    a word or byte gather, or the 1x1 stride-1 input itself (handed to
    _int_mm with no copy where it arrived channels-last), and an input
    that arrived NCHW and was copied once."""
    from planer_tpu_torch.runtime import profiler
    rng = np.random.default_rng(k + c)
    x = torch.as_tensor(rng.integers(-127, 128, size=(2, c, 6, 6),
                                     dtype=np.int8))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    w = torch.as_tensor(rng.integers(-127, 128, size=(16, c, k, k),
                                     dtype=np.int8))
    ptrs = []
    orig = torch._int_mm

    def spy(a, b):
        ptrs.append(a.data_ptr())
        return orig(a, b)
    monkeypatch.setattr(torch, "_int_mm", spy)
    pads = (k // 2,) * 4
    with profiler.record() as rec:
        acc = tops.conv_s8(x, w, (1, 1), pads)
    assert rec.counters == want
    assert (ptrs == [x.data_ptr()]) == (want == {"conv_s8.in_place": 1})
    torch.testing.assert_close(acc, _conv_s8_nchw(x, w, (1, 1), pads),
                               rtol=0, atol=0)
    tops.conv_s8(x, w, (1, 1), pads)
    assert rec.counters == want        # the recording has ended


def test_s8_conv_weight_matrix_made_once_per_weight(monkeypatch):
    """The (O, kh*kw*C) weight matrix is made on a weight's first call,
    reused by later ones (inside a CUDA graph capture too, where a weight
    first seen raises, as a device constant does), and dropped with the
    weight."""
    import gc
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.integers(-127, 128, size=(1, 16, 5, 5),
                                     dtype=np.int8))
    w = torch.as_tensor(rng.integers(-127, 128, size=(10, 16, 3, 3),
                                     dtype=np.int8))
    tops.conv_s8(x, w, (1, 1), (1, 1, 1, 1))
    b = tops._WMATS[w]
    assert b.shape == (16, 144) and b.is_contiguous()
    np.testing.assert_array_equal(
        b[:10].numpy(), w.permute(0, 2, 3, 1).reshape(10, 144).numpy())
    assert not b[10:].any()
    monkeypatch.setattr(tops, "_capturing", lambda device: True)
    tops.conv_s8(x, w, (2, 2), (1, 1, 1, 1))
    assert tops._WMATS[w] is b
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        tops.conv_s8(x, w.clone(), (1, 1), (1, 1, 1, 1))
    monkeypatch.undo()
    n = len(tops._WMATS)
    del w, b
    gc.collect()
    assert len(tops._WMATS) == n - 1


def test_int8_resnet18_chain_gathers_words_and_relayouts_at_entries(
        monkeypatch):
    """A calibrated static INT8 ResNet-18 (64 px, b2) on the CPU: on its
    first call, under ``profiler.record``, every s8 conv but the C = 3 stem
    gathers words, an input is relayout only where it enters a chain of s8
    convs from an NCHW producer (the stem, each stage64 block's first conv
    and layer2.0's second, after the cuDNN conv1), and the logits equal,
    bit for bit, those of the NCHW byte gather."""
    import planer_tpu_torch as pt
    from planer_tpu_torch import models as tm
    from planer_tpu_torch.ops.kernels import stage64 as st
    from planer_tpu_torch.ops.kernels import stagen as sg
    from planer_tpu_torch.runtime import profiler
    rng = np.random.default_rng(0)
    net = tm.resnet18(num_classes=8, device="cpu")
    net.optimize()
    pt.calibrate_act_scales(net, [torch.as_tensor(
        rng.standard_normal((2, 3, 64, 64)).astype(np.float32))])
    net.quantize("int8", activations="static")
    net.astype_compute("bfloat16")
    x = rng.standard_normal((2, 3, 64, 64)).astype(np.float32)
    calls = []

    def spy(q, wq, *a, **kw):
        calls.append((tuple(wq.shape),
                      not q.permute(0, 2, 3, 1).is_contiguous()))
        return new(q, wq, *a, **kw)
    new = tops.conv_s8
    for mod in (tops, st, sg):
        monkeypatch.setattr(mod, "conv_s8", spy)
    with profiler.record() as rec:
        y = net.program(x)
    relayouts = [i for i, (_, nchw) in enumerate(calls) if nchw]
    assert [calls[i][0] for i in relayouts] == [
        (64, 3, 7, 7), (64, 64, 3, 3), (64, 64, 3, 3), (128, 128, 3, 3)]
    assert relayouts == [0, 1, 3, 5]
    assert len(calls) == 18 and calls[-1][0] == (512, 512, 3, 3)
    counters = {k: v for k, v in rec.counters.items()
                if k.startswith("conv_s8.")}
    assert counters == {"conv_s8.bytes": 1, "conv_s8.words": 17,
                        "conv_s8.relayout": 4}
    for mod in (tops, st, sg):
        monkeypatch.setattr(mod, "conv_s8", _conv_s8_nchw)
    old = net.program._run(x)
    torch.testing.assert_close(y, old, rtol=0, atol=0)


QADD_CASES = {
    "codes_same_scale": ((0.05, 0.05, 0.05), ("i8", "i8")),
    "codes_rescaled": ((0.05, 0.03, 0.07), ("i8", "i8")),
    "float_plus_codes_to_codes": ((None, 0.05, 0.04), ("f", "i8")),
    "decode_add": ((None, 0.05, None), ("f", "i8")),
    "decode_add_both_codes": ((0.05, 0.02, None), ("i8", "i8")),
    "fallback_float_operands": ((0.05, 0.05, 0.05), ("f", "f")),
}


@pytest.mark.parametrize("name", sorted(QADD_CASES))
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_add_qadd(name, cdt):
    qadd, kinds = QADD_CASES[name]
    rng = np.random.default_rng(len(name))
    ops = []
    for k in kinds:
        if k == "i8":
            ops.append(rng.integers(-127, 128, size=(2, 8, 6, 6),
                                    dtype=np.int8))
        else:
            ops.append(rng.standard_normal((2, 8, 6, 6)).astype(np.float32))
    (ja, ta), (jb, tb) = _pair(ops[0], cdt), _pair(ops[1], cdt)
    cd = None if cdt == "float32" else cdt
    ref = _jit(jops.add, ja, jb, qadd=qadd, compute_dtype=cd)
    out = tops.add(ta, tb, qadd=qadd, compute_dtype=cd)
    assert str(out.dtype).split(".")[-1] == str(ref.dtype)
    o, r = _np(out), _np(ref)
    if out.dtype == torch.int8:
        # a rescaled sum x*r1 + y*r2 may be one FMA in the reference
        d = np.abs(o.astype(int) - r.astype(int))
        print(f"{name} {cdt}: {int((d > 0).sum())} of {d.size} codes differ")
        assert d.max() <= 1 and (d > 0).mean() < 1e-2
        if qadd[0] == qadd[1] == qadd[2]:
            np.testing.assert_array_equal(o, r)     # exact integer sum
    elif out.dtype == torch.float32:
        mag = sum(np.abs(_np(v).astype(np.float32)) * (s or 1.0)
                  for v, s in ((ta, qadd[0]), (tb, qadd[1])))
        assert (np.abs(o - r) <= np.spacing(mag)).all()
    else:
        np.testing.assert_allclose(o, r, rtol=2 ** -7,
                                   atol=2 ** -8 * np.abs(r).max())


def test_relu_on_codes_and_floats():
    rng = np.random.default_rng(1)
    for a in (rng.integers(-127, 128, size=(2, 4, 9, 9), dtype=np.int8),
              rng.standard_normal((2, 4, 9, 9)).astype(np.float32)):
        ja, ta = _pair(a)
        o = tops.relu(ta)
        assert o.dtype == ta.dtype
        np.testing.assert_array_equal(_np(o), _np(_jit(jops.relu, ja)))


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_maxpool_reduce_window(cdt):
    """-inf seed, explicit and ceil_mode padding, asymmetric windows."""
    rng = np.random.default_rng(1)
    ja, ta = _pair(rng.standard_normal((2, 4, 9, 10)).astype(np.float32), cdt)
    for kw in (dict(w=(3, 3), pads=(1, 1, 1, 1), strides=(2, 2)),
               dict(w=(3, 3), pads=(1, 1, 1, 1), strides=(2, 2),
                    impl="shift"),
               dict(w=(2, 2), strides=(2, 2), ceil_mode=1),
               dict(w=(3, 2), pads=(0, 1, 2, 1), strides=(1, 2))):
        o = tops.maxpool(ta, **kw)
        assert o.dtype == ta.dtype
        np.testing.assert_array_equal(_np(o), _np(_jit(jops.maxpool, ja, **kw)))


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("m", [1, 4])
def test_dense_fallback(cdt, m):
    """The ResNet fc (N = 1000) takes the weight-only fallback numerics."""
    rng = np.random.default_rng(m)
    x = rng.standard_normal((m, 512)).astype(np.float32)
    jk, tk = _q(rng, (1000, 512))
    b = (rng.standard_normal(1000) * 0.1).astype(np.float32)
    (jx, tx), (jb, tb) = _pair(x, cdt), _pair(b, cdt)
    r = _np(_jit(jops.dense, jx, jk, jb))
    o = _np(tops.dense(tx, tk, tb))
    tol = 1e-5 if cdt == "float32" else 2 ** -7
    np.testing.assert_allclose(o, r, rtol=tol, atol=tol * np.abs(r).max())
    # an unquantized weight takes the same float path
    w = rng.standard_normal((16, 512)).astype(np.float32)
    np.testing.assert_allclose(
        _np(tops.dense(torch.as_tensor(x), torch.as_tensor(w))),
        np.asarray(jops.dense(jnp.asarray(x), jnp.asarray(w))),
        rtol=1e-5, atol=1e-4)


def test_shape_and_affine_ops():
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 8, 5, 5)).astype(np.float32)
    k = rng.standard_normal((1, 8, 1, 1)).astype(np.float32)
    b = rng.standard_normal((1, 8, 1, 1)).astype(np.float32)
    jx, tx = _pair(x)
    np.testing.assert_allclose(_np(tops.global_average_pool(tx)),
                               _np(jops.global_average_pool(jx)),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_array_equal(_np(tops.flatten(tx)),
                                  _np(jops.flatten(jx)))
    shp = np.array([0, -1, 5], np.int64)
    np.testing.assert_array_equal(_np(tops.reshape(tx, shp)),
                                  _np(jops.reshape(jx, shp)))
    np.testing.assert_array_equal(
        _np(tops.batchnorm(tx, torch.as_tensor(k), torch.as_tensor(b))),
        _np(jops.batchnorm(jx, jnp.asarray(k), jnp.asarray(b))))
