"""The opcodes YOLO-v3 and UNet add to the port (planer_tpu_torch/ops/
torch_ops.py) against the JAX package's (planer_tpu/ops/jax_ops.py under
``jax.jit``, and numpy_ops.py, which folds the static shape chains on the
host), branch by branch, in f32 and bf16.

Tolerances, each measured on the CPU and stated per test:
  * bit-equal: leakyrelu, gather, slice, expand, unsqueeze, transpose,
    cast, range, concat, mul, clip, nearest upsample, and in bf16 sigmoid,
    exp, linear upsample and convtranspose;
  * f32 sigmoid and exp: XLA's exp and torch's differ by an ulp on about a
    tenth of the inputs (2 ulps allowed against jax_ops; 4 against
    numpy_ops, whose exp is further off);
  * f32 linear upsample at a non-integer scale: XLA contracts the lerp into
    FMAs (2 ulps of the largest input);
  * f32 convtranspose: XLA's conv and torch's sum in another order (1e-6 of
    the largest output).
"""
import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch
import torch.nn.functional as F

from planer_tpu import registry as jreg
from planer_tpu.ops import jax_ops as jops
from planer_tpu.ops import numpy_ops as nops
from planer_tpu.ops.qtypes import QTensor as JQ

from planer_tpu_torch import registry as treg
from planer_tpu_torch.ops import torch_ops as tops
from planer_tpu_torch.ops.qtypes import QTensor as TQ

NEW_OPS = ("leakyrelu", "upsample", "concat", "sigmoid", "gather",
           "unsqueeze", "transpose", "slice", "cast", "range", "expand",
           "mul", "clip", "exp", "convtranspose")


def _pair(a, dtype="float32"):
    a = np.asarray(a)
    if not np.issubdtype(a.dtype, np.floating):
        return jnp.asarray(a), torch.as_tensor(a)
    return (jnp.asarray(a).astype(dtype),
            torch.as_tensor(a).to(getattr(torch, dtype)))


def _jit(fn, *args, **kw):
    """fn(*args, **kw) compiled, the kwargs as constants."""
    return jax.jit(lambda *a: fn(*a, **kw))(*args)


def _np(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy() if v.is_floating_point() else v.numpy()
    v = np.asarray(v)
    return v.astype(np.float32) if v.dtype == jnp.bfloat16 else v


def _equal(t, j):
    a, b = _np(t), _np(j)
    assert a.shape == b.shape, (a.shape, b.shape)
    np.testing.assert_array_equal(a, b)


def _ulps(t, j, n):
    a, b = _np(t), _np(j).astype(np.float32)
    assert a.shape == b.shape
    assert (np.abs(a - b) <= n * np.spacing(np.abs(b))).all(), \
        float(np.abs(a - b).max())


def test_registry_holds_the_new_opcodes():
    """Each opcode the two models add is registered, with the JAX registry's
    static (host) operands."""
    for name in NEW_OPS:
        assert name in treg.OPS, name
        assert treg.OPS[name].static_args == jreg.OPS[name].static_args, name
        assert not treg.OPS[name].data_dependent
    assert treg.OPS["slice"].static_args == (1, 2, 3, 4)
    assert treg.OPS["range"].static_args == (0, 1, 2)
    # every opcode of the JAX registry is ported since the op library's
    # slice (test_torch_ops_lib.py holds the parity), and the port adds
    # its own layernorm
    assert len(jreg.OPS) == 83 and len(treg.OPS) == 84


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_leakyrelu_rounds_alpha_to_the_dtype(dtype):
    """Bit-equal: alpha is rounded to x's dtype before the multiply, as the
    reference does.  F.leaky_relu multiplies by the double and rounds once,
    which in bf16 gives other results (the pin)."""
    rng = np.random.default_rng(1)
    x = (rng.standard_normal((2, 16, 9, 9)) * 8).astype(np.float32)
    jx, tx = _pair(x, dtype)
    out = tops.leakyrelu(tx, alpha=0.1)
    _equal(out, _jit(jops.leakyrelu, jx, alpha=0.1))
    if dtype == "float32":
        _equal(out, nops.leakyrelu(x, alpha=0.1))
    else:
        assert float(tops.scalar(0.1, tx, tx.dtype)) == 0.10009765625
        apart = int((F.leaky_relu(tx, 0.1) != out).sum())
        print(f"F.leaky_relu: {apart} of {out.numel()} bf16 outputs apart")
        assert apart > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_sigmoid_and_exp(dtype):
    """bf16: bit-equal, sigmoid as 1 / (1 + exp(-x)) with every step rounded
    (torch.sigmoid rounds once and puts a third of the outputs an ulp
    apart: the pin).  f32: within 2 ulps of jax_ops, 4 of numpy_ops (exp
    polynomials)."""
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((4, 8, 16, 16)) * 4).astype(np.float32)
    jx, tx = _pair(x, dtype)
    for name in ("sigmoid", "exp"):
        out = getattr(tops, name)(tx)
        ref = _jit(getattr(jops, name), jx)
        assert out.dtype == tx.dtype
        if dtype == "bfloat16":
            _equal(out, ref)
        else:
            _ulps(out, ref, 2)
            _ulps(out, getattr(nops, name)(x), 4)
    if dtype == "bfloat16":
        apart = int((torch.sigmoid(tx) != tops.sigmoid(tx)).sum())
        print(f"torch.sigmoid: {apart} of {tx.numel()} bf16 outputs apart")
        assert apart > 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_clip_bounds(dtype):
    """Bit-equal: attribute bounds rounded to x's dtype (0.1 in bf16),
    operand bounds, one-sided and no bound (identity)."""
    rng = np.random.default_rng(3)
    x = (rng.standard_normal((2, 6, 7, 7)) * 3).astype(np.float32)
    jx, tx = _pair(x, dtype)
    for kw in (dict(min=-0.1, max=0.1), dict(min=-20.0, max=20.0),
               dict(min=0.0), dict(max=0.3)):
        _equal(tops.clip(tx, **kw), _jit(jops.clip, jx, **kw))
    assert tops.clip(tx) is tx
    lo, hi = np.float32(-0.5), np.float32(0.7)
    (jlo, tlo), (jhi, thi) = _pair(lo, dtype), _pair(hi, dtype)
    _equal(tops.clip(tx, tlo, thi),
           jax.jit(jops.clip)(jx, jlo, jhi))


def test_binary_ops_promote_by_dtype():
    """mul and the plain add promote as jnp.result_type does, by dtype alone:
    a bf16 tensor times a 0-dim f32 tensor is f32 (torch alone would give
    bf16: the pin), and equal dtypes stay as they are."""
    rng = np.random.default_rng(4)
    a = rng.standard_normal((2, 3, 5, 5)).astype(np.float32)
    ja, ta = _pair(a, "bfloat16")
    s = np.float32(1.1)
    js, ts = jnp.asarray(s), torch.tensor(s)
    for name in ("mul", "add"):
        out = getattr(tops, name)(ta, ts)
        ref = jax.jit(getattr(jops, name))(ja, js)
        assert out.dtype == torch.float32 and ref.dtype == jnp.float32
        _equal(out, ref)
    assert (ta * ts).dtype == torch.bfloat16
    b = rng.standard_normal((1, 3, 1, 5)).astype(np.float32)
    jb, tb = _pair(b, "bfloat16")
    _equal(tops.mul(ta, tb), jax.jit(jops.mul)(ja, jb))
    assert tops.mul(ta, tb).dtype == torch.bfloat16


def test_concat_promotes():
    """The decode's join: f32 xy with bf16 wh and rest gives f32, the bf16
    values exact; int64 shape pieces join as int64."""
    rng = np.random.default_rng(5)
    xy = rng.standard_normal((1, 3, 4, 4, 2)).astype(np.float32)
    wh = rng.standard_normal((1, 3, 4, 4, 2)).astype(np.float32)
    (jxy, txy), (jwh, twh) = _pair(xy), _pair(wh, "bfloat16")
    out = tops.concat(txy, twh, twh, axis=4)
    ref = jax.jit(lambda *v: jops.concat(*v, axis=4))(jxy, jwh, jwh)
    assert out.dtype == torch.float32 and ref.dtype == jnp.float32
    _equal(out, ref)
    pieces = [np.array([0, 3, 9], np.int64), np.array([13], np.int64),
              np.array([13], np.int64)]
    out = tops.concat(*[torch.as_tensor(p) for p in pieces], axis=0)
    assert out.dtype == torch.int64
    _equal(out, nops.concat(*pieces, axis=0))


def test_gather_takes_negative_and_scalar_indices():
    """jnp.take semantics, bit-equal: negative indices count from the end, a
    0-dim index drops the axis, a 2-d index adds its shape."""
    rng = np.random.default_rng(6)
    x = rng.standard_normal((4, 5, 6)).astype(np.float32)
    jx, tx = _pair(x)
    for idx, axis in ((np.array(2), 0), (np.array(-1), 2),
                      (np.array([0, -2, 3]), 1),
                      (np.array([[1, -1], [0, 2]]), 2)):
        out = tops.gather(tx, torch.as_tensor(idx), axis=axis)
        _equal(out, _jit(jops.gather, jx, idx=idx, axis=axis))
        _equal(out, nops.gather(x, idx, axis=axis))
    shp = np.array([1, 27, 13, 13], np.int64)     # the decode's shape read
    out = tops.gather(torch.as_tensor(shp), torch.tensor(-2))
    assert out.ndim == 0 and int(out) == 13


@pytest.mark.parametrize("case", [
    ([0], [2], [3], None), ([4], [9], [3], None), ([-3], [100], [1], None),
    ([-100, 1], [-1, 7], [0, 3], [1, 2]), ([5], [-100], [2], [-1]),
    ([1, 0], [4, 6], [-1, -2], None)])
def test_slice_follows_onnx(case):
    """Bit-equal: ONNX starts/ends/axes/steps with Python's slice semantics
    (negative bounds, clamping, negative steps, negative axes)."""
    starts, ends, axes, steps = case
    rng = np.random.default_rng(7)
    x = rng.standard_normal((3, 5, 7, 9)).astype(np.float32)
    jx, tx = _pair(x)
    args = [np.array(v, np.int64) for v in (starts, ends, axes)]
    if steps is not None:
        args.append(np.array(steps, np.int64))
    out = tops.slice_(tx, *args)
    _equal(out, _jit(lambda v: jops.slice_(v, *args), jx))
    _equal(out, nops.slice_(x, *args))


def test_expand_unsqueeze_transpose():
    """Bit-equal shape ops: expand to np.broadcast_shapes (fewer and more
    dims), unsqueeze at output axes (negative ones too), transpose with and
    without a permutation."""
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 1, 4)).astype(np.float32)
    jx, tx = _pair(x)
    for shp in ([2, 3, 5, 4], [1, 4], [3, 6, 1]):
        s = np.array(shp, np.int64)
        out = tops.expand(tx, torch.as_tensor(s))
        _equal(out, _jit(jops.expand, jx, shp=s))
        _equal(out, nops.expand(x, s))
    for axes in ([0], [0, 1, 4], [-1], [1, -1]):
        out = tops.unsqueeze(tx, axes=axes)
        _equal(out, _jit(jops.unsqueeze, jx, axes=axes))
        _equal(out, nops.unsqueeze(x, axes=axes))
    for axis in (None, [0, 2, 1], [2, 0, 1]):
        _equal(tops.transpose(tx, axis=axis),
               _jit(jops.transpose, jx, axis=axis))


def test_cast_and_range_are_host_values():
    """range: int64 on the host from integer bounds, floats truncated;
    cast to a dtype name, the "flaot32" typo accepted; bit-equal to the
    numpy ops that fold these chains in the JAX tracer."""
    for args in ((0, 13, 1), (2, 11, 3), (5, 0, -2), (0.0, 7.9, 2.0)):
        out = tops.arange(*[torch.tensor(a) for a in args])
        assert out.device.type == "cpu" and out.dtype == torch.int64
        _equal(out, nops.arange(*args))
        _equal(out, jops.arange(*[np.asarray(a) for a in args]))
    r = torch.arange(6)
    for name in ("float32", "flaot32", "bfloat16", "int32"):
        out = tops.cast(r, dtype=name)
        want = "float32" if name == "flaot32" else name
        assert out.dtype == getattr(torch, want)
        _equal(out, _jit(jops.cast, jnp.arange(6), dtype=want))
    x = np.array([1.7, -2.5, 3.2], np.float32)
    _equal(tops.cast(torch.as_tensor(x), dtype="int64"),
           nops.cast(x, dtype="int64"))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", ["nearest", "linear"])
@pytest.mark.parametrize("k", [(1, 1, 2, 2), (1, 1, 1.5, 2.5), (), (3,)])
def test_upsample(k, mode, dtype):
    """Integer scale 2 (YOLO's route: a broadcast copy), non-integer
    scales, and empty scales with an explicit size.  Nearest is bit-equal;
    linear is bit-equal in bf16 and within 2 f32 ulps of the largest input
    in f32 (XLA contracts the lerp into FMAs)."""
    rng = np.random.default_rng(9)
    x = (rng.standard_normal((2, 3, 6, 10)) * 3).astype(np.float32)
    jx, tx = _pair(x, dtype)
    kk = np.array(k[:0] if len(k) == 1 else k, np.float32)
    kw = dict(mode=mode, size=np.array([1, 3, 9, 17], np.int64)
              if kk.size == 0 else None)
    out = tops.upsample(tx, torch.as_tensor(kk), **kw)
    ref = _jit(jops.upsample, jx, k=kk, **kw)
    assert out.dtype == tx.dtype
    if mode == "nearest" or dtype == "bfloat16":
        _equal(out, ref)
    else:
        assert np.abs(_np(out) - _np(ref)).max() \
            <= 2 * np.spacing(np.abs(x).max())
    if dtype == "float32" and mode == "nearest":
        _equal(out, nops.upsample(x, kk, **kw))


CONVT_CASES = {
    # name: (in ch, out ch, k, strides, pads, output_padding, group)
    "s2": (8, 6, 2, (2, 2), (0, 0, 0, 0), (0, 0), 1),
    "s2_k3": (8, 6, 3, (2, 2), (0, 0, 0, 0), (0, 0), 1),
    "s3_pads_outpad": (8, 6, 3, (3, 3), (1, 2, 0, 1), (1, 2), 1),
    "group2": (8, 6, 3, (2, 2), (1, 1, 1, 1), (1, 1), 2),
    "crop_past_kernel": (4, 4, 2, (2, 2), (2, 0, 3, 1), (0, 1), 1),
}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", sorted(CONVT_CASES))
def test_convtranspose(case, dtype):
    """ONNX ConvTranspose: stride 2 (UNet's), stride 3 with asymmetric pads
    and output_padding, group 2, pads past the kernel's reach.  bf16
    bit-equal; f32 within 1e-6 of the largest output (sum order)."""
    cin, cout, k, strides, pads, op, g = CONVT_CASES[case]
    rng = np.random.default_rng(len(case))
    x = rng.standard_normal((2, cin, 7, 6)).astype(np.float32)
    w = (rng.standard_normal((cin, cout // g, k, k)) * 0.3).astype(np.float32)
    b = rng.standard_normal(cout).astype(np.float32)
    (jx, tx), (jw, tw), (jb, tb) = (_pair(v, dtype) for v in (x, w, b))
    kw = dict(strides=strides, pads=pads, output_padding=op, group=g)
    out = tops.conv_transpose2d(tx, tw, tb, **kw)
    ref = _jit(jops.conv_transpose2d, jx, jw, jb, **kw)
    assert tuple(out.shape) == ref.shape and out.dtype == tx.dtype
    if dtype == "bfloat16":
        _equal(out, ref)
        return
    refs = [ref]
    if max(pads) <= k - 1:     # numpy_ops' zero-stuffed form cannot crop
        refs.append(nops.conv_transpose2d(x, w, b, **kw))
    for r in refs:
        assert np.abs(_np(out) - _np(r)).max() <= 1e-6 * np.abs(_np(r)).max()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_convtranspose_quantized_weights(dtype):
    """A QTensor weight (int8, per-output-channel scales on axis 1, as
    quantize_net makes them) dequantizes to x's dtype first, as in the
    reference: bf16 bit-equal, f32 within 1e-6 of the largest output."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((1, 16, 8, 8)).astype(np.float32)
    q = rng.integers(-127, 128, (16, 8, 2, 2), dtype=np.int8)
    s = ((0.5 + rng.random((1, 8, 1, 1))) / 256.0).astype(np.float32)
    jx, tx = _pair(x, dtype)
    jk = JQ(jnp.asarray(q), jnp.asarray(s))
    tk = TQ(torch.as_tensor(q), torch.as_tensor(s))
    out = tops.conv_transpose2d(tx, tk, None, strides=(2, 2))
    ref = jax.jit(functools.partial(jops.conv_transpose2d, K=jk,
                                    strides=(2, 2)))(jx)
    assert tuple(out.shape) == ref.shape == (1, 8, 16, 16)
    if dtype == "bfloat16":
        _equal(out, ref)
    else:
        assert np.abs(_np(out) - _np(ref)).max() \
            <= 1e-6 * np.abs(_np(ref)).max()
