"""The rest of the op library (the 55 opcodes the port's op-library slice
adds to ``planer_tpu_torch/ops/torch_ops.py``) against the JAX package's:
``jax_ops`` under ``jax.jit`` (the compiled reference) and ``numpy_ops``,
in f32 and, where the op takes floats, bf16 — plus the registry's parity
with the JAX package's.

Tolerances, each measured on the CPU:
  * bit-equal: the arithmetic, comparison, index and shape ops in f32 and
    bf16, ``resize`` (nearest in both, linear in bf16), ``averagepool`` and ``mean`` (a constant divisor is a float32
    multiply by its reciprocal, as XLA compiles it), bf16 ``softmax``,
    ``logsoftmax`` and ``instancenormalization`` (exponentials and squares
    enter their float32 sums unrounded, XLA's excess precision), ``erf`` in
    "lut" mode, and ``topk``/``argmax``/``argmin`` with ties;
  * linear ``resize`` in f32: XLA contracts the lerp into FMAs (2 ulps of
    the largest input, as test_torch_ops_ext.py bounds upsample);
  * transcendental ops in f32 (tanh, erf, sqrt, log, pow, elu, softplus,
    gelu): within 4 ulps of the larger of |x| and |y| (XLA's polynomials
    are not torch's: tanh 3, erf 4, elu 4 ulps of y; gelu's erfc tail 1
    ulp of x but 39 of the tiny y there);
  * ``hardsigmoid`` in f32: XLA contracts x * alpha + beta into an FMA;
    the port rounds each step (one ulp of |x * alpha| plus one of |y|);
  * sum-order ops in f32 (``reducesum``, ``reducemean``, ``reduceprod``,
    ``softmax``, ``logsoftmax``, ``instancenormalization``): max|d| <=
    1e-6 max|y| (measured 1.2e-7 to 1.7e-7); ``matmul``, ``lstm``, ``gru``:
    1e-5 (measured 1.5e-7 to 6e-7);
  * bf16 ``gelu`` (exact form): one bf16 ulp (XLA's float32 erfc
    polynomial rounds to another bf16 neighbour in a sixth of the
    elements); bf16 ``lstm``/``gru``: 2 bf16 ulps of max|y| (their sums).
Against ``numpy_ops`` the same, except that every non-bit-equal case is
held to 1e-6 of max|y| (numpy's float64 intermediates).

Index results are int64 in the port (ONNX's type) and int32 in the JAX
package without x64: values are compared, and the port's dtype is
checked to be int64.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from planer_tpu import registry as jreg
from planer_tpu.ops import modes as jmodes

from planer_tpu_torch import registry as treg
from planer_tpu_torch.ops import modes as tmodes

NEW = ['abs', 'argmax', 'argmin', 'averagepool', 'ceil', 'const',
       'constantofshape', 'depthtospace', 'div', 'elu', 'equal', 'erf',
       'floor', 'gelu', 'gmp', 'greater', 'greaterorequal', 'gru',
       'hardsigmoid', 'identity', 'instancenormalization', 'log',
       'logsoftmax', 'lstm', 'matmul', 'max', 'mean', 'min', 'neg',
       'nonzero', 'pad', 'pow', 'prelu', 'reciprocal', 'reducemax',
       'reducemean', 'reducemin', 'reduceprod', 'reducesum', 'resize',
       'round', 'scatternd', 'sign', 'softmax', 'softplus', 'spacetodepth',
       'split', 'sqrt', 'squeeze', 'sub', 'sum', 'tanh', 'tile', 'topk',
       'where']


def _rng(seed=0):
    return np.random.default_rng(seed)


def _x(shape=(2, 8, 9, 11), scale=3.0, seed=0):
    return (_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _pos(shape=(2, 8, 9, 11), seed=1):
    return (np.abs(_rng(seed).standard_normal(shape)) * 3 + 0.1).astype(
        np.float32)


def _np(v):
    if isinstance(v, torch.Tensor):
        v = v.cpu()
        return v.float().numpy() if v.is_floating_point() else v.numpy()
    v = np.asarray(v)
    return v.astype(np.float32) if v.dtype == jnp.bfloat16 else v


def _cast_j(a, dt):
    a = np.asarray(a)
    return jnp.asarray(a).astype(dt) if a.dtype.kind == "f" \
        else jnp.asarray(a)


def _cast_t(a, dt):
    t = torch.as_tensor(np.asarray(a))
    return t.to(getattr(torch, dt)) if t.is_floating_point() else t


def run_jax(op, args, kw, dt="float32"):
    """The JAX function under jit; ``static_args`` operands stay host
    constants, as the tracer hands them over."""
    spec = jreg.OPS[op]
    static = {p: np.asarray(a) for p, a in enumerate(args)
              if p in spec.static_args and a is not None}
    dyn = [p for p, a in enumerate(args) if p not in static]

    def f(*d):
        full = list(args)
        for p, v in zip(dyn, d):
            full[p] = v
        for p, v in static.items():
            full[p] = v
        return spec.jax_fn(*full, **kw)
    return jax.jit(f)(*[None if args[p] is None else _cast_j(args[p], dt)
                        for p in dyn])


def run_torch(op, args, kw, dt="float32"):
    """The port's function; ``static_args`` operands stay as the program
    holds them (host values, never cast to the compute dtype)."""
    static = treg.OPS[op].static_args
    return treg.OPS[op].fn(*[
        None if a is None else _cast_t(a, "float32" if p in static else dt)
        for p, a in enumerate(args)], **kw)


def _outs(v):
    return v if isinstance(v, tuple) else (v,)


def _bf16_ulp(v):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(v), 1e-30))) - 7)


def check(kind, out, ref, x=None, dt="float32", what="jax", scale=None):
    """Hold the port's output to the reference by the case's tolerance
    (``scale``: the sums' magnitude for a reduction, else max|y|)."""
    a, b = _np(out), _np(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    if a.dtype.kind in "biu" or b.dtype.kind in "biu":
        np.testing.assert_array_equal(a, b)
        return
    b = b.astype(np.float32)
    d = np.abs(a.astype(np.float64) - b)
    big = float(np.abs(b).max()) if b.size else 0.0
    if scale is not None:
        big = max(big, scale)
    if what == "numpy" and kind == "exact" and NUMPY_ROUNDS:
        kind = "sum"
    if kind == "exact" or (dt == "bfloat16" and kind in
                           ("trans", "sum", "fma", "lerp")):
        if what == "numpy" and kind != "exact":
            assert d.max() <= 1e-6 * big, float(d.max())
            return
        np.testing.assert_array_equal(a, b)
    elif kind == "trans":
        scale = np.maximum(np.abs(b), np.abs(x) if x is not None else 0)
        if what == "numpy":
            assert d.max() <= 1e-6 * big, float(d.max())
        else:
            assert (d <= 4 * np.spacing(scale.astype(np.float32))).all(), \
                float((d / np.spacing(scale.astype(np.float32))).max())
    elif kind == "fma":
        if what == "numpy":
            np.testing.assert_array_equal(a, b)
        else:
            xa = np.abs(x * np.float32(0.2)).astype(np.float32)
            assert (d <= np.spacing(xa) + np.spacing(np.abs(b))).all()
    elif kind == "lerp":
        # XLA contracts the f32 lerp into FMAs; bf16 is bit-equal
        assert d.max() <= 2 * np.spacing(np.abs(x).max()), float(d.max())
    elif kind == "sum":
        assert d.max() <= 1e-6 * big, float(d.max() / big)
    elif kind == "mm":
        assert d.max() <= 1e-5 * big, float(d.max() / big)
    elif kind == "bf16ulp":
        if dt == "float32":
            check("trans", out, ref, x, dt, what)
        else:
            assert (d <= _bf16_ulp(b)).all()
    elif kind == "mm_bf16":
        if dt == "float32":
            check("mm", out, ref, x, dt, what)
        else:
            assert d.max() <= 2 * _bf16_ulp(big), float(d.max())
    else:
        raise ValueError(kind)


# ---------------------------------------------------------------- the table

# ops whose compiled reference divides by a constant through its float32
# reciprocal, where numpy_ops divides: against numpy_ops within 1e-6 of
# max|y| (set per case while it runs)
NUMPY_ROUNDS = False
ROUNDING_OPS = {"mean", "averagepool"}
# reductions: the tolerance scales with the sum of the magnitudes
REDUCTIONS = {"reducesum", "reducemean", "reduceprod"}

def _where_args():
    x, y = _x(), _x(seed=2)
    return [x > 0.5, x, y]


def _scatter_args():
    data = _x((4, 5, 6))
    idx = np.array([[[0, 1], [2, 3]], [[3, 0], [1, 4]]], np.int64)
    return [data, idx, _x((2, 2, 6), seed=3)]


# id, opcode, args builder, kwargs, tolerance kind, bf16 too
CASES = [
    ("abs", "abs", lambda: [_x()], {}, "exact", True),
    ("neg", "neg", lambda: [_x()], {}, "exact", True),
    ("floor", "floor", lambda: [_x()], {}, "exact", True),
    ("ceil", "ceil", lambda: [_x()], {}, "exact", True),
    ("round", "round", lambda: [np.round(_x() * 2) / 2], {}, "exact", True),
    ("sign", "sign", lambda: [_x()], {}, "exact", True),
    ("identity", "identity", lambda: [_x()], {}, "exact", True),
    ("sub", "sub", lambda: [_x(), _x(seed=2)], {}, "exact", True),
    ("div", "div", lambda: [_x(), _pos()], {}, "exact", True),
    ("div_int", "div", lambda: [np.arange(-6, 6, dtype=np.int32),
                                np.full(12, 4, np.int32)], {}, "exact",
     False),
    ("reciprocal", "reciprocal", lambda: [_pos()], {}, "exact", True),
    ("equal", "equal", lambda: [np.round(_x()), np.round(_x(seed=2))], {},
     "exact", True),
    ("greater", "greater", lambda: [_x(), _x(seed=2)], {}, "exact", True),
    ("greaterorequal", "greaterorequal",
     lambda: [np.round(_x()), np.round(_x(seed=2))], {}, "exact", True),
    ("where", "where", _where_args, {}, "exact", True),
    ("min", "min", lambda: [_x(), _x(seed=2), _x(seed=3)], {}, "exact",
     True),
    ("max", "max", lambda: [_x(), _x(seed=2)], {}, "exact", True),
    ("sum", "sum", lambda: [_x(), _x(seed=2), _x(seed=3)], {}, "exact",
     True),
    ("mean", "mean", lambda: [_x(), _x(seed=2), _pos()], {}, "exact", True),
    ("prelu", "prelu", lambda: [_x(), (_rng(4).random(8) * 0.3).astype(
        np.float32)], {}, "exact", True),
    ("hardsigmoid", "hardsigmoid", lambda: [_x()], {}, "fma", True),
    ("hardsigmoid_ab", "hardsigmoid", lambda: [_x()],
     {"alpha": 0.25, "beta": 0.5}, "exact", True),
    ("tanh", "tanh", lambda: [_x()], {}, "trans", True),
    ("erf", "erf", lambda: [_x(scale=1.5)], {}, "trans", True),
    ("sqrt", "sqrt", lambda: [_pos()], {}, "trans", True),
    ("log", "log", lambda: [_pos()], {}, "trans", True),
    ("pow", "pow", lambda: [_pos(), np.asarray(1.7, np.float32)], {},
     "trans", True),
    ("elu", "elu", lambda: [_x()], {}, "trans", True),
    ("elu_alpha", "elu", lambda: [_x()], {"alpha": 0.5}, "trans", True),
    ("softplus", "softplus", lambda: [_x(scale=10)], {}, "trans", True),
    ("gelu", "gelu", lambda: [_x()], {}, "bf16ulp", True),
    ("gelu_tanh", "gelu", lambda: [_x()], {"approximate": "tanh"}, "trans",
     True),
    ("softmax", "softmax", lambda: [_x()], {"axis": 1}, "sum", True),
    ("softmax_last", "softmax", lambda: [_x()], {}, "sum", True),
    ("logsoftmax", "logsoftmax", lambda: [_x()], {"axis": -1}, "sum", True),
    ("instancenormalization", "instancenormalization",
     lambda: [_x(), (_rng(5).random(8) + 0.5).astype(np.float32),
              _x((8,), 1.0, 6)], {"epsilon": 1e-5}, "sum", True),
    ("reducesum", "reducesum", lambda: [_x()], {"axes": [2, 3]}, "sum",
     True),
    ("reducesum_all", "reducesum", lambda: [_x()], {"keepdims": 0}, "sum",
     True),
    ("reducemean", "reducemean", lambda: [_x()], {"axes": [1],
                                                   "keepdims": 0}, "sum",
     True),
    ("reducemax", "reducemax", lambda: [_x()], {"axes": [-1]}, "exact",
     True),
    ("reducemin", "reducemin", lambda: [_x()], {"axes": [0, 2]}, "exact",
     True),
    ("reduceprod", "reduceprod", lambda: [_x(scale=0.3) + 1],
     {"axes": [2, 3]}, "sum", True),
    ("gmp", "gmp", lambda: [_x()], {}, "exact", True),
    ("matmul", "matmul", lambda: [_x((2, 8, 9, 11)), _x((2, 8, 11, 7),
                                                        seed=2)],
     {}, "mm", True),
    ("averagepool", "averagepool", lambda: [_x()],
     {"w": [3, 3], "pads": [1, 1, 1, 1], "strides": [2, 2]}, "exact", True),
    ("split", "split", lambda: [_x(), np.array([3, 5], np.int64)],
     {"axis": 1}, "exact", True),
    ("split_short", "split", lambda: [_x(), np.array([2, 3], np.int64)],
     {"axis": -1}, "exact", True),
    ("tile", "tile", lambda: [_x((2, 3, 4)), np.array([2, 1, 3], np.int64)],
     {}, "exact", True),
    ("pad", "pad", lambda: [_x(), np.array([0, 0, 1, 2, 0, 1, 3, 0],
                                           np.int64)],
     {"constant_value": 1.5}, "exact", True),
    ("pad_reflect", "pad", lambda: [_x(), np.array([0, 0, 2, 1, 0, 0, 1, 2],
                                                   np.int64)],
     {"mode": "reflect"}, "exact", True),
    ("pad_edge", "pad", lambda: [_x(), np.array([0, 1, 2, 1, 0, 0, 1, 2],
                                                np.int64)],
     {"mode": "edge"}, "exact", True),
    ("squeeze", "squeeze", lambda: [_x((2, 1, 5, 1)), np.array([1, -1],
                                                               np.int64)],
     {}, "exact", True),
    ("squeeze_all", "squeeze", lambda: [_x((1, 3, 1, 2))], {}, "exact",
     True),
    ("const", "const", lambda: [], {"value": [1.5, 2.0], "dtype": "float32"},
     "exact", False),
    ("const_int", "const", lambda: [], {"value": 7, "dtype": "int64"},
     "exact", False),
    ("constantofshape", "constantofshape",
     lambda: [np.array([2, 3, 4], np.int64)], {"value": 0.5}, "exact",
     False),
    ("constantofshape_int", "constantofshape",
     lambda: [np.array([3, 2], np.int64)], {"value": 3, "dtype": "int64"},
     "exact", False),
    ("scatternd", "scatternd", _scatter_args, {}, "exact", True),
    ("spacetodepth", "spacetodepth", lambda: [_x((2, 3, 6, 8))],
     {"blocksize": 2}, "exact", True),
    ("depthtospace_dcr", "depthtospace", lambda: [_x((2, 12, 3, 4))],
     {"blocksize": 2}, "exact", True),
    ("depthtospace_crd", "depthtospace", lambda: [_x((2, 12, 3, 4))],
     {"blocksize": 2, "mode": "CRD"}, "exact", True),
    ("topk", "topk", lambda: [_x(), np.array([4], np.int64)], {"axis": 1},
     "exact", True),
    ("topk_smallest", "topk", lambda: [_x(), np.array([3], np.int64)],
     {"largest": 0}, "exact", True),
    ("argmax", "argmax", lambda: [_x()], {"axis": 1}, "exact", True),
    ("argmin", "argmin", lambda: [_x()], {"axis": -1, "keepdims": 0},
     "exact", True),
    ("resize", "resize", lambda: [_x(), None, np.array([1, 1, 2, 1.5],
                                                       np.float32)],
     {"mode": "linear"}, "lerp", True),
]

# every case in f32, and in bf16 where the op takes floats
PARAMS = [pytest.param(c, dt, id=f"{c[0]}-{dt}") for c in CASES
          for dt in ("float32", "bfloat16") if dt == "float32" or c[5]]


def test_cases_cover_every_new_opcode():
    """The table (and the recurrent tests below) apply each of the 55
    opcodes the op-library slice adds."""
    covered = {c[1] for c in CASES} | {"lstm", "gru", "nonzero"}
    assert sorted(covered & set(NEW)) == sorted(NEW)
    assert len(NEW) == 55


def test_registry_matches_the_jax_package():
    """The port registers the JAX registry's opcodes, with the same static
    (host) operands and the same data-dependent ones, and beside them only
    its own ``layernorm`` (ConvNeXt; tests/test_torch_convnext.py)."""
    assert set(treg.OPS) == set(jreg.OPS) | {"layernorm"}
    for name, spec in jreg.OPS.items():
        t = treg.OPS[name]
        assert t.static_args == spec.static_args, name
        assert t.data_dependent == spec.data_dependent, name
    assert [n for n, s in treg.OPS.items() if s.data_dependent] == \
        ["nonzero"]


@pytest.mark.parametrize("case,dt", PARAMS)
def test_op_matches_jax_and_numpy(case, dt):
    cid, op, build, kw, kind, _ = case
    global NUMPY_ROUNDS
    args = build()
    ref = run_jax(op, args, kw, dt)
    out = run_torch(op, args, kw, dt)
    x = args[0] if args and np.asarray(args[0]).dtype.kind == "f" else None
    scale = None
    if op in REDUCTIONS:
        scale = float(np.abs(jreg.OPS[op].numpy_fn(np.abs(x), **kw)).max())
    for o, r in zip(_outs(out), _outs(ref)):
        if isinstance(o, torch.Tensor) and o.is_floating_point():
            assert o.dtype == getattr(torch, dt)
        check(kind, o, r, x, dt, scale=scale)
    if dt == "float32":
        nref = jreg.OPS[op].numpy_fn(*args, **kw)
        NUMPY_ROUNDS = op in ROUNDING_OPS
        try:
            for o, r in zip(_outs(out), _outs(nref)):
                check(kind, o, r, x, dt, what="numpy", scale=scale)
        finally:
            NUMPY_ROUNDS = False


@pytest.mark.parametrize("op", ["topk", "argmax", "argmin"])
def test_index_results_are_int64(op):
    args = {"topk": [_x(), np.array([2], np.int64)]}.get(op, [_x()])
    out = _outs(run_torch(op, args, {}))[-1]
    assert out.dtype == torch.int64
    ref = _outs(run_jax(op, args, {}))[-1]
    assert ref.dtype == jnp.int32     # the JAX package without x64


# ------------------------------------------------------------------- ties

def _ties(seed=7):
    """Small integers as floats: every row has repeated values."""
    return _rng(seed).integers(-3, 4, (3, 5, 12)).astype(np.float32)


@pytest.mark.parametrize("largest", [1, 0])
@pytest.mark.parametrize("axis", [-1, 1])
def test_topk_orders_ties_by_index(largest, axis):
    """lax.top_k returns equal values lower index first; the port's stable
    sort does too (torch.topk on CUDA would not)."""
    x = _ties()
    args, kw = [x, np.array([4], np.int64)], {"axis": axis,
                                              "largest": largest}
    vals, idx = run_torch("topk", args, kw)
    jv, ji = run_jax("topk", args, kw)
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(ji))
    nv, ni = jreg.OPS["topk"].numpy_fn(*args, **kw)
    np.testing.assert_array_equal(idx.numpy(), ni)
    # the ties are real: some selected pairs hold equal values
    srt = np.sort(vals.numpy(), axis=axis)
    assert (np.diff(srt, axis=axis) == 0).any()


@pytest.mark.parametrize("keepdims", [1, 0])
@pytest.mark.parametrize("last", [0, 1])
@pytest.mark.parametrize("op", ["argmax", "argmin"])
def test_arg_reduce_ties(op, last, keepdims):
    x = _ties(8)
    kw = {"axis": 2, "keepdims": keepdims, "select_last_index": last}
    out = run_torch(op, [x], kw)
    np.testing.assert_array_equal(out.numpy(), np.asarray(
        run_jax(op, [x], kw)))
    np.testing.assert_array_equal(out.numpy(),
                                  jreg.OPS[op].numpy_fn(x, **kw))


# ------------------------------------------------------------ averagepool

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("auto_pad", [None, "SAME_UPPER", "SAME_LOWER"])
@pytest.mark.parametrize("ceil_mode", [0, 1])
@pytest.mark.parametrize("cip", [0, 1])
def test_averagepool_divisor(cip, ceil_mode, auto_pad, dt):
    """The divisor counts the window's overlap with the padded extent
    (count_include_pad) or with the input; ceil mode's extension never
    counts.  Bit-equal: the divisor's float32 reciprocal multiplies."""
    x = _x((2, 3, 10, 13))
    kw = {"w": [3, 3], "strides": [2, 2], "count_include_pad": cip,
          "ceil_mode": ceil_mode}
    if auto_pad:
        kw["auto_pad"] = auto_pad
    else:
        kw["pads"] = [1, 0, 0, 1]
    out = run_torch("averagepool", [x], kw, dt)
    check("exact", out, run_jax("averagepool", [x], kw, dt), dt=dt)
    if dt == "float32":
        check("sum", out, jreg.OPS["averagepool"].numpy_fn(x, **kw))


# ---------------------------------------------------------------- erf lut

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_erf_lut_mode_is_bit_equal(dt):
    """"lut" mode indexes the original planer's 1025-entry table by the
    int16 truncation of clip(x + 2, 0, 4) * 256: the same entries as the
    reference, including past both ends of the table."""
    x = np.concatenate([_x((4, 257), scale=1.3).ravel(),
                        np.array([-9, -2, -1.99609375, 0, 1.99609375, 2, 9],
                                 np.float32)])
    np.testing.assert_array_equal(tmodes.ERF_LUT, jmodes.ERF_LUT)
    jmodes.set_erf_mode("lut")
    tmodes.set_erf_mode("lut")
    try:
        out = run_torch("erf", [x], {}, dt)
        check("exact", out, run_jax("erf", [x], {}, dt), dt=dt)
        if dt == "float32":
            check("exact", out, jreg.OPS["erf"].numpy_fn(x))
        assert np.unique(_np(out)).size > 100
    finally:
        jmodes.set_erf_mode("exact")
        tmodes.set_erf_mode("exact")
    with pytest.raises(ValueError):
        tmodes.set_erf_mode("table")


# ----------------------------------------------------------------- resize

@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode,coord,nearest", [
    ("nearest", "half_pixel", "round_prefer_floor"),
    ("nearest", "asymmetric", "floor"),
    ("nearest", "align_corners", "round_prefer_ceil"),
    ("nearest", "tf_half_pixel_for_nn", "ceil"),
    ("linear", "half_pixel", "round_prefer_floor"),
    ("linear", "pytorch_half_pixel", "round_prefer_floor"),
    ("linear", "align_corners", "round_prefer_floor"),
    ("linear", "asymmetric", "round_prefer_floor"),
])
@pytest.mark.parametrize("by", ["scales", "sizes"])
def test_resize_modes(by, mode, coord, nearest, dt):
    x = _x((2, 3, 7, 9))
    if by == "scales":
        args = [x, None, np.array([1, 1, 2.5, 0.75], np.float32)]
    else:
        args = [x, None, None, np.array([2, 3, 11, 5], np.int64)]
    kw = {"mode": mode, "coordinate_transformation_mode": coord,
          "nearest_mode": nearest}
    out = run_torch("resize", args, kw, dt)
    check("lerp" if mode == "linear" else "exact", out,
          run_jax("resize", args, kw, dt), x, dt=dt)


# -------------------------------------------------------------- recurrent

def _rnn_args(op, direction, lens, init, L=6, N=3, D=5, H=4, seed=11):
    r = _rng(seed)
    g = {"lstm": 4, "gru": 3}[op]
    nd = 2 if direction == "bidirectional" else 1
    W = (r.standard_normal((nd, g * H, D)) * 0.4).astype(np.float32)
    R = (r.standard_normal((nd, g * H, H)) * 0.4).astype(np.float32)
    B = (r.standard_normal((nd, 2 * g * H)) * 0.2).astype(np.float32)
    X = r.standard_normal((L, N, D)).astype(np.float32)
    sl = np.array([6, 3, 1], np.int32) if lens else None
    h0 = (r.standard_normal((nd, N, H)) * 0.5).astype(np.float32) \
        if init else None
    args = [X, W, R, B, sl, h0]
    if op == "lstm":
        args.append((r.standard_normal((nd, N, H)) * 0.5).astype(np.float32)
                    if init else None)
    return args


def _run_rnn(op, args, kw, dt):
    def f(*a):
        return jreg.OPS[op].jax_fn(*a, **kw)
    ref = jax.jit(f)(*[None if a is None else _cast_j(a, dt) for a in args])
    out = run_torch(op, args, kw, dt)
    return out, ref


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("lens", [False, True])
@pytest.mark.parametrize("direction", ["forward", "reverse",
                                       "bidirectional"])
def test_lstm(direction, lens, init, dt):
    """iofc gates, the hoisted input projection, ragged sequences (state
    frozen past each length, padded outputs zero, the reverse direction
    reversed within each sequence) and initial states."""
    args = _rnn_args("lstm", direction, lens, init)
    kw = {"hidden_size": 4, "direction": direction}
    out, ref = _run_rnn("lstm", args, kw, dt)
    assert len(out) == 3
    for o, r in zip(out, ref):
        check("mm_bf16", o, r, dt=dt)
    if dt == "float32":
        for o, r in zip(out, jreg.OPS["lstm"].numpy_fn(*args, **kw)):
            check("mm", o, r)
    if lens:   # padded steps are zeros
        assert (out[0][3:, :, 1].abs().sum() == 0).item()


@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
@pytest.mark.parametrize("lbr", [0, 1])
@pytest.mark.parametrize("init", [False, True])
@pytest.mark.parametrize("lens", [False, True])
@pytest.mark.parametrize("direction", ["forward", "reverse",
                                       "bidirectional"])
def test_gru(direction, lens, init, lbr, dt):
    """zrh gates, ``linear_before_reset`` either way, ragged sequences and
    initial states."""
    args = _rnn_args("gru", direction, lens, init)
    kw = {"hidden_size": 4, "direction": direction,
          "linear_before_reset": lbr}
    out, ref = _run_rnn("gru", args, kw, dt)
    assert len(out) == 2
    for o, r in zip(out, ref):
        check("mm_bf16", o, r, dt=dt)
    if dt == "float32":
        for o, r in zip(out, jreg.OPS["gru"].numpy_fn(*args, **kw)):
            check("mm", o, r)


def test_rnn_without_bias():
    args = _rnn_args("gru", "forward", False, False)
    args[3] = None
    kw = {"hidden_size": 4}
    out, ref = _run_rnn("gru", args, kw, "float32")
    for o, r in zip(out, ref):
        check("mm", o, r)
    args = _rnn_args("lstm", "reverse", False, False)
    args[3] = None
    kw = {"hidden_size": 4, "direction": "reverse"}
    out, ref = _run_rnn("lstm", args, kw, "float32")
    for o, r in zip(out, ref):
        check("mm", o, r)


# ---------------------------------------------------------------- nonzero

def test_nonzero_matches_numpy():
    """The JAX package runs nonzero only in its numpy host tail."""
    x = np.round(_x((3, 4, 5), scale=0.7))
    out = run_torch("nonzero", [x], {})
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(),
                                  jreg.OPS["nonzero"].numpy_fn(x))
    with pytest.raises(NotImplementedError):
        jreg.OPS["nonzero"].jax_fn(jnp.asarray(x))


def test_host_valued_ops_return_host_values():
    """const, constantofshape and range give host values, as the program's
    static records need them."""
    for op, args, kw in (("const", [], {"value": [1, 2], "dtype": "int64"}),
                         ("constantofshape", [np.array([2, 2])],
                          {"value": 1.0}),
                         ("range", [np.int64(0), np.int64(5), np.int64(2)],
                          {})):
        v = treg.OPS[op].fn(*args, **kw)
        assert isinstance(v, torch.Tensor) and v.device.type == "cpu"
