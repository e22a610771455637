"""The port's program analysis, IR passes and op gates against the JAX
package's, on options and record kinds the ResNet paths do not reach:

  * the tracer's ``shape`` record kind (``runtime/tracer.py``): a tensor's
    shape is a host value even where the tensor is dynamic, so a reshape by
    it does not cut the graph;
  * ``optimize.fuse_stagen(max_cout=)``: a stage wider than ``max_cout``
    stays unfused;
  * ``jax_ops._STACK_CONV``: off, a quantized C < 128 3x3 conv with at most
    64 outputs takes dequant + float conv in place of the stacked s8 form;
  * the host tail: past a cut (a data-dependent op, a shape operand the
    data decides) the program runs the rest of the flow in the float32
    executor on its own device, seeded as the tracer seeds its numpy tail,
    tuples stored into one-name and multi-name dsts as the tracer stores
    them.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import torch

from planer_tpu import GraphBuilder as JBuilder
from planer_tpu.models import resnet as jres
from planer_tpu.ops import jax_ops as jops
from planer_tpu.ops import numpy_ops as nops
from planer_tpu.ops.qtypes import QTensor as JQ
from planer_tpu.optimize import fuse_stage64 as j_fuse64
from planer_tpu.optimize import fuse_stagen as j_fusen
from planer_tpu.runtime.tracer import TracedProgram, analyze as j_analyze

from planer_tpu_torch.models import resnet as tres
from planer_tpu_torch.models.builder import GraphBuilder as TBuilder
from planer_tpu_torch.ops import torch_ops as tops
from planer_tpu_torch.ops.qtypes import QTensor as TQ
from planer_tpu_torch.optimize import fuse_stage64 as t_fuse64
from planer_tpu_torch.optimize import fuse_stagen as t_fusen
from planer_tpu_torch.runtime.executor import Executor
from planer_tpu_torch.runtime.program import Program, analyze as t_analyze


# ------------------------------------------------------------- shape records

def _shape_flow(builder, of):
    """input -> shape (of the input, or of a dynamic intermediate) ->
    reshape of the input by that shape -> relu, plus a weight consumed
    dynamically so the plans have a ``dyn_weights`` entry."""
    b = builder(["x"])
    bias = b.weight("b", np.full((1, 4, 1, 1), 0.25, np.float32))
    y = b.add("x", bias)
    shp = b.shape("x" if of == "input" else y)
    z = b.reshape("x", shp)
    out = b.relu(b.add(z, y))
    b.ret(out)
    return b.build()


def _records(plan):
    return [(r.edge, r.li, r.kind, tuple(r.arg_static)) for r in plan.records]


@pytest.mark.parametrize("of", ["input", "intermediate"])
def test_shape_record_kind_matches_tracer(of):
    jg, jw = _shape_flow(JBuilder, of)
    tg, tw = _shape_flow(TBuilder, of)
    assert tg.to_json() == jg.to_json()
    jp, tp = j_analyze(jg), t_analyze(tg)
    assert _records(tp) == _records(jp)
    assert "shape" in [r.kind for r in tp.records]
    assert tp.cut == jp.cut == len(tg.flow)
    assert tp.cut_reason is None and jp.cut_reason is None
    assert tp.dyn_weights == jp.dyn_weights == {"b"}

    x = np.random.default_rng(3).standard_normal((2, 4, 3, 5)).astype(
        np.float32)
    ref = np.asarray(TracedProgram(jg, jw)(x))
    out = Program(tg, tw, device="cpu")(torch.as_tensor(x))
    np.testing.assert_array_equal(out.numpy(), ref)
    # the float32 executor runs the same flow, shape op included
    ex = Executor(tg, tw, device="cpu").run(torch.as_tensor(x))
    np.testing.assert_array_equal(ex.numpy(), ref)


def test_shape_op_is_a_host_int64_value():
    x = torch.zeros(2, 3, 4)
    s = tops.shape_of(x)
    ref = nops.shape_of(np.zeros((2, 3, 4), np.float32))
    assert isinstance(s, np.ndarray) and s.dtype == np.int64
    assert ref.dtype == np.int64
    np.testing.assert_array_equal(s, ref)


# ------------------------------------------------------ fuse_stagen(max_cout)

@pytest.mark.parametrize("max_cout", [128, 256])
@pytest.mark.parametrize("model,want", [("resnet18", {128: 1, 256: 2}),
                                        ("resnet50", {128: 0, 256: 1})])
def test_fuse_stagen_max_cout_matches_reference(model, want, max_cout):
    jnet = jres._resnet([1, 1, 1, 1], {"resnet18": jres._basic_block,
                                       "resnet50": jres._bottleneck}[model],
                        [64, 128, 256, 512], 10, 0)
    tnet = tres._resnet([1, 1, 1, 1], {"resnet18": tres._basic_block,
                                       "resnet50": tres._bottleneck}[model],
                        [64, 128, 256, 512], 10, 0, "cpu")
    counts = []
    for net, f64, fn in ((jnet, j_fuse64, j_fusen), (tnet, t_fuse64, t_fusen)):
        net.optimize()
        f64(net)
        counts.append(fn(net, max_cout=max_cout))
    assert counts[0] == counts[1] == want[max_cout]
    assert tnet.graph.to_json() == jnet.graph.to_json()
    ops = [tnet.graph.layer_map()[e.layers[0]].op for e in tnet.graph.flow]
    assert ops == [jnet.graph.layer_map()[e.layers[0]].op
                   for e in jnet.graph.flow]
    assert ops.count("stagen") == want[max_cout]


# ------------------------------------------------------------ _STACK_CONV

@pytest.mark.parametrize("stack", [True, False])
@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
def test_stack_conv_flag_matches_reference(stack, cdt, monkeypatch):
    """The stackable C = 16 3x3 conv at b32: with the flag on both take the
    exact s8 form, off both dequantize and run a float conv."""
    rng = np.random.default_rng(7)
    x = np.abs(rng.standard_normal((32, 16, 56, 56))).astype(np.float32)
    q = rng.integers(-127, 128, size=(16, 16, 3, 3), dtype=np.int8)
    s = ((0.5 + rng.random((16, 1, 1, 1))) / 256.0).astype(np.float32)
    b = (rng.standard_normal(16) * 0.1).astype(np.float32)
    jk = JQ(jnp.asarray(q), jnp.asarray(s), act_scale=0.02)
    tk = TQ(torch.as_tensor(q), torch.as_tensor(s), act_scale=0.02)
    jx = jnp.asarray(x).astype(cdt)
    tx = torch.as_tensor(x).to(getattr(torch, cdt))
    jb = jnp.asarray(b).astype(cdt)
    tb = torch.as_tensor(b).to(getattr(torch, cdt))
    cd = None if cdt == "float32" else cdt
    kw = dict(strides=(1, 1), pads=(1, 1, 1, 1), compute_dtype=cd)

    monkeypatch.setattr(jops, "_STACK_CONV", stack)
    monkeypatch.setattr(tops, "_STACK_CONV", stack)
    calls = []
    orig = tops._conv_w8a8
    monkeypatch.setattr(tops, "_conv_w8a8",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    ref = jax.jit(lambda a, k, c: jops.conv2d(a, k, c, **kw))(jx, jk, jb)
    out = tops.conv2d(tx, tk, tb, **kw)
    assert len(calls) == (1 if stack else 0)
    r = np.asarray(ref.astype(jnp.float32))
    o = out.float().numpy()
    assert o.shape == r.shape and str(out.dtype).endswith(cdt)
    if cdt == "float32" and stack:
        # exact s8 sums; acc * scale + bias rounded once or twice
        bound = 2 * np.spacing(np.abs(r) + np.abs(b).reshape(1, -1, 1, 1))
        assert (np.abs(o - r) <= bound).all()
    elif cdt == "float32":
        np.testing.assert_allclose(o, r, rtol=1e-5,
                                   atol=1e-5 * np.abs(r).max())
    else:
        np.testing.assert_allclose(o, r, rtol=2 ** -7,
                                   atol=2 ** -8 * np.abs(r).max())
    if not stack:
        # the dequant + float conv: the port's own float path, exactly
        want = tops.conv2d(tx, tk.dequant(tx.dtype), tb, **kw)
        torch.testing.assert_close(out, want, rtol=0, atol=0)


# ---------------------------------------------------------------- host tail

def _nonzero_flow(builder):
    """tests/test_tracer.py's host-tail graph: relu, then nonzero (the cut)
    and a shape read of its output."""
    b = builder(["x"])
    y = b.relu("x")
    nz = b.nonzero(y)
    b.shape(nz)
    b.ret(nz)
    return b.build()


def test_host_tail_matches_tracer():
    """nonzero cuts the graph after the relu (cut == 1, as the tracer
    finds); the tail runs in the float32 executor and gives the JAX
    TracedProgram's answer."""
    jg, jw = _nonzero_flow(JBuilder)
    tg, tw = _nonzero_flow(TBuilder)
    assert tg.to_json() == jg.to_json()
    jp, tp = j_analyze(jg), t_analyze(tg)
    assert tp.cut == jp.cut == 1
    assert tp.cut_reason == jp.cut_reason
    assert _records(tp) == _records(jp)
    x = np.array([[-1.0, 3.0], [2.0, -5.0]], dtype=np.float32)
    ref = np.asarray(TracedProgram(jg, jw)(x))
    out = Program(tg, tw, device="cpu")(torch.as_tensor(x))
    assert out.dtype == torch.int64
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(),
                                  np.array(np.nonzero(np.maximum(x, 0))))


def _topk_flow(builder):
    """x, v -> split x in two (a tuple into a two-name dst, in the prefix),
    add the halves; topk by a k computed from v (argmax: a dynamic shape
    operand, so the graph cuts there); the tail's topk once into two names
    and once into one name holding the whole tuple; a sum of the values."""
    b = builder(["x", "v"])
    sp = b.weight("sp", np.array([2, 2], np.int64))
    bias = b.weight("bias", np.full((1, 2, 1, 1), 0.5, np.float32))
    a, c = b.split("x", sp, n_out=2, axis=1)
    s = b.add(b.add(a, c), bias)
    k = b.argmax("v", axis=0, keepdims=1)
    vals, idx = b.topk(s, k, n_out=2, axis=-1)
    both = b.topk(s, k, axis=2, largest=0)
    total = b.reducesum(vals, axes=[-1], keepdims=0)
    b.ret([vals, idx, both, total])
    return b.build()


def _flat(v):
    if isinstance(v, (tuple, list)):
        return [t for e in v for t in _flat(e)]
    return [v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v)]


@pytest.mark.parametrize("cdt", [None, "bfloat16"])
def test_dynamic_k_topk_cut_matches_tracer(cdt):
    """A topk whose k the data decides cuts the graph; a tuple reaches a
    multi-name dst in the prefix and in the tail, and a one-name dst holds
    the whole tuple, as the tracer stores them.  The prefix's bf16 outputs
    enter the tail as float32 in both packages."""
    jg, jw = _topk_flow(JBuilder)
    tg, tw = _topk_flow(TBuilder)
    assert tg.to_json() == jg.to_json()
    jp, tp = j_analyze(jg), t_analyze(tg)
    assert tp.cut == jp.cut and tp.cut_reason == jp.cut_reason
    assert "topk" in tp.cut_reason and tp.dyn_weights == jp.dyn_weights
    rng = np.random.default_rng(5)
    x = np.round(rng.standard_normal((2, 4, 3, 7)) * 4).astype(np.float32)
    v = np.array([0.1, 0.9, 3.0, 0.2, 0.5], np.float32)     # k = 2
    ref = TracedProgram(jg, jw, compute_dtype=cdt)(x, v)
    out = Program(tg, tw, device="cpu", compute_dtype=cdt)(
        torch.as_tensor(x), torch.as_tensor(v))
    assert isinstance(out, tuple) and len(out) == 4
    assert isinstance(out[2], tuple) and len(out[2]) == 2
    got, want = _flat(out), _flat(ref)
    assert len(got) == len(want) == 5
    for a, r in zip(got, want):
        assert a.shape == r.shape
        np.testing.assert_array_equal(a, r)
    assert got[0].shape == (2, 2, 3, 2) and got[0].dtype == np.float32


def test_host_tail_runs_on_the_programs_device_and_reuses_its_executor():
    tg, tw = _nonzero_flow(TBuilder)
    prog = Program(tg, tw, device="cpu")
    x = torch.tensor([[0.0, 1.0], [2.0, 0.0]])
    prog(x)
    tail = prog._tail
    assert tail is not None and tail.device == prog.device
    prog(x)
    assert prog._tail is tail
