"""The port's program boundary and float32 precision against the JAX
package's, on the CPU:

  * 64-bit inputs narrow as ``jnp.asarray`` narrows them with 64-bit mode
    off: a float64 batch through ResNet-18 (float32, weight-only int8,
    fp8) returns float32, bit-equal to the float32 batch's answer from the
    same entry, and within the f32 bound of the JAX net's; an int64 index
    input narrows to int32 and indexes as the JAX program's does;
    ``asarray`` gives ``jnp.asarray``'s dtypes;
  * float32 precision is held inside each call (``device.float32_exact``):
    an op reads TF32 off during any program, executor, calibration,
    serving or ``lowered_text`` call, the flags read as the caller left
    them after it, and flipping them between calls takes no new entry.
"""
import dataclasses
import sys
import threading

import numpy as np
import pytest
import torch

import planer_tpu as jpt
from planer_tpu import GraphBuilder as JBuilder
from planer_tpu import models as jm
from planer_tpu.runtime.tracer import TracedProgram

import planer_tpu_torch as pt
from planer_tpu_torch import models as tm
from planer_tpu_torch import registry
from planer_tpu_torch.device import float32_exact
from planer_tpu_torch.models.builder import GraphBuilder as TBuilder
from planer_tpu_torch.quant import calibrate_act_scales
from planer_tpu_torch.runtime.program import Program
from planer_tpu_torch.runtime.serving import ServingEngine

F32_BOUND = 1e-5       # test_torch_fp8.py's f32 bound on ResNet-18 at 32 px


def _flags():
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


@pytest.fixture
def tf32_on():
    """Both TF32 flags on for the test, the process's own restored after."""
    saved = _flags()
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved


# ------------------------------------------------------ 64-bit inputs

@pytest.mark.parametrize("mode", [None, "int8", "fp8"])
def test_float64_inputs_take_the_float32_entry(mode):
    """The JAX net returns float32 for a float64 batch, bit-equal to its
    float32 batch's answer; so does the port, from the same entry."""
    rng = np.random.default_rng(42)
    x64 = rng.standard_normal((2, 3, 32, 32))
    x32 = x64.astype(np.float32)
    jnet = jm.resnet18(num_classes=10)
    tnet = pt.net_from_arrays(jnet.graph.to_json_dict(), jnet.weights,
                              device="cpu")
    if mode is not None:
        jnet.quantize(mode)
        tnet.quantize(mode)
    yj = np.asarray(jnet.forward(x64))
    assert yj.dtype == np.float32
    np.testing.assert_array_equal(yj, np.asarray(jnet.forward(x32)))
    y64 = tnet(x64)
    assert y64.dtype == np.float32
    assert len(tnet.program._cache) == 1
    np.testing.assert_array_equal(y64, tnet(x32))
    out = tnet.forward(torch.as_tensor(x64))
    assert out.dtype == torch.float32
    assert len(tnet.program._cache) == 1
    ((shape, dtype, _),), _, _ = next(iter(tnet.program._cache))
    assert shape == x64.shape and dtype == torch.float32
    rel = np.abs(y64 - yj).max() / np.abs(yj).max()
    print(f"{mode or 'float32'} resnet18, float64 batch: port vs JAX max "
          f"rel {rel:.3g}")
    assert rel <= F32_BOUND


@pytest.mark.parametrize("value", [np.ones(3), np.arange(3),
                                   [1, 2, 3], [1.0, 2.0], [True, False],
                                   np.ones(3, np.float16)],
                         ids=["float64", "int64", "int list", "float list",
                              "bool list", "float16"])
def test_asarray_dtypes_match_jnp_asarray(value):
    """Without ``dtype``: ``jnp.asarray``'s dtype with 64-bit mode off."""
    want = str(np.asarray(jpt.asarray(value)).dtype)
    got = pt.asarray(value, device="cpu")
    assert str(got.dtype).replace("torch.", "") == want
    np.testing.assert_array_equal(got.numpy(), np.asarray(value))


def _index_graph(builder, op):
    if op == "gather":
        b = builder(["x", "i"])
        b.ret(b.relu(b.gather("x", "i", axis=1)))
    else:
        b = builder(["x", "i", "u"])
        b.ret(b.relu(b.scatternd("x", "i", "u")))
    return b.build()


@pytest.mark.parametrize("op", ["gather", "scatternd"])
def test_int64_index_inputs_narrow_and_index_as_jax(op):
    """An int64 index input (negative ones included for ``gather``) enters
    the program as int32, as ``jnp.asarray`` takes it, and the op widens it
    itself: the answer equals the JAX program's."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 6, 5)).astype(np.float32)
    if op == "gather":
        ins = (x, np.array([[0, -1], [5, 2]], np.int64))
    else:
        ins = (x, np.array([[1, 4], [0, 0]], np.int64),
               rng.standard_normal((2, 5)).astype(np.float32))
    want = np.asarray(TracedProgram(*_index_graph(JBuilder, op))(*ins))
    prog = Program(*_index_graph(TBuilder, op), device="cpu")
    got = prog(*ins)
    np.testing.assert_array_equal(got.numpy(), want)
    (specs, _, _), = prog._cache
    assert specs[1][1] == torch.int32
    prog(*(a.astype(np.int32) if a.dtype == np.int64 else a for a in ins))
    assert len(prog._cache) == 1


# --------------------------------------------------- float32 precision

def _cut_graph(builder):
    """conv -> relu -> nonzero (the cut): a program with a host tail."""
    rng = np.random.default_rng(5)
    b = builder(["x"])
    w = b.weight("w", rng.standard_normal((4, 3, 3, 3)).astype(np.float32))
    bias = b.weight("b", np.zeros(4, np.float32))
    y = b.relu(b.conv("x", w, bias, pads=(1, 1, 1, 1)))
    b.ret([y, b.nonzero(y)])
    return b.build()


def test_float32_precision_holds_inside_calls_only(tf32_on, monkeypatch):
    """With both TF32 flags on: every op of a program, its host tail, the
    executor, calibration, a served request and ``lowered_text`` reads them
    off, and after each call they read on again.  The flags are no part of
    the key: a program with a cut compiles one entry at its first
    signature, and flipping the flags between calls reuses it."""
    seen = []

    def spying(spec):
        def fn(*a, **k):
            seen.append(_flags())
            return spec.fn(*a, **k)
        return dataclasses.replace(spec, fn=fn, oracle_fn=fn)

    for name in ("relu", "nonzero", "gap"):
        monkeypatch.setitem(registry.OPS, name, spying(registry.OPS[name]))

    def check(what, n_ops):
        assert _flags() == (True, True), what
        assert len(seen) >= n_ops and set(seen) == {(False, False)}, what
        seen.clear()

    x = np.random.default_rng(0).standard_normal((2, 3, 8, 8)).astype(
        np.float32)
    prog = Program(*_cut_graph(TBuilder), device="cpu")
    assert prog.plan.cut < len(prog.graph.flow)
    first = prog(x)
    check("the first call (compile, tail)", 2)
    prog(x)
    check("a later call", 1)
    assert len(prog._cache) == 1
    torch.backends.cudnn.allow_tf32 = False
    again = prog(x)
    torch.backends.cudnn.allow_tf32 = True
    check("a call under other flags", 1)
    assert len(prog._cache) == 1
    for a, b in zip(first, again):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    prog._run(x)
    check("_run", 2)
    prog.lowered_text(np.zeros((1, 3, 8, 8), np.float32))
    check("lowered_text", 1)
    prog._executor().run(x)
    check("the executor", 2)

    net = tm.resnet18(num_classes=4, device="cpu")
    calibrate_act_scales(net, [x[:, :, :8, :8].repeat(4, 2).repeat(4, 3)])
    check("calibration", 1)
    with ServingEngine(net, buckets=(1,), max_delay_ms=1) as eng:
        eng.infer(np.zeros((3, 32, 32), np.float32))
        check("a served request", 1)
    net(np.zeros((1, 3, 32, 32), np.float32), engine="oracle")
    check("net.oracle", 1)


def test_float32_exact_nests_over_threads(tf32_on):
    """Threads entering and leaving the helper in any order each see the
    flags off inside; the last exit restores the caller's setting."""
    errors, inside = [], threading.Barrier(8, timeout=30)

    def work(k):
        try:
            for i in range(200):
                with float32_exact():
                    if i == 100:
                        inside.wait()
                    with float32_exact():
                        if _flags() != (False, False):
                            errors.append((k, i, _flags()))
        except Exception as e:  # noqa: BLE001 -- reported below
            errors.append((k, repr(e)))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,))
                   for k in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors[:5]
    assert _flags() == (True, True)
