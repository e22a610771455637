"""The port's compile step (``runtime/program.py``: ``_entry``, ``_compile``,
``_cache``, ``lowered_text``) against the JAX tracer's
(``planer_tpu/runtime/tracer.py``), on the CPU, where an entry runs its
resolved list uncaptured:

  * the cache: the same sequence of calls reaches as many entries in both
    packages; reassigning ``op_overrides`` or updating it in place reaches
    a new entry;
  * the statics: the second call at a signature runs no shape or static
    record (counted through the registry);
  * the answers: the compiled entry equals the eager loop (``_run``) bit
    for bit, and the JAX program within the whole-slice tests' tolerances,
    on the INT8 main path and on a graph cut at ``nonzero``; an answer
    handed out is not changed by a later call;
  * ``lowered_text``: 20 conv and 1 dense applications where the JAX text
    holds 20 ``stablehlo.convolution`` and 1 ``dot_general``, the stage64
    kernels, the cut;
  * what drops or keeps entries: ``Net``'s invalidation, the parallel
    programs (uncaptured), serving's warm-up, ``profiler.trace``;
  * the executor's ``timeit`` and ``run_range(free=)``.

The capture itself (a CUDA graph) runs on the card only: it is tested in
``tests/test_torch_cuda.py`` (marked ``cuda``, skipped without a card), and
``chip_smoke.py`` path 18 drives the main path through it on the H100.
"""
import dataclasses

import numpy as np
import pytest
import torch

from planer_tpu import GraphBuilder as JBuilder
from planer_tpu import models as jm
from planer_tpu.models import eval as jev
from planer_tpu.quant import make_quant_program as j_program
from planer_tpu.runtime.executor import NumpyExecutor
from planer_tpu.runtime.tracer import TracedProgram

import planer_tpu_torch as pt
from planer_tpu_torch import models as tm
from planer_tpu_torch import registry
from planer_tpu_torch.models.builder import GraphBuilder as TBuilder
from planer_tpu_torch.ops import torch_ops as tops
from planer_tpu_torch.ops.kernels import stage64 as st
from planer_tpu_torch.parallel import make_mesh, shard_program
from planer_tpu_torch.parallel.spatial import SpatialProgram, shard_spatial
from planer_tpu_torch.parallel.sharding import ShardedProgram
from planer_tpu_torch.quant import calibrate_act_scales as t_calibrate
from planer_tpu_torch.quant import make_quant_program
from planer_tpu_torch.runtime import profiler
from planer_tpu_torch.runtime.executor import Executor
from planer_tpu_torch.runtime.program import Program
from planer_tpu_torch.runtime.serving import ServingEngine

MARGIN = 0.02          # bench.py's decisive-logit filter


def _bias_relu(builder):
    b = builder(["x"])
    w = b.weight("b", np.full((1, 3, 1, 1), 0.25, np.float32))
    b.ret(b.relu(b.add("x", w)))
    return b.build()


def _shape_chain(builder):
    """x -> shape -> gather -> concat with a constant -> reshape of x by it
    -> leakyrelu (the shape chain of tests/test_onnx.py's graphs)."""
    b = builder(["x"])
    i0 = b.weight("i0", np.array([0], np.int64))
    tail = b.weight("tail", np.array([-1], np.int64))
    shp = b.shape("x")
    lead = b.gather(shp, i0, axis=0)
    target = b.concat(lead, tail, axis=0)
    b.ret(b.leakyrelu(b.reshape("x", target), alpha=0.1))
    return b.build()


def _nonzero_flow(builder):
    b = builder(["x"])
    y = b.relu("x")
    nz = b.nonzero(y)
    b.shape(nz)
    b.ret(nz)
    return b.build()


def _x(shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


# ------------------------------------------------------------------ cache

def test_cache_keys_match_the_tracer():
    """Same shape, new shape, new dtype, then the first again: both
    packages hold the same number of entries after every call."""
    jprog = TracedProgram(*_bias_relu(JBuilder))
    tprog = Program(*_bias_relu(TBuilder), device="cpu")
    calls = [_x((1, 3, 4, 4)), _x((1, 3, 4, 4), 1), _x((2, 3, 4, 4)),
             _x((2, 3, 4, 4), dtype=np.float16), _x((1, 3, 4, 4), 2)]
    counts = []
    for x in calls:
        ref = np.asarray(jprog(x))
        out = tprog(x)
        np.testing.assert_array_equal(out.numpy(), ref)
        counts.append((len(tprog._cache), len(jprog._cache)))
    assert counts == [(1, 1), (1, 1), (2, 2), (3, 3), (3, 3)]


def test_statics_fold_once_per_signature(monkeypatch):
    """The first call at a signature runs the shape and static records;
    the second runs only the dynamic ones, from the resolved list.  The
    eager loop folds them again at every call."""
    calls = {}

    def counting(spec):
        def fn(*a, **k):
            calls[spec.name] = calls.get(spec.name, 0) + 1
            return spec.fn(*a, **k)
        return dataclasses.replace(spec, fn=fn)

    for name, spec in list(registry.OPS.items()):
        monkeypatch.setitem(registry.OPS, name, counting(spec))
    jg, jw = _shape_chain(JBuilder)
    tg, tw = _shape_chain(TBuilder)
    prog = Program(tg, tw, device="cpu")
    kinds = [r.kind for r in prog.plan.records]
    assert kinds == ["shape", "static", "static", "dyn", "dyn", "dyn"]
    x = _x((2, 3, 4, 5))
    want = np.asarray(TracedProgram(jg, jw)(x))
    for _ in range(2):
        out = prog(x)
        assert out.shape == (2, 60)
        np.testing.assert_array_equal(out.numpy(), want)
    assert calls == {"shape": 1, "gather": 1, "concat": 1, "reshape": 2,
                     "leakyrelu": 2, "return": 2}
    assert len(prog._cache) == 1
    assert prog._entry(x).folded == 3
    prog._run(x)
    assert calls["shape"] == calls["gather"] == calls["concat"] == 2


def test_overrides_take_a_new_entry_reassigned_or_updated():
    """An overrides dict reassigned, then updated in place, each reach an
    entry of their own, whose answers are the overridden op's; back on the
    first content the first entry is reused."""
    g, w = _shape_chain(TBuilder)
    prog = Program(g, w, device="cpu")
    x = _x((2, 3, 4, 5))
    base = prog(x)
    prog.op_overrides = {"leakyrelu": {"alpha": 0.5}}
    half = prog(x)
    assert len(prog._cache) == 2
    prog.op_overrides["leakyrelu"]["alpha"] = 0.25
    quarter = prog(x)
    assert len(prog._cache) == 3
    flat = x.reshape(2, 60)
    for out, alpha in ((base, 0.1), (half, 0.5), (quarter, 0.25)):
        want = torch.nn.functional.leaky_relu(torch.as_tensor(flat), alpha)
        torch.testing.assert_close(out, want, rtol=0, atol=0)
    prog.op_overrides = {}
    torch.testing.assert_close(prog(x), base, rtol=0, atol=0)
    assert len(prog._cache) == 3


def test_fresh_outputs():
    """An answer handed out is unchanged by a later call with other inputs
    at the same signature."""
    prog = Program(*_bias_relu(TBuilder), device="cpu")
    a = prog(_x((1, 3, 4, 4), 1))
    keep = a.clone()
    b = prog(_x((1, 3, 4, 4), 2))
    assert len(prog._cache) == 1
    assert torch.equal(a, keep) and not torch.equal(a, b)


# ---------------------------------------------------------- the main path

SIDE = 224               # the main path's side (test_torch_resnet18.py's)


@pytest.fixture(scope="module")
def main_path():
    """The JAX package's INT8 ResNet-18 (static activations, stage64
    fused) at SIDE on the port's calibration scales, and the port's net on
    the same IR and weights, bf16."""
    cal = tm.resnet18(device="cpu")
    cal.optimize()
    scales = t_calibrate(cal, list(jev.synthetic_images(
        1, (3, SIDE, SIDE), seed=3, batch=1)))
    net = jm.resnet18()
    net.optimize()
    net.graph.meta["act_scales"] = dict(scales)
    net.quantize("int8", activations="static")
    tnet = pt.net_from_arrays(net.graph.to_json_dict(), net.weights,
                              device="cpu", compute_dtype="bfloat16")
    return net, tnet


def test_main_path_entry_equals_run_and_the_jax_program(main_path):
    """Every call at a signature (the compile walk, then the resolved list)
    equals the eager loop bit for bit, and the JAX program (stage64 in
    interpret mode) within test_torch_resnet18.py's bf16 bound."""
    jnet, tnet = main_path
    assert sum(l.op == "stage64" for l in tnet.graph.layers) == 1
    xs = next(jev.synthetic_images(2, (3, SIDE, SIDE), seed=22, batch=2))
    prog = tnet.program
    st.LAUNCHES.clear()
    st.FALLOFF.clear()
    outs = [prog(xs) for _ in range(3)]
    assert len(prog._cache) == 1 and not st.FALLOFF and not st.LAUNCHES
    eager = prog._run(xs)
    for out in outs:
        assert out.dtype == torch.float32
        torch.testing.assert_close(out, eager, rtol=0, atol=0)
    jprog = j_program(jnet.graph, jnet.weights, compute_dtype="bfloat16")
    jprog.op_overrides = {"stage64": {"interpret": True}}
    yj = np.asarray(jprog(xs))
    yt = outs[-1].numpy()
    rels = np.abs(yt - yj).max(1) / (np.abs(yj).max(1) + 1e-9)
    assert float(np.percentile(rels, 99)) <= 0.02
    srt = np.sort(yj, axis=1)
    keep = (srt[:, -1] - srt[:, -2]) / (np.abs(yj).max(1) + 1e-9) >= MARGIN
    assert (yt.argmax(1) == yj.argmax(1))[keep].all()
    assert len(prog._cache) == 1 and len(jprog._cache) == 1


def test_main_path_plain_overrides_take_their_own_entry(main_path):
    """Leg 1's two programs: the kernels' plain versions (every op's
    ``plain``) are an entry of their own, which names the plain versions
    in its text; both answer as their eager loops do."""
    _, tnet = main_path
    prog = tnet.program
    xs = next(jev.synthetic_images(2, (3, SIDE, SIDE), seed=23, batch=2))
    base = prog(xs)
    n = len(prog._cache)
    plain = {op: {"plain": True} for op in ("stage64", "stagen", "conv",
                                            "dense")}
    prog.op_overrides = plain
    try:
        got = prog(xs)
        assert len(prog._cache) == n + 1
        torch.testing.assert_close(got, prog._run(xs), rtol=0, atol=0)
        text = prog.lowered_text(xs)
    finally:
        prog.op_overrides = {}
    assert "stage64 [plain[stem_kernel x1 + block_kernel x2]]" in text
    assert "'plain': True" in text.splitlines()[0]
    torch.testing.assert_close(prog(xs), base, rtol=0, atol=0)
    assert len(prog._cache) == n + 1
    # the decomposed chain is yet another entry, and another function
    prog.op_overrides = {"stage64": {"force_decomposed": True}}
    try:
        dec = prog(xs)
        text = prog.lowered_text(xs)
    finally:
        prog.op_overrides = {}
    assert len(prog._cache) == n + 2
    assert "stage64 [decomposed]" in text
    assert not torch.equal(dec, base)


def test_lowered_text_names_the_stage64_kernels(main_path):
    _, tnet = main_path
    x = _x((1, 3, SIDE, SIDE))
    text = tnet.program.lowered_text(x)
    lines = text.splitlines()
    stage = [ln for ln in lines if ": stage64 [" in ln]
    assert len(stage) == 1
    assert "[plain[stem_kernel x1 + block_kernel x2]]" in stage[0]
    assert f"bfloat16[1, 3, {SIDE}, {SIDE}]" in stage[0]
    assert f"[1, 64, {SIDE // 4}, {SIDE // 4}]" in stage[0].split("->")[1]
    assert any("[_int_mm]" in ln for ln in lines if ": conv [" in ln)
    assert lines[1].startswith("folded statics: ")
    assert lines[-2] == f"cut: none; no tail ({len(tnet.graph.flow)} flow " \
        "edges)"
    assert lines[-1] == "graph: none (runs uncaptured on cpu)"


# ----------------------------------------------------------- the host tail

def test_nonzero_cut_entry_equals_run_and_the_tracer():
    jg, jw = _nonzero_flow(JBuilder)
    tg, tw = _nonzero_flow(TBuilder)
    prog = Program(tg, tw, device="cpu")
    jprog = TracedProgram(jg, jw)
    x = np.array([[-1.0, 3.0], [2.0, -5.0]], dtype=np.float32)
    for _ in range(2):
        out = prog(x)
        np.testing.assert_array_equal(out.numpy(), np.asarray(jprog(x)))
        np.testing.assert_array_equal(out.numpy(), prog._run(x).numpy())
    assert len(prog._cache) == len(jprog._cache) == 1
    text = prog.lowered_text(x)
    assert "relu [plain]" in text
    assert "cut: flow[1] of 4 (" in text and "is data-dependent" in text
    assert "tail flow[1:4] in the float32 executor on cpu" in text


# -------------------------------------------------------------- the text

def test_lowered_text_counts_match_the_stablehlo():
    """Float32 ResNet-18 at 32 px, b1: 20 conv and 1 dense applications,
    where the JAX program's StableHLO holds 20 convolutions and 1 dot."""
    x = _x((1, 3, 32, 32))
    jtext = jm.resnet18().program.lowered_text(x)
    text = tm.resnet18(device="cpu").program.lowered_text(x)
    assert jtext.count("stablehlo.convolution") == 20
    assert jtext.count("dot_general") == 1
    assert text.count(": conv [") == 20
    assert text.count(": dense [") == 1
    assert sum(": " in ln and " [" in ln for ln in text.splitlines()) \
        > 20


def test_lowered_text_of_a_dense_net():
    """The counterpart of tests/test_compat.py::test_hlo_dump."""
    rng = np.random.default_rng(0)
    b = TBuilder(["x"])
    W = b.weight("w", (rng.standard_normal((4, 3)) * 0.5).astype(np.float32))
    Bv = b.weight("b", rng.standard_normal(4).astype(np.float32))
    b.ret(b.dense("x", W, Bv))
    net = b.build_net(device="cpu")
    txt = net.program.lowered_text(rng.standard_normal((1, 3)).astype(
        np.float32))
    assert ": dense [plain] (float32[1, 3], float32[4, 3], float32[4]) -> " \
        "float32[1, 4]" in txt


# -------------------------------------------------- the kernels' inventory

# every launch key the kernel modules emit, with the CUDA kernel it names
LAUNCH_KEYS = [
    ("stage64", "stem_pool_requant", "stem_kernel"),
    ("stage64", "stem_pool_requant[bf16]", "stem_kernel"),
    ("stage64", "stem_pool_requant[trunc]", "stem_kernel"),
    ("stage64", "basic_block", "block_kernel"),
    ("stage64", "basic_block_last", "block_kernel"),
    ("stage64", "basic_block[trunc]", "block_kernel"),
    ("stage64", "basic_block_last[trunc]", "block_kernel"),
    ("stagen", "stagen_block:bottleneck/s2/256-128-512x4", "block_kernel"),
    ("gemm", "dense_q", "dense_q_kernel"),
    ("gemm", "dense_q[fp8]", "dense_q_kernel"),
]


@pytest.mark.parametrize("module,key,kernel", LAUNCH_KEYS)
def test_the_inventory_holds_every_kernel_module_and_names_its_launches(
        module, key, kernel):
    """Every module under ops/kernels that defines ``LAUNCHES`` is in the
    inventory once imported, with its ``FALLOFF`` where it has one; each
    launch key names its CUDA kernel (a fall-off names none); and the
    entries' switches are the op library's and stage64's, in their order."""
    import collections
    import importlib
    import pkgutil

    from planer_tpu_torch.ops import kernels, modes
    found = []
    for info in pkgutil.iter_modules(kernels.__path__):
        mod = importlib.import_module(f"{kernels.__name__}.{info.name}")
        if hasattr(mod, "LAUNCHES"):
            found.append(info.name)
            counted = kernels.counters()
            assert counted[(info.name, "LAUNCHES")] is mod.LAUNCHES
            assert counted.get((info.name, "FALLOFF")) is getattr(
                mod, "FALLOFF", None)
    assert module in found and set(found) <= set(kernels.modules())
    delta = {(module, "LAUNCHES"): collections.Counter({key: 2}),
             (module, "FALLOFF"): collections.Counter(shape=1)}
    assert kernels.kernel_names(delta) == {kernel: 2}
    assert tops.switches() == (tops._PALLAS_CONV1X1, tops._STACK_CONV,
                               st.SPLIT, st.REQUANT, modes.get_erf_mode())


def test_a_new_kernel_module_joins_the_inventory_with_no_runtime_edit(
        monkeypatch):
    """A stand-in kernel module, only put into ``sys.modules`` under the
    package: its counters, its kernel names, its fall-offs in the serving
    summary, its launches in ``lowered_text`` and its switch in the entry's
    key."""
    import collections
    import sys
    import types

    from planer_tpu_torch.ops import kernels
    mod = types.ModuleType(f"{kernels.__name__}.standin")
    mod.LAUNCHES, mod.FALLOFF = collections.Counter(), collections.Counter()
    mod.KERNEL_NAMES = (("standin_relu", "standin_kernel"),)
    mod.MODE, mod.SWITCHES = "a", ("MODE",)
    monkeypatch.setitem(sys.modules, mod.__name__, mod)
    assert kernels.counters()[("standin", "LAUNCHES")] is mod.LAUNCHES
    assert kernels.counters()[("standin", "FALLOFF")] is mod.FALLOFF
    delta = {("standin", "LAUNCHES"): collections.Counter(standin_relu=3)}
    assert kernels.kernel_names(delta) == {"standin_kernel": 3}
    mod.FALLOFF["shape"] += 1
    with ServingEngine(lambda x: x) as eng:
        assert eng.stats()["fused_stage_falloff"]["standin_shape"] == 1

    relu = registry.OPS["relu"]

    def launching(*a, **k):
        mod.LAUNCHES["standin_relu"] += 1
        return relu.fn(*a, **k)
    monkeypatch.setitem(registry.OPS, "relu", dataclasses.replace(
        relu, fn=launching, oracle_fn=launching))
    prog = Program(*_bias_relu(TBuilder), device="cpu")
    x = _x((1, 3, 4, 4))
    assert "relu [standin_kernel x1]" in prog.lowered_text(x)
    prog(x)
    assert len(prog._cache) == 1
    mod.MODE = "b"
    prog(x)
    assert len(prog._cache) == 2 and mod.LAUNCHES["standin_relu"] == 3
    monkeypatch.undo()
    assert "standin" not in kernels.modules()


# ---------------------------------------------------------- invalidation

def test_invalidation_leaves_no_stale_entry():
    """load_state, quantize, half and astype_compute each rebuild the
    program, so the next call compiles anew and answers as a net built
    that way from scratch."""
    x = _x((1, 3, 32, 32))
    net = tm.resnet18(num_classes=8, device="cpu")
    net(x)
    state = {net.graph.inits[0][0]: np.ones_like(net.weights[0])}
    done = []
    for step in (("load_state", state), ("astype_compute", "bfloat16"),
                 ("astype_compute", None), ("half", "bfloat16")):
        old = net.program
        assert len(old._cache) >= 1
        getattr(net, step[0])(step[1])
        done.append(step)
        assert net.program is not old and not net.program._cache
        ref = tm.resnet18(num_classes=8, device="cpu")
        for name, arg in done:
            getattr(ref, name)(arg)
        np.testing.assert_array_equal(net(x), ref(x))
        assert len(net.program._cache) == 1
    qnet = tm.resnet18(num_classes=8, device="cpu")
    qnet(x)
    old = qnet.program
    qnet.quantize("int8")
    assert qnet.program is not old and not qnet.program._cache
    ref = tm.resnet18(num_classes=8, device="cpu").quantize("int8")
    np.testing.assert_array_equal(qnet(x), ref(x))


def test_parallel_programs_compile_their_statics_and_run_uncaptured():
    """shard_program and shard_spatial answer as before and keep an entry
    per signature.  They capture where the program's device is a card and
    every device of their grid is that card (a mesh of one card repeated,
    decided here over meshes of ``torch.device`` objects); on a mesh of
    distinct cards (a chosen difference: per-device graphs are not built)
    and on the CPU they run uncaptured."""
    mesh = make_mesh((2, 4), ("data", "model"), devices=["cpu"] * 8)
    net = tm.resnet18(num_classes=8, device="cpu")
    x = _x((4, 3, 32, 32))
    ref = net(x)
    for shard, tol in ((shard_program, 1e-5), (shard_spatial, 1e-5)):
        prog = shard(net, mesh)
        assert not prog._captures() and not prog._cache
        for _ in range(2):
            out = net(x)
            np.testing.assert_allclose(out, ref, rtol=tol,
                                       atol=tol * np.abs(ref).max())
        assert len(prog._cache) == 1
        assert "graph: none (runs uncaptured on cpu)" in prog.lowered_text(x)
        net._invalidate()
    one, other = torch.device("cuda", 0), torch.device("cuda", 1)
    for devices, captures in (([one] * 8, True),
                              ([one] * 4 + [other] * 4, False),
                              ([one, other] * 4, False),
                              ([torch.device("cpu")] * 8, False)):
        grid = np.empty(8, dtype=object)
        grid[:] = devices
        for cls in (ShardedProgram, SpatialProgram):
            prog = object.__new__(cls)
            prog.device, prog.grid = devices[0], grid.reshape(2, 4)
            assert prog._captures() == captures, (cls, devices)
    prog = object.__new__(Program)
    for dev, captures in ((one, True), (torch.device("cpu"), False)):
        prog.device = dev
        assert prog._captures() == captures


def test_program_takes_no_jit_kwargs_or_device_params():
    """The tracer's ``jit_kwargs`` (GSPMD shardings for jax.jit) and
    ``device_params`` have no counterpart: a program's params always live
    on its device (a chosen difference, ROADMAP §3)."""
    g, w = _bias_relu(TBuilder)
    with pytest.raises(TypeError):
        Program(g, w, device="cpu", jit_kwargs={})
    with pytest.raises(TypeError):
        Program(g, w, device="cpu", device_params=False)
    prog = Program(g, w, device="cpu")
    assert all(v.device == prog.device for v in prog.params.values())
    net = tm.resnet18(num_classes=8, device="cpu").quantize("int8")
    with pytest.raises(TypeError):
        make_quant_program(net.graph, net.weights, device="cpu",
                           jit_kwargs={})


def test_qtensor_is_no_pytree():
    """QTensor's ``tree_flatten`` / ``tree_unflatten`` are JAX pytree hooks;
    the port's QTensor is a plain dataclass that torch never flattens."""
    from planer_tpu.ops.qtypes import QTensor as JQ
    from planer_tpu_torch.ops.qtypes import QTensor as TQ
    assert hasattr(JQ, "tree_flatten") and hasattr(JQ, "tree_unflatten")
    assert not hasattr(TQ, "tree_flatten")
    assert dataclasses.is_dataclass(TQ)


# ----------------------------------------------------- serving and trace

def test_serving_warmup_compiles_one_entry_per_bucket():
    net = tm.resnet18(num_classes=8, device="cpu")
    with ServingEngine(net, buckets=(1, 2, 4), max_delay_ms=1, warmup=True,
                       example_shape=(3, 32, 32)) as eng:
        keys = sorted(k[0][0][0] for k in net.program._cache)
        assert keys == [(1, 3, 32, 32), (2, 3, 32, 32), (4, 3, 32, 32)]
        y = eng.infer(_x((3, 32, 32)))
    assert y.shape == (8,) and len(net.program._cache) == 3


def test_serving_warmup_compiles_each_spatial_bucket():
    net = tm.resnet18(num_classes=8, device="cpu")
    with ServingEngine(net, buckets=(1, 2), max_delay_ms=1, warmup=True,
                       example_shape=(3, 32, 32), hw_buckets=(32, 48)):
        keys = sorted(k[0][0][0] for k in net.program._cache)
    assert keys == [(1, 3, 32, 32), (1, 3, 48, 48), (2, 3, 32, 32),
                    (2, 3, 48, 48)]


def test_trace_runs_the_entry_under_layer_scopes(tmp_path, monkeypatch):
    """Under ``profiler.trace`` the compiled entry runs its list eagerly,
    each application in its layer's ``record_function`` (a chosen
    difference: a replayed graph has no host scopes); outside, none."""
    net = tm.resnet18(num_classes=8, device="cpu")
    x = _x((1, 3, 32, 32))
    want = net(x)
    entered = []
    real = torch.profiler.record_function
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name) or real(name))
    net(x)
    assert entered == []
    with profiler.trace(str(tmp_path)) as prof:
        got = net(x)
    np.testing.assert_array_equal(got, want)
    assert len(net.program._cache) == 1
    assert {"stem", "layer2.0.conv1", "fc"} <= {e.name for e in prof.events()}
    assert entered.count("layer2.0.conv1") == 1


# ----------------------------------------------------- capture guards

def test_device_constants_are_never_made_inside_a_capture(monkeypatch):
    """A constant first needed while a capture records raises (its fill
    would be recorded and never run); one the warm run made is reused."""
    dev = torch.device("cpu")
    kept = tops._kept(("test", 1.5), dev, lambda: torch.full((), 1.5))
    monkeypatch.setattr(tops, "_capturing", lambda device: True)
    assert tops._kept(("test", 1.5), dev, lambda: None) is kept
    with pytest.raises(RuntimeError, match="inside a CUDA graph capture"):
        tops._kept(("test", 2.5), dev, lambda: torch.full((), 2.5))
    monkeypatch.undo()
    tops._CONSTS.pop(("test", 1.5))
    s = tops._scalar_cached(-0.0, torch.float32, dev)
    assert torch.signbit(s) and tops._scalar_cached(
        0.0, torch.float32, dev) is not s


def _host_operands(builder):
    """Pads whose constant values are a weight and a folded ``const``:
    operands the op reads on the host."""
    b = builder(["x"])
    pads = b.weight("pads", np.array([0, 0, 1, 2, 0, 0, 2, 1], np.int64))
    cv = b.weight("cv", np.array([0.75], np.float32))
    y = b.pad("x", pads, cv)
    b.ret(b.pad(y, pads, b.const(value=-2.5)))
    return b.build()


def test_host_operands_reach_the_op_as_host_values():
    """The registry's ``host_args`` (a pad's constant value) are resolved
    once as host values, as the tracer hands every static operand over: no
    op reads the device for one, which a CUDA graph capture forbids.  The
    answers are the JAX program's."""
    x = _x((2, 3, 4, 5))
    prog = Program(*_host_operands(TBuilder), device="cpu")
    want = np.asarray(TracedProgram(*_host_operands(JBuilder))(x))
    for _ in range(2):
        np.testing.assert_array_equal(prog(x).numpy(), want)
    entry = prog._entry(x)
    pads = [st for st in entry.steps if st.layer.op == "pad"]
    assert len(pads) == 2
    assert pads[0].args[2] is prog._senv0["cv"]           # the numpy weight
    assert pads[1].args[2] is entry.statics[pads[1].edge.src[2]]
    assert registry.OPS["pad"].host_args == (2,)


# ------------------------------------------------------------- executor

@pytest.mark.parametrize("free", [True, False])
def test_run_range_free_matches_numpy_executor(free):
    """``free`` drops each value once no later edge reads it, as the JAX
    package's NumpyExecutor does; without it every value stays."""
    jg, jw = _shape_chain(JBuilder)
    tg, tw = _shape_chain(TBuilder)
    x = _x((2, 3, 4, 5))
    jex, tex = NumpyExecutor(jg, jw), Executor(tg, tw, device="cpu")
    jenv = jex.run_range(jex.initial_env(x), 0, len(jg.flow), free=free)
    tenv = tex.run_range(tex.initial_env(x), 0, len(tg.flow), free=free)
    assert sorted(tenv) == sorted(jenv)
    assert ("x" in tenv) == (not free)
    ret = tg.flow[-1].dst[0]                   # the whole result, a tuple
    (got,), (want,) = tenv[ret], jenv[ret]
    np.testing.assert_array_equal(got.numpy(), want)


def test_executor_timeit_matches_numpy_executor(capsys):
    g, w = _shape_chain(TBuilder)
    jg, jw = _shape_chain(JBuilder)
    x = _x((2, 3, 4, 5))
    ex, jex = Executor(g, w, device="cpu"), NumpyExecutor(jg, jw)
    ex.run(x)
    assert ex.timer == {}
    for e in (ex, jex):
        e.timeit("start")
        e.run(x)
    assert sorted(ex.timer) == sorted(jex.timer)
    assert all(v >= 0 for v in ex.timer.values())
    capsys.readouterr()
    ex.timeit("end")
    jex.timeit("end")
    out = capsys.readouterr().out.splitlines()
    assert sorted(ln.split()[0] for ln in out) == sorted(2 * list(jex.timer))
    ex.run(x)
    assert sorted(ex.timer) == sorted(jex.timer) and not ex.timed


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16, torch.int8])
@pytest.mark.parametrize("shape", [(1, 3, 224, 224), (3, 7, 5), (13,), ()])
def test_stage_copy_writes_the_callers_bytes(dtype, shape):
    """``native.stage_copy``, the copy of a host input into its entry's
    pinned buffer, writes the caller's bytes and nothing else, at any size
    and at destinations off a 64-byte line (its non-temporal stores take
    whole lines between a plain head and tail), from a contiguous or a
    strided source; it refuses a buffer of another dtype or shape."""
    from planer_tpu_torch import native
    gen = torch.Generator().manual_seed(len(shape))
    src = (50 * torch.randn(shape, generator=gen)).to(dtype)
    n = src.numel()
    for off in (0, 1, 17):
        store = torch.zeros(off + n + 8, dtype=dtype)
        dst = store[off:off + n].view(shape)
        native.stage_copy(dst, src)
        assert torch.equal(dst, src)
        assert not store[:off].any() and not store[off + n:].any()
    if src.ndim > 1:
        strided = src.transpose(0, -1)
        dst = torch.empty(strided.shape, dtype=dtype)
        native.stage_copy(dst, strided)
        assert torch.equal(dst, strided)
    with pytest.raises(ValueError, match="stage_copy"):
        native.stage_copy(torch.empty(shape, dtype=torch.float64), src)
