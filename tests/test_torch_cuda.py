"""Tests of the port that need an NVIDIA card, marked ``cuda``: they skip
without one, and import neither jax nor ``planer_tpu``, so they run on the
card's machine, where JAX is absent (``--noconftest``: tests/conftest.py
sets JAX up):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""
import collections
import time

import numpy as np
import pytest
import torch

import separate_casts as sc
from planer_tpu_torch import models as tm


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA graph capture")
    return torch.device("cuda")


@pytest.mark.cuda
def test_capture_replays_the_entry_on_the_card(card):
    """On the card the first call captures; a replay equals the eager loop
    bit for bit, returns fresh tensors, and the text counts the graph's
    kernel nodes."""
    net = tm.resnet18(num_classes=8, device="cuda")
    prog = net.program
    xa, xb = _x((2, 3, 32, 32), 1), _x((2, 3, 32, 32), 2)
    prog(xa)
    entry = prog._entry(xa)
    assert entry.graph is not None and entry.kernel_nodes > 20
    ya = prog(xa)
    keep = ya.clone()
    yb = prog(xb)
    torch.cuda.synchronize()
    assert torch.equal(ya, keep) and not torch.equal(ya, yb)
    torch.testing.assert_close(ya, prog._run(xa), rtol=0, atol=0)
    assert f"{entry.kernel_nodes} kernel nodes" in prog.lowered_text(xa)


@pytest.mark.cuda
def test_a_capture_that_fails_raises_with_its_layer(card):
    """A pad whose constant value is a dynamic input reads it on the host:
    the warm run may, a capture may not.  The call raises naming the
    layer, nothing runs eagerly in its place, and no entry is kept."""
    from planer_tpu_torch.models.builder import GraphBuilder
    from planer_tpu_torch.runtime.program import Program
    b = GraphBuilder(["x", "v"])
    pads = b.weight("pads", np.array([0, 0, 1, 1, 0, 0, 1, 1], np.int64))
    b.ret(b.pad("x", pads, "v", name="the_pad"))
    prog = Program(*b.build(), device="cuda")
    with pytest.raises(RuntimeError, match="failed at layer the_pad"):
        prog(_x((1, 2, 3, 3)), np.array([0.5], np.float32))
    assert not prog._cache


@pytest.mark.cuda
@pytest.mark.parametrize("spatial", [False, True])
def test_a_one_card_mesh_replays_as_a_cuda_graph(card, spatial):
    """A (2, 4) mesh of one card captures its step: a replay equals the
    sharded eager loop bit for bit, returns fresh tensors, and stays
    within the sharded tests' 1e-5 of the unsharded program."""
    from planer_tpu_torch.parallel import make_mesh, shard_program
    from planer_tpu_torch.parallel.spatial import shard_spatial
    net = tm.resnet18(num_classes=8, device="cuda")
    xa, xb = _x((4, 3, 32, 32), 1), _x((4, 3, 32, 32), 2)
    ref = net(xa)
    shard = shard_spatial if spatial else shard_program
    prog = shard(net, make_mesh((2, 4), devices=["cuda:0"] * 8))
    assert prog._captures()
    first = net(xa)
    entry = prog._entry(xa)
    assert entry.graph is not None and entry.kernel_nodes > 20
    ya = prog(xa)
    keep = ya.clone()
    yb = prog(xb)
    torch.cuda.synchronize()
    assert torch.equal(ya, keep) and not torch.equal(ya, yb)
    assert len(prog._cache) == 1
    torch.testing.assert_close(ya, prog._run(xa), rtol=0, atol=0)
    np.testing.assert_array_equal(first, ya.cpu().numpy())
    np.testing.assert_allclose(first, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())


@pytest.mark.cuda
def test_a_float32_program_ignores_the_callers_tf32(card):
    """With cuDNN's TF32 on, a float32 net answers the same before and
    after its float32 executor is first built, and the flag reads on
    after every call."""
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        net = tm.resnet18(num_classes=8, device="cuda")
        x = _x((2, 3, 64, 64), 3)
        before = net(x)
        assert torch.backends.cudnn.allow_tf32
        net(x, engine="oracle")
        assert torch.backends.cudnn.allow_tf32
        np.testing.assert_array_equal(net(x), before)
        assert torch.backends.cudnn.allow_tf32
        assert len(net.program._cache) == 1
    finally:
        torch.backends.cudnn.allow_tf32 = saved


# (kind, cin, cmid, cout, blocks, entry stride, input side, batch): the
# wide forms on the card: ResNet-18 layer3 at 448 (the basic entry
# streamed at 14 tile rows, the identity block resident) and layer4 at 768
# (7 rows; the identity block streamed), ResNet-50 layer3 at 384 and 448
# (the bottleneck entry on one slab slot, identity blocks on two), ResNet-50
# layer4 at 768 (3 and 7 tile rows)
WIDE_STAGES = [("basic", 128, 256, 256, 2, 2, 56, 2),
               ("basic", 256, 512, 512, 2, 2, 48, 2),
               ("bottleneck", 512, 256, 1024, 2, 2, 48, 2),
               ("bottleneck", 512, 256, 1024, 3, 2, 56, 3),
               ("bottleneck", 1024, 512, 2048, 2, 2, 48, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("stage", WIDE_STAGES)
def test_wide_blocks_are_one_launch_each_and_exact(card, stage):
    """Every block of a wide stage runs as one block kernel launch in its
    geometry, equal to the plain version bit for bit (bf16 out), and the
    library's layout size is the wrapper's."""
    from planer_tpu_torch.ops.kernels import stagen as sg
    from planer_tpu_torch.ops.kernels.stagen_study import random_stage
    *shape, n = stage
    x, w, blocks = random_stage(*shape, n=n, seed=5)
    plan = sg._fold(w, blocks, x.device)
    assert any(b.xr for b in plan.blocks)
    for blk in plan.blocks:
        args = (blk.form, blk.th, blk.xr, *blk.widths(),
                blk.proj is not None, blk.last)
        assert sg._lib().stagen_block_smem(*args) == sg._block_smem(*args)
    xq = sg.stagen_prologue(x, plan.s_in)
    sg.LAUNCHES.clear()
    out = sg.stagen_stage(xq, plan)
    torch.cuda.synchronize()
    assert dict(sg.LAUNCHES) == {f"stagen_block:{plan.tag}": len(blocks)}
    sg.LAUNCHES.clear()
    ref = sg.stagen_plain(xq, plan)
    assert out.dtype == ref.dtype == torch.bfloat16
    assert torch.equal(out, ref)
    assert (ref > 0).float().mean() > 0.2


@pytest.mark.cuda
def test_a_block_that_fits_no_geometry_raises_on_the_card(card):
    """A block no geometry fits (a basic block 1024 wide) raises with its
    bytes; nothing is launched in its place."""
    from planer_tpu_torch.ops.kernels import stagen as sg
    from planer_tpu_torch.ops.kernels.stagen_study import random_stage
    x, w, blocks = random_stage("basic", 1024, 1024, 1024, 1, 1, 24, n=1)
    plan = sg._fold(w, blocks, x.device)
    sg.LAUNCHES.clear()
    with pytest.raises(ValueError, match=f"needs {plan.blocks[0].smem} bytes"):
        sg.stagen_stage(sg.stagen_prologue(x, plan.s_in), plan)
    assert not sg.LAUNCHES


# the resident forms' stages at 224 (ResNet-18 stagen_0, ResNet-50 stagen_0
# and stagen_1), each first block gathering the NCHW codes slab by slab
RESIDENT_STAGES = [("basic", 64, 128, 128, 2, 2, 56, 2),
                   ("bottleneck", 64, 64, 256, 3, 1, 56, 2),
                   ("bottleneck", 256, 128, 512, 4, 2, 56, 2)]


@pytest.mark.cuda
@pytest.mark.parametrize("stage", RESIDENT_STAGES)
def test_resident_stages_are_one_launch_per_block_and_exact(card, stage):
    """The 224 stages keep their resident forms (the whole input region in
    shared memory), one launch per block, bit for bit the plain version."""
    from planer_tpu_torch.ops.kernels import stagen as sg
    from planer_tpu_torch.ops.kernels.stagen_study import random_stage
    *shape, n = stage
    x, w, blocks = random_stage(*shape, n=n, seed=6)
    plan = sg._fold(w, blocks, x.device)
    assert not any(b.xr for b in plan.blocks)
    xq = sg.stagen_prologue(x, plan.s_in)
    sg.LAUNCHES.clear()
    out = sg.stagen_stage(xq, plan)
    torch.cuda.synchronize()
    assert dict(sg.LAUNCHES) == {f"stagen_block:{plan.tag}": len(blocks)}
    sg.LAUNCHES.clear()
    assert torch.equal(out, sg.stagen_plain(xq, plan))


@pytest.mark.cuda
def test_the_spans_of_a_replay_line_up_with_the_device(card):
    """A b1 numpy call on a replayed entry records the replay's spans in
    the call's order, its input's bytes as pageable and one replay.  Under
    ``profiler.trace(None, layers=False)`` (device activity only), once
    the device operations are put on the spans' clock at each replay's
    first kernel (``portbench.spans.align``: kineto's device timestamps
    can drift from ``time.time_ns`` within a profile), every
    host-to-device copy starts inside a ``program.copy_in`` span and every
    answer's device-to-host copy ends inside ``net.to_numpy``."""
    from planer_tpu_torch.runtime import profiler
    from portbench import spans
    net = tm.resnet18(num_classes=8, device="cuda")
    x = _x((1, 3, 32, 32), 4)
    net(x)
    net(x)
    with profiler.record() as rec:
        y = net(x)
    assert [s.name for s in rec.spans] == [
        "net.call", "program.call", "program.inputs", "program.copy_in",
        "program.replay", "program.copy_out", "program.finish",
        "net.to_numpy"]
    assert rec.counters == {"in_bytes.pageable": x.nbytes, "replays": 1,
                            "copy_in.staged": 1, "out_bytes": y.nbytes}
    n = 50
    with profiler.trace(None, layers=False) as prof:
        w0 = time.time_ns()
        for i in range(n):
            net(_x((1, 3, 32, 32), i))
        torch.cuda.synchronize()
        w1 = time.time_ns()
    sw = spans.reduce(prof, prof.recording, (w0, w1))
    assert len(sw.shift) == n
    assert len(sw.htod) == n and None not in sw.htod, sw.htod
    assert len(sw.dtoh) == n and None not in sw.dtoh, sw.dtoh


@pytest.fixture(scope="module")
def main_path():
    """The main path on the card: ResNet-18 at 224 (stage64 and the W8A8
    chain), optimized, calibrated on one image, static INT8, bf16
    compute."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA graph capture")
    from planer_tpu_torch.models import eval as ev
    from planer_tpu_torch.quant import calibrate_act_scales
    net = tm.resnet18(num_classes=8, device="cuda")
    net.optimize()
    calibrate_act_scales(net, ev.synthetic_images(1, (3, 224, 224), seed=3,
                                                  batch=1))
    net.quantize("int8", activations="static")
    net.astype_compute("bfloat16")
    return net


def _image(batch, dtype, seed):
    x = _x((batch, 3, 224, 224), seed)
    if dtype == "int8":
        return np.clip(np.rint(40 * x), -128, 127).astype(np.int8)
    return x.astype(dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("dtype", ["float32", "float64", "int8"])
def test_a_host_input_is_staged_and_cast_inside_the_graph(main_path, batch,
                                                          dtype):
    """A host input's entry stages it through a pinned buffer in its own
    dtype (float64 narrowed to float32 first) and casts it inside the
    graph (int8 graph inputs lifted to bf16); its replay equals bit for
    bit the same input handed over on the card, whose entry copies it in
    as before, and the eager loop."""
    prog = main_path.program
    x = _image(batch, dtype, 20 + batch)
    xd = torch.from_numpy(x).cuda()
    prog(x)
    prog(xd)
    host, card = prog(x), prog(xd)
    entry = prog._entry(x)
    kept = torch.int8 if dtype == "int8" else torch.float32
    assert entry.staged is not None and entry.staging[0].is_pinned()
    assert entry.staging[0].dtype == entry.static_in[0].dtype == kept
    assert prog._entry(xd).staged is None and prog._entry(xd).staging == [None]
    assert prog._entry(xd).static_in[0].dtype == torch.bfloat16
    torch.testing.assert_close(host, card, rtol=0, atol=0)
    torch.testing.assert_close(host, prog._run(x), rtol=0, atol=0)


@pytest.mark.cuda
def test_back_to_back_host_calls_answer_their_own_inputs(main_path):
    """Two ``Net.forward`` calls with different host inputs and no
    synchronize between them, queued behind a long kernel: the second
    waits for the first one's copy out of the pinned buffer before it
    writes the buffer, so each answer is its own input's."""
    net = main_path
    xa, xb = _image(1, "float32", 31), _image(1, "float32", 32)
    want = [net.forward(torch.from_numpy(v).cuda()) for v in (xa, xb)]
    net.forward(xa)
    net.forward(xa)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)          # tens of ms ahead of both copies
    ya = net.forward(xa)
    yb = net.forward(xb)
    torch.cuda.synchronize()
    assert not torch.equal(want[0], want[1])
    assert torch.equal(ya, want[0]) and torch.equal(yb, want[1])
    # a caller's own stream: the copy, its event and the replay go there
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        torch.cuda._sleep(100_000_000)
        yb = net.forward(xb)
        ya = net.forward(xa)
        assert net.program._current_stream(0) == side
    side.synchronize()
    assert torch.equal(ya, want[0]) and torch.equal(yb, want[1])
    assert net.program._current_stream(0) == torch.cuda.current_stream(0)


@pytest.mark.cuda
def test_copy_in_staged_counts_the_replays_of_host_inputs(main_path):
    """``copy_in.staged`` counts each replayed call whose input went
    through the pinned buffer (pageable or pinned host memory), none with
    an input on the card and none for a first call, which answers from its
    walk."""
    from planer_tpu_torch.runtime import profiler
    prog = main_path.program
    x = _image(1, "float32", 41)
    xd, xp = torch.from_numpy(x).cuda(), torch.from_numpy(x).pin_memory()
    prog(x)
    prog(xd)
    with profiler.record() as rec:
        for v in (x, x, xp, xd, xd):
            prog(v)
        prog(_image(2, "float32", 42))
    n = x.nbytes
    # (the compile's walk also counts its convs' and its fc's routes,
    # ``conv*`` and ``dense.*``, and the W8A8 chain's fused casts,
    # ``w8a8.*``)
    counters = {k: v for k, v in rec.counters.items()
                if not k.startswith(("conv", "dense.", "w8a8."))}
    assert counters == {"in_bytes.pageable": 2 * n, "in_bytes.pinned": n,
                            "in_bytes.device": 2 * n, "copy_in.staged": 3,
                            "replays": 5, "compiles": 1, "captures": 1}


@pytest.mark.cuda
def test_replays_add_the_captures_launches_to_every_kernel_module(main_path):
    """After k replays of the main path, every loaded kernel module's
    ``LAUNCHES`` (each module under ``ops.kernels`` that has one, the
    benchmark's rule) has grown by exactly k times the capture's delta:
    one stem and two block launches of stage64 a replay."""
    import collections
    import sys
    prog = main_path.program
    x = torch.from_numpy(_image(2, "float32", 51)).cuda()
    prog(x)                                       # the compile and capture
    captured = {id(c): d for c, d in prog._entry(x).delta}
    launches = {n: m.LAUNCHES for n, m in list(sys.modules.items())
                if n.startswith("planer_tpu_torch.ops.kernels.")
                and hasattr(m, "LAUNCHES")}
    before = {n: collections.Counter(c) for n, c in launches.items()}
    k = 5
    for _ in range(k):
        prog(x)
    torch.cuda.synchronize()
    for n, c in launches.items():
        want = {key: k * v for key, v in captured.get(id(c), {}).items()}
        assert dict(c - before[n]) == want, n
    stage64 = launches["planer_tpu_torch.ops.kernels.stage64"]
    assert sum((stage64 - before[
        "planer_tpu_torch.ops.kernels.stage64"]).values()) == 3 * k


@pytest.mark.cuda
@pytest.mark.parametrize("case", sc.FORMS)
def test_fused_casts_equal_the_separate_casts_on_the_card(card, case):
    """``test_torch_cast_fused.py``'s cases on the card, where an op with
    mixed dtypes or an ``out=`` of another dtype runs the dynamic-cast
    kernels: each fused form equals the separate casts bit for bit, in
    the same layout."""
    sc.check_form(case, "cuda")


def _bench_net(name, side, batch):
    import json
    from portbench import harness, inputs
    from portbench.configs import convnext, resnet, yolo
    c = next(c for c in harness.load_spec()["configs"] if c["name"] == name)
    with open(harness.CHECKOUT / c["file"]) as f:
        cfg = {**json.load(f), "image_side": side}
    fam = {"yolo": yolo, "convnext": convnext}.get(cfg["family"], resnet)
    seed = 2 ** 31 + 25
    a = fam.arrays(cfg, seed, "cuda")
    net = fam.build(cfg, a, fam.calibration(cfg, seed, "cuda"), "cuda")
    return cfg, net, inputs.images(batch, side,
                                   inputs.generator(seed, "test", "cuda"))


@pytest.mark.cuda
@pytest.mark.parametrize("name,side,batch", [
    ("resnet18-int8-224", 224, 2), ("yolov3-int8-416", 128, 2)])
def test_programs_answer_as_with_the_separate_casts(card, name, side, batch,
                                                    monkeypatch):
    """The benchmark's ResNet-18 at b2 and YOLO-v3 at 128 px: the first
    call counts ``w8a8.cast_fused`` twice per walk of the route plan (the
    warm run and the capture), a replay none, and the captured answers
    equal bit for bit those of an eager walk with the separate casts in
    the library's place."""
    from planer_tpu_torch.runtime import profiler
    from portbench.configs import resnet_ref, yolo_ref
    cfg, net, x = _bench_net(name, side, batch)
    ref = yolo_ref if name.startswith("yolo") else resnet_ref
    routes = collections.Counter(
        r for r, _ in ref.routes(cfg, side, batch).values()
        if r not in ("stage64",))
    want = sc.planned_casts(net, routes)
    with profiler.record() as rec:
        first = net.forward(x)
    assert rec.counters[sc.COUNTER] == 2 * want
    with profiler.record() as rec:
        again = net.forward(x)
    torch.cuda.synchronize()
    assert sc.COUNTER not in rec.counters and rec.counters["replays"] == 1
    sc.use(monkeypatch)
    old = net.program._run(x)
    for y in (first, again):
        for g, w in zip(*(v if isinstance(v, (list, tuple)) else [v]
                          for v in (y, old)), strict=True):
            sc.same_bits(g, w)


def _routed(counters):
    return {k: v for k, v in counters.items()
            if k.startswith(("conv.route.", "dense.route.", "layernorm"))}


@pytest.mark.cuda
def test_convnext_base_counts_the_reference_route_plan_at_b64(card):
    """The benchmark's ConvNeXt-Base at 224, b64: a walk counts the
    reference's plan (72 Linears on ``dense_q``'s kernel branch, the
    classifier on its fallback, 41 LayerNorms, 3 W8A8 and 37 float convs)
    and launches 72 ``dense_q``; a first call counts the plan twice (the
    warm run and the capture), a replay none of it but the capture's 72
    launches, and answers as the walk bit for bit."""
    from planer_tpu_torch.ops.kernels import gemm
    from planer_tpu_torch.runtime import profiler
    from portbench.configs import convnext_ref
    cfg, net, x = _bench_net("convnext-base-int8-224", 224, 64)
    want = convnext_ref.plan(cfg, 224, 64)
    assert want == {"dense.route.kernel": 72, "dense.route.fallback": 1,
                    "layernorm": 41, "conv.route.w8a8": 3,
                    "conv.route.float": 37}
    launched = gemm.LAUNCHES["dense_q"]
    with profiler.record() as rec:
        walk = net.program._run(x)
    assert _routed(rec.counters) == want
    with profiler.record() as rec:
        net.forward(x)
    assert _routed(rec.counters) == {k: 2 * v for k, v in want.items()}
    with profiler.record() as rec:
        again = net.forward(x)
    torch.cuda.synchronize()
    assert _routed(rec.counters) == {} and rec.counters["replays"] == 1
    assert gemm.LAUNCHES["dense_q"] - launched == 3 * 72
    sc.same_bits(again, walk)
