"""Tests of the port that need an NVIDIA card, marked ``cuda``: they skip
without one, and import neither jax nor ``planer_tpu``, so they run on the
card's machine, where JAX is absent (``--noconftest``: tests/conftest.py
sets JAX up):

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda -q
"""
import numpy as np
import pytest
import torch

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
