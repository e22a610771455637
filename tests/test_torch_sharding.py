"""The port's DP x TP sharding (``planer_tpu_torch.parallel.sharding``) held
against the JAX package's on the same nets and inputs: the 7 cases of
tests/test_sharding.py on a mesh of 8 repeated ``cpu`` devices beside the
JAX package's 8 virtual CPU devices, the specs of ``param_shardings`` name by
name, and the shape gates taken at the logical (unsharded) shapes.
"""
import numpy as np
import pytest
import torch

import jax

from planer_tpu import models as jm
from planer_tpu.models import eval as jev
from planer_tpu.ops.pallas import stage64 as jst
from planer_tpu.parallel import make_mesh as j_make_mesh
from planer_tpu.parallel import param_shardings as j_param_shardings
from planer_tpu.parallel import shard_program as j_shard_program
from planer_tpu.quant import calibrate_act_scales as j_calibrate
from planer_tpu.quant import make_quant_program as j_quant_program

import planer_tpu_torch as pt
from planer_tpu_torch import models as tm
from planer_tpu_torch.models.builder import GraphBuilder
from planer_tpu_torch.ops import torch_ops as tops
from planer_tpu_torch.ops.kernels import stage64 as st
from planer_tpu_torch.ops.qtypes import QTensor
from planer_tpu_torch.parallel import (input_sharding, make_mesh,
                                       param_shardings, shard_program)
from planer_tpu_torch.parallel import sharding as sh

CPU8 = ["cpu"] * 8
MARGIN = 0.02          # bench.py's decisive-logit filter


@pytest.fixture(scope="module")
def jdevices():
    d = jax.devices("cpu")
    if len(d) < 8:
        pytest.skip("needs 8 virtual cpu devices")
    return d[:8]


@pytest.fixture(scope="module")
def fused():
    """The JAX package's static INT8 ResNet-18 at 224 with the fused entry
    stage (tests/test_sharding.py's net)."""
    net = jm.resnet18()
    net.optimize()
    j_calibrate(net, jev.synthetic_images(2, (3, 224, 224), seed=3, batch=1))
    net.quantize("int8", activations="static")
    assert any(l.op == "stage64" for l in net.graph.layers)
    return net


def _port(jnet):
    return pt.net_from_arrays(jnet.graph.to_json_dict(), jnet.weights,
                              device="cpu")


def _specs(shards):
    out = {}
    for name, s in shards.items():
        if isinstance(s, QTensor) or hasattr(s, "q"):
            out[name] = (tuple(s.q.spec), tuple(s.scale.spec))
        else:
            out[name] = tuple(s.spec)
    return out


def test_mesh_shapes(jdevices):
    mesh = make_mesh((4, 2), ("data", "model"), devices=CPU8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert mesh.shape == dict(j_make_mesh((4, 2), ("data", "model"),
                                          devices=jdevices).shape)
    assert make_mesh(devices=CPU8).shape["data"] == 8
    assert all(d == torch.device("cpu") for d in mesh.devices.flat)
    with pytest.raises(AssertionError):
        make_mesh((4, 4), devices=CPU8)
    assert tuple(input_sharding(mesh).spec) == ("data",)


@pytest.mark.parametrize("form", ["plain", "fused-quantized"])
def test_param_shardings_specs(form, fused, jdevices):
    """Every params leaf of ResNet-18 gets the JAX package's spec, name by
    name (QTensor payload and scale alike)."""
    jmesh = j_make_mesh((2, 4), ("data", "model"), devices=jdevices)
    mesh = make_mesh((2, 4), ("data", "model"), devices=CPU8)
    if form == "plain":
        jnet = jm.resnet18(num_classes=32)
        jparams = jnet.program.params
    else:
        jnet = fused
        jparams = j_quant_program(jnet.graph, jnet.weights).params
    tnet = _port(jnet)
    got = _specs(param_shardings(tnet.graph, tnet.program.params, mesh))
    want = _specs(j_param_shardings(jnet.graph, jparams, jmesh))
    assert got == want
    if form == "plain":
        assert got["stem.w"][0] == "model" and got["fc.w"][0] == "model"
        assert got["stem.bn.k"][1] == "model"


def test_stage64_weight_shardings(fused):
    """The fused stage's conv weights are output-channel sharded."""
    tnet = _port(fused)
    mesh = make_mesh((2, 4), ("data", "model"), devices=CPU8)
    prog = tnet.program
    shards = param_shardings(tnet.graph, prog.params, mesh)
    users = {n: u[0] for n, u in tnet.graph.weight_users().items()}
    convs = [n for n, (op, p) in users.items()
             if op == "stage64" and p >= 1
             and getattr(prog.params[n], "q", prog.params[n]).ndim == 4
             and getattr(prog.params[n], "q", prog.params[n]).shape[0] > 1]
    assert convs, "fused stage should own conv weights"
    for n in convs:
        s = shards[n]
        assert (s.q.spec if isinstance(s, QTensor) else s.spec)[0] == "model"


def _both(jnet, tnet, x, shape, jdevices, tol):
    """Unsharded port, then both packages sharded on the same mesh shape:
    the port's sharded output against its unsharded and the JAX one's."""
    ref = tnet(x)
    jmesh = j_make_mesh(shape, ("data", "model"), devices=jdevices)
    j_shard_program(jnet, jmesh)
    jout = np.asarray(jnet.forward(x))
    prog = shard_program(tnet, make_mesh(shape, ("data", "model"),
                                         devices=CPU8))
    assert isinstance(tnet.program, sh.ShardedProgram)
    out = tnet(x)
    np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)
    np.testing.assert_allclose(out, jout, rtol=tol, atol=tol)
    return prog


def test_dp_tp_parity(rng, jdevices):
    x = rng.standard_normal((4, 3, 32, 32)).astype(np.float32)
    prog = _both(jm.resnet18(num_classes=16),
                 tm.resnet18(num_classes=16, device="cpu"), x, (2, 4),
                 jdevices, 1e-4)
    # every conv, BN affine and the fc split over the 4 model shards
    ops = {prog._layers[prog.graph.flow[prog.plan.records[ri].edge]
                        .layers[prog.plan.records[ri].li]].op
           for ri in prog._tp}
    assert ops == {"conv", "batchnorm", "dense"}


def test_dp_only_parity(rng, jdevices):
    x = rng.standard_normal((8, 1, 32, 32)).astype(np.float32)
    prog = _both(jm.unet(in_ch=1, out_ch=1, base=8, depth=2),
                 tm.unet(in_ch=1, out_ch=1, base=8, depth=2, device="cpu"),
                 x, (8, 1), jdevices, 1e-4)
    assert prog.n_data == 8 and not prog._tp


def test_quantized_sharded(rng, jdevices):
    x = rng.standard_normal((2, 3, 32, 32)).astype(np.float32)
    jnet = jm.resnet18(num_classes=16)
    jnet.quantize("int8")
    tnet = tm.resnet18(num_classes=16, device="cpu")
    tnet.quantize("int8")
    _both(jnet, tnet, x, (2, 4), jdevices, 1e-3)


def test_fused_stage64_defuses_under_sharding(fused, rng, jdevices,
                                              monkeypatch):
    """shard_program of the fused static INT8 net runs stage64's
    decomposed chain (the override is set, the fused form never runs) and
    matches, at the JAX test's 1e-3, the unsharded program on that chain
    (what the JAX test's unsharded CPU run computes).  Against the JAX
    package's sharded program the port differs as the two unsharded
    decomposed chains do: their float convs sum in another order, a few
    int8 codes flip and the random net amplifies the flips, so that leg
    holds test_torch_resnet18.py's bound (p99 of max|d|/max|y| <= 0.02,
    argmax equal on decisive logits)."""
    x = rng.standard_normal((2, 3, 224, 224)).astype(np.float32)
    tnet = _port(fused)
    tnet.program.op_overrides.update(sh.FUSED_OVERRIDES)
    ref = tnet(x)
    jref = np.asarray(fused.forward(x))
    jmesh = j_make_mesh((2, 4), ("data", "model"), devices=jdevices)
    jprog = j_shard_program(fused, jmesh)
    assert jprog.op_overrides["stage64"] == {"force_decomposed": True}
    old = jst.PALLAS
    jst.PALLAS = True
    try:
        jout = np.asarray(fused.forward(x))
    finally:
        jst.PALLAS = old
    np.testing.assert_allclose(jout, jref, rtol=1e-3, atol=1e-3)
    prog = shard_program(tnet, make_mesh((2, 4), ("data", "model"),
                                         devices=CPU8))
    assert prog.op_overrides["stage64"] == {"force_decomposed": True}

    def fused_form(*a, **k):
        raise AssertionError("the fused stage ran under a mesh")
    monkeypatch.setattr(st, "_run", fused_form)
    launches = dict(st.LAUNCHES)
    out = tnet(x)
    assert dict(st.LAUNCHES) == launches
    np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-3)
    rels = np.abs(out - jout).max(1) / np.abs(jout).max(1)
    srt = np.sort(jout, axis=1)
    keep = (srt[:, -1] - srt[:, -2]) / np.abs(jout).max(1) >= MARGIN
    assert float(np.percentile(rels, 99)) <= 0.02
    assert (out.argmax(1) == jout.argmax(1))[keep].all()


def _conv_net(cin, cout, side, seed=0):
    rng = np.random.default_rng(seed)
    b = GraphBuilder(["x"])
    W = b.weight("c.w", (rng.standard_normal((cout, cin, 3, 3))
                         * np.sqrt(2 / (9 * cin))).astype(np.float32))
    Bv = b.weight("c.b", (0.1 * rng.standard_normal(cout)).astype(np.float32))
    y = b.conv("x", W, Bv, group=1, strides=[1, 1], dilations=[1, 1],
               pads=[1, 1, 1, 1], name="c")
    b.ret(b.relu(y))
    return b.build_net("cpu")


@pytest.mark.parametrize("case", ["dp-rows", "tp-outputs"])
def test_gates_read_the_logical_shape(case):
    """A shard's conv takes the unsharded conv's route: at b64 of 8x8 the
    W8A8 gate (N*H*W >= 4096) holds for the batch and not for a data
    shard; a 128-output conv is not row-stackable (<= 64 outputs) while its
    32-output model shards would be.  The sharded program equals the
    unsharded one bit for bit."""
    if case == "dp-rows":
        cin, cout, side, n, shape = 128, 128, 8, 64, (8, 1)
    else:
        cin, cout, side, n, shape = 16, 128, 128, 8, (1, 4)
    net = _conv_net(cin, cout, side)
    x = np.random.default_rng(1).standard_normal(
        (n, cin, side, side)).astype(np.float32)
    pt.calibrate_act_scales(net, [x[:2]])
    net.quantize("int8", activations="static")
    K = net.program._wargs[(0, 1)]
    logical = tops.conv_route((n, cin, side, side), torch.float32, K, 1,
                              (1, 1), (1, 1), (1, 1, 1, 1))
    if case == "dp-rows":
        shard = tops.conv_route((n // 8, cin, side, side), torch.float32, K,
                                1, (1, 1), (1, 1), (1, 1, 1, 1))
        assert (logical, shard) == ("w8a8", "float")
    else:
        from planer_tpu_torch.parallel.sharding import _slice
        shard = tops.conv_route((n, cin, side, side), torch.float32,
                                _slice(K, 0, 0, 4), 1, (1, 1), (1, 1),
                                (1, 1, 1, 1))
        assert (logical, shard) == ("float", "w8a8")
    ref = net(x)
    shard_program(net, make_mesh(shape, ("data", "model"),
                                 devices=CPU8[:int(np.prod(shape))]))
    np.testing.assert_array_equal(net(x), ref)


def test_sharded_net_serves_and_keeps_the_executor(rng):
    """A ServingEngine over a sharded net: answers equal the unsharded
    net's, and its spatial probe uses the program's float32 executor."""
    net = tm.resnet18(num_classes=16, device="cpu")
    xs = rng.standard_normal((6, 3, 32, 32)).astype(np.float32)
    ref = net(xs)
    prog = shard_program(net, make_mesh((2, 4), devices=CPU8))
    assert prog._executor() is prog._executor()
    with pt.ServingEngine(net, buckets=(2, 4, 8), max_delay_ms=5) as eng:
        outs = [f.result(timeout=60) for f in [eng.submit(x) for x in xs]]
    np.testing.assert_allclose(np.stack(outs), ref, rtol=1e-4, atol=1e-4)


def test_logical_batch_moves_the_gates():
    """Inside ``torch_ops.logical_batch`` (a data shard of a fused stage's
    decomposed chain) a conv's gates count the logical batch: 4 images of
    128 x 128 are under the row-stacking gate's 100 000 rows, 8 are over."""
    rng = np.random.default_rng(5)
    x = torch.as_tensor(rng.standard_normal((4, 16, 128, 128)),
                        dtype=torch.float32)
    w = rng.standard_normal((64, 16, 3, 3)).astype(np.float32)
    s = (np.abs(w).max(axis=(1, 2, 3), keepdims=True) / 127).astype(
        np.float32)
    K = QTensor(torch.as_tensor(np.round(w / s).astype(np.int8)),
                torch.as_tensor(s), act_dynamic=True, act_scale=0.05)
    kw = dict(pads=(1, 1, 1, 1))
    own = tops.conv2d(x, K, None, **kw)
    with tops.logical_batch(8):
        logical = tops.conv2d(x, K, None, **kw)
    assert torch.equal(own, tops.conv2d(x, K, None, route="float", **kw))
    assert torch.equal(logical, tops.conv2d(x, K, None, route="w8a8", **kw))
    assert not torch.equal(own, logical)
