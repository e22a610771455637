"""The port's ``Net`` methods against the JAX package's, on the same graphs
and seeded inputs: ``load_json``, ``load_state``, ``half`` (float16 and
bfloat16, on tests/test_compat.py's nets), ``input``/``inits``, ``info``,
``timeit``, ``show`` and ``cost_analysis``."""
import json

import numpy as np
import pytest
import torch

import ml_dtypes

import planer_tpu as J
from planer_tpu import models as jm

import planer_tpu_torch as pt
from planer_tpu_torch import models as tm
from planer_tpu_torch.ir import pack_weights


def _simple_nets(seed=42):
    """tests/test_compat.py's dense net in both packages, same weights."""
    out = []
    for mod, kw in ((J, {}), (pt, {"device": "cpu"})):
        rng = np.random.default_rng(seed)
        b = mod.GraphBuilder(["x"])
        W = b.weight("w", (rng.standard_normal((4, 3)) * 0.5).astype(
            np.float32))
        Bv = b.weight("b", rng.standard_normal(4).astype(np.float32))
        b.ret(b.dense("x", W, Bv))
        out.append(b.build_net(**kw))
    return out


def test_load_json_builds_the_reference_graph_with_zero_weights():
    jn = jm.resnet18(num_classes=8)
    d = json.loads(jn.graph.to_json())
    parts = (d["input"], d["inits"], d["layers"], d["flow"])
    ref = J.Net().load_json(*parts)
    net = pt.Net(device="cpu").load_json(*parts)
    assert net.graph.to_json() == ref.graph.to_json() == jn.graph.to_json()
    assert len(net.weights) == len(ref.weights)
    for a, b in zip(net.weights, ref.weights):
        assert a.dtype == b.dtype and a.shape == b.shape and not a.any()
    net.load_weights(J.pack_weights(jn.weights))
    x = np.random.default_rng(0).standard_normal((2, 3, 32, 32)).astype(
        np.float32)
    np.testing.assert_allclose(net(x), np.asarray(jn(x)), rtol=1e-4,
                               atol=1e-4)


def test_load_state_counts_and_errors_as_the_reference():
    jn = jm.resnet18(num_classes=10)
    net = tm.resnet18(num_classes=10, device="cpu")
    idx = net.graph.init_index()
    state = {"stem.w": net.weights[idx["stem.w"]] * 2.0 + 1.0,
             "fc.b": net.weights[idx["fc.b"]] + 3.0,
             "not.a.weight": np.zeros(3, np.float32)}
    assert net.load_state(state) == jn.load_state(state) == 2
    for a, b in zip(net.weights, jn.weights):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    for n in (net, jn):
        with pytest.raises(KeyError):
            n.load_state({"nope": np.zeros(1, np.float32)}, strict=True)
        with pytest.raises(ValueError, match="shape"):
            n.load_state({"fc.b": np.zeros((3, 3), np.float32)})
    x = np.random.default_rng(1).standard_normal((1, 3, 32, 32)).astype(
        np.float32)
    np.testing.assert_allclose(net(x), np.asarray(jn(x)), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dtype", ["float16", "bfloat16"])
def test_half_matches_reference(dtype):
    """Both packages compute in float32 on the rounded weights.  The port's
    halved net is bit-equal to its float32 net holding the rounded values
    (the promotion is exact); against the JAX program it sits within 4
    float32 ulps of max|y|: XLA's CPU dot sums and contracts the 3-term
    products with the bias in its own order (ROADMAP §3, FMA contraction),
    halved or not."""
    jn, net = _simple_nets()
    _, rounded = _simple_nets()
    x = np.random.default_rng(3).standard_normal((2, 3)).astype(np.float32)
    full = net(x)
    jn.half(dtype)
    net.half(dtype)
    if dtype == "float16":
        assert net.weights[0].dtype == np.float16
        np.testing.assert_array_equal(net.weights[0], jn.weights[0])
    else:
        assert net.weights[0].dtype == torch.bfloat16
        assert jn.weights[0].dtype == ml_dtypes.bfloat16
        np.testing.assert_array_equal(net.weights[0].float().numpy(),
                                      jn.weights[0].astype(np.float32))
    rounded.weights = [np.asarray(torch.as_tensor(w).to(
        getattr(torch, dtype)).float()) for w in rounded.weights]
    out = net(x)
    np.testing.assert_array_equal(out, rounded(x))
    ref = np.asarray(jn(x))
    assert np.abs(out - ref).max() <= 4 * np.spacing(np.abs(ref).max())
    assert np.abs(out - full).max() / (np.abs(full).max() + 1e-9) < 0.02


def test_halved_net_packs_and_refuses_pla(tmp_path):
    jn, net = _simple_nets()
    jn.half("bfloat16")
    net.half("bfloat16")
    assert np.array_equal(pack_weights(net.weights),
                          J.pack_weights(jn.weights))
    with pytest.raises(ValueError, match="half"):
        pt.save_pla(str(tmp_path / "h"), net.graph, net.weights)


def test_inspection_properties_and_info():
    jn, net = _simple_nets()
    assert net.input == jn.input == ["x"]
    assert net.inits == jn.inits == ["w", "b"]
    x = np.zeros((2, 3), np.float32)
    v = [x, (torch.zeros(4, 5), 7)]
    assert net.info(v) == [(2, 3), [torch.Size([4, 5]), 7]]
    assert [tuple(s) if isinstance(s, tuple) else s
            for s in jn.info([x, 7])] == [(2, 3), 7]


def test_timeit_fills_the_timer_from_the_executor(capsys):
    jn = jm.resnet18(num_classes=8)
    net = tm.resnet18(num_classes=8, device="cpu")
    x = np.random.default_rng(0).standard_normal((1, 3, 32, 32)).astype(
        np.float32)
    jn.timeit("start")
    jn.forward(x, engine="numpy")
    net.timeit("start")
    out = net.forward(x, engine="numpy")
    assert set(net.timer) == set(jn.timer)
    assert net.timer["conv"] > 0
    np.testing.assert_allclose(out.numpy(), np.asarray(jn.forward(x)),
                               rtol=1e-4, atol=1e-4)
    net.timeit("end")
    assert "conv" in capsys.readouterr().out
    before = dict(net.timer)
    net.forward(x, engine="oracle")          # untimed after "end"
    assert net.oracle.timer == before
    net.timeit("start")
    net.load_state({})                       # a rebuilt oracle stays timed
    net.forward(x, engine="oracle")
    assert net.timer["conv"] > 0 and net.timer is net.oracle.timer


def test_show_writes_the_reference_dot(tmp_path, capsys):
    jn = jm.unet(in_ch=1, out_ch=1, base=4, depth=1)
    net = tm.unet(in_ch=1, out_ch=1, base=4, depth=1, device="cpu")
    p = str(tmp_path / "net.dot")
    dot = net.show(p)
    assert dot == jn.show() == open(p).read()
    assert "conv" in capsys.readouterr().out


def test_cost_analysis_against_the_jax_program():
    """ResNet-18 at 32 (tests/test_aux.py's net).  XLA's count skips the
    zero-padding taps of each conv, a large share at 1-16 px (at 224 the
    two counts agree to 8%), so the port counts 1.70x the flops; XLA's
    CPU model charges a conv's input bytes per tap, so the port's
    read-once bytes are 0.34x."""
    x = np.random.default_rng(0).standard_normal((1, 3, 32, 32)).astype(
        np.float32)
    ja = jm.resnet18(num_classes=8).cost_analysis(x)
    ja = ja[0] if isinstance(ja, list) else ja
    ca = tm.resnet18(num_classes=8, device="cpu").cost_analysis(x)
    assert set(ca) == {"flops", "bytes accessed"}
    assert 1.6 <= ca["flops"] / ja["flops"] <= 1.8
    assert 0.3 <= ca["bytes accessed"] / ja["bytes accessed"] <= 0.4


def test_read_net_debug_prints_what_the_jax_package_prints(tmp_path,
                                                            capsys):
    """``read_net(path, True)``: ``debug`` prints each layer's JSON before
    loading, as the JAX package's does, and the device is keyword-only (a
    stray positional True can no longer become a device)."""
    from planer_tpu import io as jio
    net = tm.resnet18(num_classes=8, device="cpu")
    p = pt.save_pla(str(tmp_path / "r18"), net.graph, net.weights)
    capsys.readouterr()
    tnet = pt.read_net(p, True, device="cpu")
    printed_t = capsys.readouterr().out.splitlines()
    jnet = jio.read_net(p, debug=True)
    printed_j = capsys.readouterr().out.splitlines()
    assert printed_t == printed_j
    assert len(printed_t) == len(net.graph.layers)
    x = np.random.default_rng(3).standard_normal(
        (2, 3, 32, 32)).astype(np.float32)
    np.testing.assert_allclose(tnet(x), np.asarray(jnet.forward(x)),
                               rtol=1e-4, atol=1e-4)
    with pytest.raises(TypeError):
        pt.read_net(p, False, "cpu")
    assert pt.InferenceSession is pt.read_net


def test_bf16_outputs_widen_to_float32():
    """The port's numpy of a bfloat16 tensor is float32 (exact); the JAX
    package's is an ``ml_dtypes`` bfloat16 array, which the port may not
    import.  Same values."""
    v = torch.tensor([1.0, -2.5, 3.0e38, 1.0 / 3.0]).to(torch.bfloat16)
    got = pt.asnumpy(v)
    want = J.asnumpy(J.asarray(np.asarray(v.float()), dtype="bfloat16"))
    assert got.dtype == np.float32 and want.dtype == ml_dtypes.bfloat16
    np.testing.assert_array_equal(got, want.astype(np.float32))
    from planer_tpu_torch.runtime.net import _numpy
    out = _numpy((v, v.float()))
    assert [o.dtype for o in out] == [np.float32, np.float32]
    np.testing.assert_array_equal(out[0], got)
