"""YOLO-v3 in the port (planer_tpu_torch/models/yolov3.py, yolo_post.py,
native/, models/eval.py) against the JAX package, on the CPU, at full width
(Darknet-53 and the FPN heads, 62M parameters) and small sides.

The JAX package runs as its own tests run it: jitted, the weight-only 1x1
route's Pallas kernel in interpret mode.  Tolerances, stated per test:
  * f32 raw heads and the f32 decode: 1e-5 of each head's largest value
    (XLA's conv sums in another order);
  * bf16 raw heads: XLA keeps f32 between fused bf16 ops (excess
    precision) where the port rounds; over 75 convs the heads part by a
    few bf16 roundings (p99 2e-2 and max 5e-2 of the largest value);
  * the bf16 decode on the same heads: one bf16 ulp per element (XLA skips
    the last bf16 rounding of the values the concat promotes to f32);
  * the weight-only route and static W8A8: a few f32 sum-order differences
    flip a bf16 rounding (route) or an int8 code (W8A8) near its boundary,
    and the 75 convs carry the flipped values on.  The first code-emitting
    add has at most 1 code in 1,000 one apart; the heads stay within a
    median of 1e-2 and a p99 of 5e-2 of their largest value, below the
    reference's own gap to its float32 oracle.
"""
import copy
import functools

import numpy as np
import pytest


import planer_tpu.models as jm
from planer_tpu import io as jio
from planer_tpu.ir import Graph as JGraph
from planer_tpu.models import eval as jev
from planer_tpu.models import yolo_post as jpost
from planer_tpu.models.builder import GraphBuilder as JB
from planer_tpu.models.yolov3 import _decode_head as jdecode
from planer_tpu.ops import jax_ops as jops
from planer_tpu.ops.pallas import gemm as jg
from planer_tpu.quant import calibrate_act_scales as jcalibrate
from planer_tpu.runtime.net import Net as JNet

import planer_tpu_torch as pt
import planer_tpu_torch.models as tm
from planer_tpu_torch import io as tio
from planer_tpu_torch import native
from planer_tpu_torch.models import eval as tev
from planer_tpu_torch.models import yolo_post as tpost
from planer_tpu_torch.models.builder import GraphBuilder as TB
from planer_tpu_torch.models.yolov3 import _decode_head as tdecode
from planer_tpu_torch.ops import torch_ops as tops
from planer_tpu_torch.ops.kernels import gemm as tg
from planer_tpu_torch.quant import calibrate_act_scales

C = 4      # classes: 27 head channels


@pytest.fixture(scope="module")
def ref():
    """The JAX package's YOLO-v3 (4 classes, seed 0), BN folded."""
    net = jm.yolov3(num_classes=C)
    net.optimize()
    return net


def _port(jnet, compute_dtype=None):
    return pt.net_from_arrays(jnet.graph.to_json_dict(), jnet.weights,
                              device="cpu", compute_dtype=compute_dtype)


def _heads(out):
    return [np.asarray(h) for h in (out if isinstance(out, (tuple, list))
                                    else [out])]


def _rel(a, b):
    """Per head: |d| / max|ref| as an array."""
    return [np.abs(np.asarray(x) - np.asarray(y)) / np.abs(np.asarray(x)).max()
            for x, y in zip(a, b)]


def _ulp_bf16(v):
    v = np.abs(np.asarray(v, np.float32))
    return np.exp2(np.floor(np.log2(np.maximum(v, 2.0 ** -126))) - 7)


@pytest.mark.parametrize("decode", [False, True])
def test_builder_makes_the_reference_graph_and_weights(decode):
    jn = jm.yolov3(num_classes=C, decode=decode)
    tn = tm.yolov3(num_classes=C, decode=decode, device="cpu")
    assert tn.device.type == "cpu"
    assert tn.graph.to_json() == jn.graph.to_json()
    assert len(tn.weights) == len(jn.weights)
    for a, b in zip(jn.weights, tn.weights):
        assert a.dtype == b.dtype and np.array_equal(a, b)
    n = sum(w.size for w in tn.weights if w.dtype == np.float32)
    assert 61.5e6 < n < 62.5e6


def test_f32_heads_match_reference(ref):
    x = next(jev.synthetic_images(2, (3, 128, 128), seed=1, batch=2))
    hj, ht = _heads(ref(x)), _heads(_port(ref)(x))
    assert [h.shape for h in ht] == [(2, 27, 4, 4), (2, 27, 8, 8),
                                     (2, 27, 16, 16)]
    for d in _rel(hj, ht):
        assert d.max() <= 1e-5


def test_bf16_heads_match_reference(ref):
    x = next(jev.synthetic_images(2, (3, 128, 128), seed=2, batch=2))
    jn = JNet(ref.graph, ref.weights, compute_dtype="bfloat16")
    hj, ht = _heads(jn(x)), _heads(_port(ref, "bfloat16")(x))
    for h in ht:
        assert h.dtype == np.float32 and np.isfinite(h).all()
    for d in _rel(hj, ht):
        assert np.percentile(d, 99) <= 2e-2 and d.max() <= 5e-2


def test_decode_matches_reference_f32():
    """decode=True end to end: the shape chain folds on the host, the box
    math runs as device ops; (N, 3 * (3^2 + 6^2 + 12^2), 5 + C) at 96."""
    jn = jm.yolov3(num_classes=C, decode=True)
    jn.optimize()
    x = next(jev.synthetic_images(1, (3, 96, 96), seed=3, batch=1))
    yj, yt = np.asarray(jn(x)), _port(jn)(x)
    assert yt.shape == yj.shape == (1, 567, 9) and yt.dtype == np.float32
    assert np.abs(yt - yj).max() <= 1e-5 * np.abs(yj).max()
    # the host decode (yolo_post) of the same net's raw heads: the same boxes
    raw = jm.yolov3(num_classes=C)
    raw.optimize()
    host = tpost.decode_heads(_heads(_port(raw)(x)), img_size=96)
    assert np.abs(host - yt).max() <= 1e-5 * np.abs(yt).max()


def _decode_nets(stride):
    nets = []
    for builder, decode in ((JB, jdecode), (TB, tdecode)):
        b = builder(["t"])
        b.ret(decode(b, "t", stride, C))
        nets.append(b.build_net() if builder is JB else b.build_net("cpu"))
    return nets


@pytest.mark.parametrize("stride,side", [(32, 3), (8, 12)])
def test_decode_promotes_as_the_reference(stride, side):
    """The decode on the same bf16 heads.  The grid is a host value, not
    cast to the compute dtype, so ``sigmoid(xy) + grid`` is f32 and so is
    ``xy * stride``; ``wh`` (exp times the bf16-cast anchors) and the
    class scores stay bf16; the concat promotes to f32.  The port's xy
    columns equal that f32 arithmetic exactly (the pin: a bf16 grid would
    round them), the others are bf16 values, and every element is within
    one bf16 ulp of the reference's."""
    jn, tn = _decode_nets(stride)
    rng = np.random.default_rng(stride)
    t = (rng.standard_normal((2, 27, side, side)) * 2).astype(np.float32)
    for n in (jn, tn):
        n.astype_compute("bfloat16")
    yj, yt = np.asarray(jn(t)), tn(t)
    assert yt.dtype == yj.dtype == np.float32
    assert (np.abs(yt - yj) <= _ulp_bf16(yj)).all()
    # the f32 xy: (bf16 sigmoid + grid) * stride, rounded in f32 only
    import torch
    tb = torch.as_tensor(t).bfloat16()
    t5 = tb.reshape(2, 3, 9, side, side).permute(0, 1, 3, 4, 2)
    sig = tops.sigmoid(t5[..., 0:2]).float()
    gy, gx = torch.meshgrid(torch.arange(side), torch.arange(side),
                            indexing="ij")
    grid = torch.stack([gx, gy], -1).float()
    xy = ((sig + grid) * float(stride)).reshape(2, -1, 2).numpy()
    np.testing.assert_array_equal(yt[..., :2], xy)
    assert not np.array_equal(xy, torch.as_tensor(xy).bfloat16().float())
    rest = yt[..., 2:]
    np.testing.assert_array_equal(
        rest, torch.as_tensor(rest).bfloat16().float().numpy())


@pytest.fixture
def route(monkeypatch):
    """The 1x1 route on both sides, the JAX kernel in interpret mode; counts
    kernel-branch and fallback calls on each side."""
    seen = {"jax": 0, "port": 0, "port_fallback": 0}
    monkeypatch.setattr(jops, "_PALLAS_CONV1X1", True)
    monkeypatch.setattr(tops, "_PALLAS_CONV1X1", True)
    monkeypatch.setattr(jg, "dense_q", functools.partial(jg.dense_q,
                                                         interpret=True))
    for mod, name, key in ((jg, "_dense_q_pallas", "jax"),
                           (tg, "dense_q_plain", "port"),
                           (tg, "fallback_dense", "port_fallback")):
        f = getattr(mod, name)

        def counted(*a, _f=f, _k=key, **kw):
            seen[_k] += 1
            return _f(*a, **kw)
        monkeypatch.setattr(mod, name, counted)
    return seen


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_weight_only_route_matches_reference(ref, route, dtype):
    """Weight-only int8 with the 1x1 route: 31 GEMMs per forward take the
    kernel branch on both sides (the port's plain version against the
    Pallas kernel run in interpret mode) and 6 the fallback."""
    jn = jm.yolov3(num_classes=C)
    jn.optimize()
    jn.quantize("int8")
    cd = None if dtype == "float32" else dtype
    jn.astype_compute(cd)
    x = next(jev.synthetic_images(1, (3, 128, 128), seed=4, batch=1))
    hj = _heads(jn(x))
    ht = _heads(_port(jn, cd)(x))
    assert route == {"jax": 31, "port": 31, "port_fallback": 6}
    for d in _rel(hj, ht):
        assert np.median(d) <= 1e-2 and np.percentile(d, 99) <= 5e-2


def _calibrated(jnet, side=128):
    """jnet (BN folded) with the port's calibration, quantized W8A8 static
    on the JAX side; the same graph and weights in the port."""
    jn = JNet(copy.deepcopy(jnet.graph), list(jnet.weights))
    scales = calibrate_act_scales(
        _port(jn), jev.synthetic_images(4, (3, side, side), seed=11, batch=2))
    jn.graph.meta["act_scales"] = dict(scales)
    jn.quantize("int8", activations="static")
    return jn


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_static_w8a8_matches_reference(ref, dtype):
    jn = _calibrated(ref)
    cd = None if dtype == "float32" else dtype
    jn.astype_compute(cd)
    x = next(jev.synthetic_images(4, (3, 128, 128), seed=5, batch=4))
    # the first add that emits codes: its codes against the reference's
    g = jn.graph.to_json_dict()
    i = next(i for i, e in enumerate(g["flow"])
             if "r2.0.add" in e[1])
    g["flow"] = g["flow"][:i + 1] + [[g["flow"][i][2], "return", "plrst"]]
    cj = np.asarray(JNet(JGraph.from_json_dict(copy.deepcopy(g)),
                         jn.weights, compute_dtype=cd)(x))
    ct = pt.net_from_arrays(g, jn.weights, device="cpu",
                            compute_dtype=cd)(x)
    assert cj.dtype == ct.dtype == np.int8
    flips = cj != ct
    print(f"{dtype}: {flips.mean():.3g} of the codes one apart")
    assert flips.mean() <= (1e-3 if cd is None else 0.1)
    assert np.abs(cj.astype(int) - ct.astype(int)).max() <= 1
    hj, ht = _heads(jn(x)), _heads(_port(jn, cd)(x))
    for d in _rel(hj, ht):
        assert np.median(d) <= 1e-2 and np.percentile(d, 99) <= 5e-2


def _gap(y, ref):
    """Per image: max|d| / max|ref| over the three heads side by side."""
    y = np.concatenate([h.reshape(h.shape[0], -1) for h in _heads(y)], 1)
    r = np.concatenate([h.reshape(h.shape[0], -1) for h in _heads(ref)], 1)
    return np.abs(y - r).max(1) / np.abs(r).max(1)


def test_w8a8_gap_to_the_executor_is_the_references(ref):
    """Static W8A8 in bf16 sits as far from the float32 executor in the
    port as in the JAX package (within 25% and 0.01): the gap is the
    reference's arithmetic on this random-weight net, not the port's
    (chip_smoke.py bounds path 8's leg 3 by it)."""
    jn = _calibrated(ref)
    jn.astype_compute("bfloat16")
    tn = _port(jn, "bfloat16")
    x = next(jev.synthetic_images(4, (3, 128, 128), seed=29, batch=4))
    oracle = tn(x, engine="oracle")
    gap_t, gap_j = _gap(tn(x), oracle), _gap(jn(x), oracle)
    print(f"W8A8 bf16 gap to the executor: port {np.round(gap_t, 4)}, "
          f"JAX package {np.round(gap_j, 4)}")
    assert gap_t.max() <= 1.25 * gap_j.max() + 0.01


def test_pipeline_gives_the_reference_graph():
    """optimize (bias-less convs fold the BN), calibration through the
    float32 executor, quantize(activations="static") with annotate: the
    same graph, scales (1e-5: f32 sums in another order) and annotations;
    leakyrelu ends a code chain, so no conv emits codes and only the
    residual adds do."""
    jn, tn = jm.yolov3(num_classes=C), tm.yolov3(num_classes=C, device="cpu")
    jn.optimize()
    tn.optimize()
    assert tn.graph.to_json() == jn.graph.to_json()
    batches = lambda: jev.synthetic_images(2, (3, 64, 64), seed=11,  # noqa
                                           batch=2)
    sj, st = jcalibrate(jn, batches()), calibrate_act_scales(tn, batches())
    assert sorted(sj) == sorted(st) and len(st) == 75
    for k in sj:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-5, err_msg=k)
    for n in (jn, tn):
        n.quantize("int8", activations="static")
    gj, gt = jn.graph.to_json_dict(), tn.graph.to_json_dict()
    assert gt["quant"] == gj["quant"] and gt["inits"] == gj["inits"]
    assert len(gt["layers"]) == len(gj["layers"])
    for lj, lt in zip(gj["layers"], gt["layers"]):
        assert lj[:2] == lt[:2] and sorted(lj[2]) == sorted(lt[2])
        for k, v in lj[2].items():
            if k == "qadd":
                np.testing.assert_allclose(
                    [np.nan if s is None else s for s in lt[2][k]],
                    [np.nan if s is None else s for s in v], rtol=1e-5)
            else:
                assert lt[2][k] == v, (lj, lt)
    ops = {l[0]: l for l in gt["layers"]}
    assert not any("out_scale" in l[2] for l in ops.values())
    assert sum("qadd" in l[2] for l in ops.values()) == 22     # of 23 adds


def test_pla_written_by_jax_loads(tmp_path):
    """The JAX package's .pla of the decode graph (int64 shape-chain
    weights among the float ones) loads into the port with the same
    outputs as the arrays handed over directly."""
    jn = jm.yolov3(num_classes=C, decode=True)
    p = jio.save_pla(str(tmp_path / "yolo.pla"), jn.graph, jn.weights)
    loaded = tio.read_net(p, device="cpu")
    assert loaded.graph.to_json() == jn.graph.to_json()
    x = next(jev.synthetic_images(1, (3, 64, 64), seed=6, batch=1))
    y = loaded(x)
    np.testing.assert_array_equal(y, _port(jn)(x))
    assert np.abs(y - np.asarray(jn(x))).max() <= 1e-5 * np.abs(y).max()


# ------------------------------------------------------ host post-processing

class _FakeHeads:
    """A deterministic stand-in for a YOLO net: heads from the input's
    channel mean, pooled to each stride, plus fixed random offsets scaled
    so boxes come out anchor-sized (as _tame_heads does for a real net)."""

    def __init__(self, seed, size=128, jitter=0.0):
        rng = np.random.default_rng(seed)
        self.size, self.params = size, []
        for stride in (32, 16, 8):
            s = size // stride
            a = rng.standard_normal((1, 27, 1, 1)).astype(np.float32)
            b = rng.standard_normal((1, 27, s, s)).astype(np.float32)
            b = b.reshape(1, 3, 9, s, s)
            b[:, :, 2:4] *= 0.3
            b[:, :, 4:] *= 2.0
            b = b.reshape(1, 27, s, s)
            b += jitter * np.random.default_rng(seed + 1).standard_normal(
                b.shape).astype(np.float32)
            self.params.append((stride, a, b))

    def __call__(self, x):
        x = np.asarray(x, np.float32).mean(1, keepdims=True)
        out = []
        for stride, a, b in self.params:
            n, _, h, w = x.shape
            p = x.reshape(n, 1, h // stride, stride, w // stride,
                          stride).mean((3, 5))
            out.append((a * p + b).astype(np.float32))
        return tuple(out)


def test_decode_heads_and_detect_match_reference():
    net = _FakeHeads(0)
    x = next(jev.synthetic_images(2, (3, 128, 128), seed=7, batch=2))
    heads = net(x)
    np.testing.assert_array_equal(tpost.decode_heads(heads),
                                  jpost.decode_heads(heads))
    for kw in (dict(conf_thresh=0.25), dict(conf_thresh=0.1),
               dict(conf_thresh=0.25, return_candidates=True)):
        got, want = tpost.detect(net, x, **kw), jpost.detect(net, x, **kw)
        if kw.get("return_candidates"):
            got, want = got[0] + got[1], want[0] + want[1]
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.shape == b.shape and a.shape[0] > 0
            np.testing.assert_array_equal(a, b)


def test_detection_agreement_matches_reference():
    ref_net, test_net = _FakeHeads(0), _FakeHeads(0, jitter=0.05)
    for kw in (dict(), dict(conf_thresh=0.25, min_margin=0.05,
                            hysteresis=0.7, iou_hysteresis=0.7)):
        got = tev.detection_agreement(ref_net, test_net, n=3, size=128, **kw)
        want = jev.detection_agreement(ref_net, test_net, n=3, size=128,
                                       **kw)
        assert got == want and got["tp"] > 0
        assert tev.detection_agreement(ref_net, ref_net, n=2, size=128,
                                       **kw)["f1"] == 1.0


def test_native_nms_equals_numpy():
    """Random boxes (as the JAX package's test), ties in score (equal
    scores in index order in both versions), top_k and empty inputs."""
    rng = np.random.default_rng(8)
    boxes = np.abs(rng.standard_normal((300, 4))).astype(np.float32) * 50 + 5
    scores = rng.random(300).astype(np.float32)
    for iou, top_k in ((0.45, 300), (0.3, 20), (0.7, 1000)):
        kn = native.nms(boxes, scores, iou, top_k)
        np.testing.assert_array_equal(kn, tpost._nms_numpy(boxes, scores,
                                                           iou, top_k))
        np.testing.assert_array_equal(np.sort(kn), np.sort(
            jpost._nms_numpy(boxes, scores, iou, top_k)))
    tied = np.round(scores * 4) / 4               # five score levels
    dup = np.concatenate([boxes[:50], boxes[:50]])
    for b, s in ((boxes, tied), (dup, np.concatenate([scores[:50]] * 2))):
        np.testing.assert_array_equal(native.nms(b, s),
                                      tpost._nms_numpy(b, s))
    assert len(native.nms(dup, np.concatenate([scores[:50]] * 2))) <= 50
    empty = native.nms(np.zeros((0, 4), np.float32), np.zeros(0, np.float32))
    assert empty.shape == (0,) and empty.dtype == np.int64
    np.testing.assert_array_equal(tpost.nms(boxes, scores), native.nms(
        boxes, scores))


def test_native_score_filter_equals_numpy():
    rng = np.random.default_rng(9)
    dec = rng.random((500, 9)).astype(np.float32)
    dec[::7, 5:] = 0.5                            # class ties: first wins
    for thresh in (0.5, 0.2, 1.1):
        got = native.score_filter(dec, thresh)
        want = native.score_filter_numpy(dec, thresh)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)
    got = native.score_filter(dec[:0], 0.5)
    assert all(a.shape == (0,) for a in got)


def test_failed_nms_build_raises(monkeypatch, tmp_path):
    """No fallback: a source that does not compile raises with the
    compiler's output, and so does a missing compiler."""
    bad = tmp_path / "nms.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setenv("PLANER_TORCH_BUILD_DIR", str(tmp_path / "build"))
    with pytest.raises(RuntimeError, match="building nms.cpp failed"):
        native.nms(np.zeros((1, 4), np.float32), np.ones(1, np.float32))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    with pytest.raises(RuntimeError, match="no-such-compiler not found"):
        native.score_filter(np.zeros((1, 9), np.float32), 0.5)
    assert native._lib is None


def test_available_reports_the_build(monkeypatch, tmp_path):
    """``available()`` is a query: True where the library builds and loads,
    False where the source does not compile or the compiler is missing;
    ``nms`` and ``score_filter`` raise there all the same."""
    assert native.available() is True
    bad = tmp_path / "nms.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setenv("PLANER_TORCH_BUILD_DIR", str(tmp_path / "build"))
    assert native.available() is False
    with pytest.raises(RuntimeError, match="building nms.cpp failed"):
        native.nms(np.zeros((1, 4), np.float32), np.ones(1, np.float32))
    monkeypatch.setenv("CXX", str(tmp_path / "no-such-compiler"))
    assert native.available() is False
    with pytest.raises(RuntimeError, match="no-such-compiler not found"):
        native.score_filter(np.zeros((1, 9), np.float32), 0.5)
    assert native._lib is None and "available" in native.__all__
