"""The port's frontends against the JAX package's: the ONNX protobuf codec
(the same bytes, a round trip), ``convert_model`` on every graph of
tests/test_onnx.py (the same graph JSON, array-equal weights, the same
errors), ``fx_to_graph`` on every module of tests/test_torch2planer.py and
on a torchvision-layout ResNet-18 (the same graph JSON and weights, the
port's float32 executor within that test's 1e-4 of the module), the
``.onnx`` entry points (``read_net``, ``onnx2pla``), and the whole slice:
that ResNet-18 through ``torch2planer`` and through ONNX bytes, at 224
and batch 2, optimize -> calibrate -> static INT8, with the same graph
and scales as the JAX package and logits within test_torch_resnet18.py's
bounds of the JAX program's (5e-3 of max|y| in f32, 0.02 in bf16).
"""
import copy
import os
import sys
from collections import Counter

import numpy as np
import pytest

import torch
import torch.nn as nn
import torch.nn.functional as F

from planer_tpu.frontend import onnx_proto as JP
from planer_tpu.frontend.onnx_convert import convert_model as j_convert
from planer_tpu.frontend.torch2planer import fx_to_graph as j_fx
from planer_tpu.ir import unpack_weights as j_unpack
from planer_tpu.models import eval as jev
from planer_tpu.quant import calibrate_act_scales as j_calibrate
from planer_tpu.quant import make_quant_program as j_program
from planer_tpu.runtime.net import Net as JNet

import planer_tpu_torch as pt
from planer_tpu_torch import models as tm
from planer_tpu_torch.frontend import onnx_proto as TP
from planer_tpu_torch.frontend.onnx_convert import convert_model as t_convert
from planer_tpu_torch.frontend.torch2planer import fx_to_graph as t_fx
from planer_tpu_torch.ir import unpack_weights as t_unpack
from planer_tpu_torch.quant import calibrate_act_scales as t_calibrate
from planer_tpu_torch.runtime.net import Net as TNet

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
import chip_smoke  # noqa: E402  (the ResNet-18 module and its ONNX writer)


# ------------------------------------------------------------------ codec

def _a_i(name, v):
    return JP.AttributeProto(name=name, i=v, type=JP.ATTR.INT)


def _a_f(name, v):
    return JP.AttributeProto(name=name, f=v, type=JP.ATTR.FLOAT)


def _a_ints(name, v):
    return JP.AttributeProto(name=name, ints=list(v), type=JP.ATTR.INTS)


def _a_s(name, v):
    return JP.AttributeProto(name=name, s=v.encode(), type=JP.ATTR.STRING)


def _vi(name, shape):
    return JP.ValueInfoProto(name=name, elem_type=1, shape=list(shape))


def _model(nodes, inits, inputs, outputs):
    return JP.ModelProto(graph=JP.GraphProto(
        node=nodes, name="g", initializer=[JP.from_array(a, n)
                                           for n, a in inits],
        input=inputs, output=outputs))


def _small(rng):
    """tests/test_onnx.py's small model: Conv -> BatchNormalization (eps
    1e-3) -> Relu -> GlobalAveragePool -> Flatten -> Gemm (transB 0)."""
    f = np.float32
    inits = [("conv.w", (rng.standard_normal((4, 3, 3, 3)) * 0.3).astype(f)),
             ("conv.b", rng.standard_normal(4).astype(f)),
             ("bn.s", (1 + 0.1 * rng.standard_normal(4)).astype(f)),
             ("bn.b", (0.1 * rng.standard_normal(4)).astype(f)),
             ("bn.m", (0.1 * rng.standard_normal(4)).astype(f)),
             ("bn.v", (1 + 0.1 * np.abs(rng.standard_normal(4))).astype(f)),
             ("gemm.w", (rng.standard_normal((4, 2)) * 0.3).astype(f)),
             ("gemm.b", rng.standard_normal(2).astype(f))]
    nodes = [
        JP.NodeProto(input=["x", "conv.w", "conv.b"], output=["c1"],
                     name="conv1", op_type="Conv",
                     attribute=[_a_ints("kernel_shape", [3, 3]),
                                _a_ints("pads", [1, 1, 1, 1]),
                                _a_ints("strides", [1, 1]),
                                _a_ints("dilations", [1, 1]),
                                _a_i("group", 1)]),
        JP.NodeProto(input=["c1", "bn.s", "bn.b", "bn.m", "bn.v"],
                     output=["b1"], name="bn1",
                     op_type="BatchNormalization",
                     attribute=[_a_f("epsilon", 1e-3)]),
        JP.NodeProto(input=["b1"], output=["r1"], name="relu1",
                     op_type="Relu"),
        JP.NodeProto(input=["r1"], output=["g1"], name="gap1",
                     op_type="GlobalAveragePool"),
        JP.NodeProto(input=["g1"], output=["f1"], name="flat1",
                     op_type="Flatten", attribute=[_a_i("axis", 1)]),
        JP.NodeProto(input=["f1", "gemm.w", "gemm.b"], output=["y"],
                     name="gemm1", op_type="Gemm",
                     attribute=[_a_i("transB", 0)])]
    return (_model(nodes, inits, [_vi("x", (1, 3, 8, 8))],
                   [_vi("y", (1, 2))]), (1, 3, 8, 8))


def _constant(rng):
    nodes = [JP.NodeProto(input=[], output=["c"], name="konst",
                          op_type="Constant",
                          attribute=[JP.AttributeProto(
                              name="value", type=JP.ATTR.TENSOR,
                              t=JP.from_array(np.array([2.0, 3.0],
                                                       np.float32)))]),
             JP.NodeProto(input=["x", "c"], output=["y"], name="addc",
                          op_type="Add")]
    return _model(nodes, [], [_vi("x", (2,))], [_vi("y", (2,))]), (2,)


def _squeeze13(rng):
    nodes = [JP.NodeProto(input=["x", "ax"], output=["y"], name="sq",
                          op_type="Squeeze")]
    return (_model(nodes, [("ax", np.array([0], np.int64))],
                   [_vi("x", (1, 3))], [_vi("y", (3,))]), (1, 3))


def _lstm(rng):
    L, N, D, H = 4, 2, 6, 5
    f = np.float32
    inits = [("w", (rng.standard_normal((1, 4 * H, D)) * 0.3).astype(f)),
             ("r", (rng.standard_normal((1, 4 * H, H)) * 0.3).astype(f)),
             ("b", (rng.standard_normal((1, 8 * H)) * 0.1).astype(f))]
    nodes = [JP.NodeProto(input=["x", "w", "r", "b"],
                          output=["y", "yh", "yc"], name="rnn",
                          op_type="LSTM",
                          attribute=[_a_i("hidden_size", H),
                                     _a_s("direction", "forward")])]
    return (_model(nodes, inits, [_vi("x", (L, N, D))],
                   [_vi("y", (L, 1, N, H))]), (L, N, D))


def _slice10(rng):
    i64 = np.int64
    nodes = [JP.NodeProto(input=["x", "st", "en", "ax", "sp"], output=["y"],
                          name="sl", op_type="Slice")]
    inits = [("st", np.array([1], i64)), ("en", np.array([4], i64)),
             ("ax", np.array([1], i64)), ("sp", np.array([2], i64))]
    return (_model(nodes, inits, [_vi("x", (2, 6))], [_vi("y", (2, 2))]),
            (2, 6))


def _auto_pad(rng):
    W = (rng.standard_normal((4, 3, 3, 3)) * 0.3).astype(np.float32)
    nodes = [JP.NodeProto(input=["x", "w"], output=["y"], name="c",
                          op_type="Conv",
                          attribute=[_a_ints("kernel_shape", [3, 3]),
                                     _a_ints("strides", [2, 2]),
                                     _a_s("auto_pad", "SAME_UPPER")])]
    return (_model(nodes, [("w", W)], [_vi("x", (1, 3, 13, 13))],
                   [_vi("y", (1, 4, 7, 7))]), (1, 3, 13, 13))


def _ceil_mode(rng):
    nodes = [JP.NodeProto(input=["x"], output=["y"], name="p",
                          op_type="MaxPool",
                          attribute=[_a_ints("kernel_shape", [3, 3]),
                                     _a_ints("strides", [2, 2]),
                                     _a_i("ceil_mode", 1)])]
    return (_model(nodes, [], [_vi("x", (1, 2, 14, 14))],
                   [_vi("y", (1, 2, 7, 7))]), (1, 2, 14, 14))


def _axes13(rng):
    nodes = [
        JP.NodeProto(input=["x", "ax0"], output=["u"], name="un",
                     op_type="Unsqueeze"),
        JP.NodeProto(input=["u", "sp"], output=["s1", "s2"], name="sp0",
                     op_type="Split", attribute=[_a_i("axis", 2)]),
        JP.NodeProto(input=["s1", "s2"], output=["m"], name="mu",
                     op_type="Mul"),
        JP.NodeProto(input=["m", "ax0"], output=["y"], name="sq",
                     op_type="Squeeze")]
    inits = [("ax0", np.array([0], np.int64)),
             ("sp", np.array([2, 2], np.int64))]
    return (_model(nodes, inits, [_vi("x", (3, 4))], [_vi("y", (3, 2))]),
            (3, 4))


GRAPHS = {"small": _small, "constant": _constant, "squeeze13": _squeeze13,
          "lstm": _lstm, "slice10": _slice10, "auto_pad": _auto_pad,
          "ceil_mode": _ceil_mode, "axes13": _axes13}


def _both(model):
    """The model's bytes (written by the JAX package's codec) parsed by each
    package's codec."""
    data = model.dump()
    return JP.ModelProto.parse(data), TP.ModelProto.parse(data), data


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_codec_writes_the_same_bytes_and_round_trips(name, tmp_path):
    jm, tm_, data = _both(GRAPHS[name](np.random.default_rng(0))[0])
    assert tm_.dump() == data == jm.dump()
    p = str(tmp_path / "m.onnx")
    TP.save_model(tm_, p)
    back = TP.load_model(p)
    assert back.dump() == data
    for a, b in zip(back.graph.initializer, jm.graph.initializer):
        np.testing.assert_array_equal(TP.to_array(a), JP.to_array(b))
        assert TP.from_array(TP.to_array(a), a.name).dump() == a.dump()
    assert TP.DTYPES == JP.DTYPES
    assert {k: v for k, v in vars(TP.ATTR).items() if k.isupper()} == \
        {k: v for k, v in vars(JP.ATTR).items() if k.isupper()}


def test_codec_varints():
    for v in (0, 1, 127, 128, 300, 2 ** 32, 2 ** 63 - 1, -1, -42):
        a, b = bytearray(), bytearray()
        TP._write_varint(a, v)
        JP._write_varint(b, v)
        assert a == b
        out, pos = TP._read_varint(memoryview(bytes(a)), 0)
        assert TP._signed(out) == v and pos == len(a)


def _same_graph(tg, tw, jg, jw):
    assert tg.to_json() == jg.to_json()
    assert len(tw) == len(jw)
    for a, b in zip(tw, jw):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_convert_model_matches_the_jax_converter(name):
    """The same graph JSON and byte-equal weights, and the port's program
    and float32 executor on the CPU give the JAX package's answers."""
    rng = np.random.default_rng(0)
    model, xshape = GRAPHS[name](rng)
    jm, tm_, _ = _both(model)
    jg, jblob = j_convert(jm)
    tg, tblob = t_convert(tm_)
    assert np.asarray(tblob).tobytes() == np.asarray(jblob).tobytes()
    tw, jw = t_unpack(tg, tblob), j_unpack(jg, jblob)
    _same_graph(tg, tw, jg, jw)
    x = rng.standard_normal(xshape).astype(np.float32)
    jnet = JNet(jg, jw)
    ref = jnet.forward(x, engine="numpy")
    tnet = TNet(tg, tw, device="cpu")
    for out in (tnet(x), tnet(x, engine="oracle")):
        for o, r in zip(out if isinstance(out, tuple) else (out,),
                        ref if isinstance(ref, tuple) else (ref,)):
            np.testing.assert_allclose(o, np.asarray(r), rtol=1e-5,
                                       atol=1e-5)


def test_convert_model_errors_match():
    """The Gemm with beta != 1 on a computed bias and an unknown op type
    raise in both converters, with the same message."""
    W = np.ones((3, 2), np.float32)
    gemm = _model([JP.NodeProto(input=["x"], output=["b"], name="r",
                                op_type="Relu"),
                   JP.NodeProto(input=["x", "w", "b"], output=["y"],
                                name="g", op_type="Gemm",
                                attribute=[_a_f("beta", 0.5)])],
                  [("w", W)], [_vi("x", (1, 3))], [_vi("y", (1, 2))])
    worm = _model([JP.NodeProto(input=["x"], output=["y"], name="w",
                                op_type="Wormhole")], [],
                  [_vi("x", (2,))], [_vi("y", (2,))])
    for model, match in ((gemm, "beta"), (worm, "Wormhole")):
        jm, tm_, _ = _both(model)
        with pytest.raises(NotImplementedError, match=match) as je:
            j_convert(jm)
        with pytest.raises(NotImplementedError, match=match) as te:
            t_convert(tm_)
        assert str(te.value) == str(je.value)


# ----------------------------------------------------------- torch2planer

class _ResBlock(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.c1 = nn.Conv2d(c, c, 3, padding=1)
        self.b1 = nn.BatchNorm2d(c)
        self.c2 = nn.Conv2d(c, c, 3, padding=1)

    def forward(self, x):
        y = F.relu(self.b1(self.c1(x)))
        return F.relu(self.c2(y) + x)


class _UNetMini(nn.Module):
    def __init__(self):
        super().__init__()
        self.d = nn.Conv2d(1, 8, 3, padding=1)
        self.up = nn.ConvTranspose2d(8, 4, 2, stride=2)
        self.pool = nn.MaxPool2d(2)
        self.head = nn.Conv2d(12, 1, 1)

    def forward(self, x):
        a = F.relu(self.d(x))
        c = self.up(self.pool(a))
        return torch.sigmoid(self.head(torch.cat([c, a], 1)))


class _Flat(nn.Module):
    def __init__(self):
        super().__init__()
        self.fc = nn.Linear(27, 9)

    def forward(self, x):
        return self.fc(torch.flatten(x, 1))


class _Interp(nn.Module):
    def forward(self, x):
        return F.interpolate(x, scale_factor=2, mode="bilinear",
                             align_corners=False)


class _PreluSilu(nn.Module):
    def __init__(self):
        super().__init__()
        self.c = nn.Conv2d(2, 4, 1)
        self.p = nn.PReLU(4)

    def forward(self, x):
        return F.silu(self.p(self.c(x)))


class _Avg1(nn.Module):
    def forward(self, x):
        return F.avg_pool2d(x, 3, 1, 1)


class _Avg2(nn.Module):
    def forward(self, x):
        return F.avg_pool2d(x, 3, stride=1, padding=1,
                            count_include_pad=False)


class _Max(nn.Module):
    def forward(self, x):
        return F.max_pool2d(x, 2, 2, 0)


class _View(nn.Module):
    def forward(self, x):
        return x.view(x.size(0), -1)


def _small_cnn():
    m = nn.Sequential(
        nn.Conv2d(3, 8, 3, padding=1), nn.BatchNorm2d(8), nn.ReLU(),
        nn.MaxPool2d(2), nn.Conv2d(8, 16, 3, padding=1, stride=2),
        nn.ReLU(), nn.AdaptiveAvgPool2d(1), nn.Flatten(), nn.Linear(16, 5))
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        m[1].running_mean.copy_(torch.randn(8, generator=g) * 0.5)
        m[1].running_var.copy_(0.5 + 1.5 * torch.rand(8, generator=g))
    return m


# name: (module builder, input shape, tolerance against the module)
MODULES = {
    "small_cnn": (_small_cnn, (2, 3, 16, 16), 1e-4),
    "residual": (lambda: nn.Sequential(nn.Conv2d(3, 8, 1), _ResBlock(8)),
                 (1, 3, 12, 12), 1e-4),
    "unet_mini": (_UNetMini, (1, 1, 16, 16), 1e-4),
    "flatten_linear": (_Flat, (2, 3, 3, 3), 1e-4),
    "upsample_leaky": (lambda: nn.Sequential(
        nn.Conv2d(2, 4, 1), nn.LeakyReLU(0.1),
        nn.Upsample(scale_factor=2, mode="nearest")), (1, 2, 5, 5), 1e-4),
    "bilinear": (lambda: nn.Sequential(nn.Upsample(
        scale_factor=2, mode="bilinear", align_corners=False)),
        (1, 1, 4, 4), 1e-5),
    "bilinear_corners": (lambda: nn.Sequential(nn.Upsample(
        scale_factor=2, mode="bilinear", align_corners=True)),
        (1, 1, 4, 4), 1e-5),
    "interpolate": (_Interp, (1, 2, 5, 5), 1e-5),
    "modern_activations": (lambda: nn.Sequential(
        nn.Conv2d(3, 8, 1), nn.GELU(), nn.Conv2d(8, 8, 1), nn.SiLU(),
        nn.Conv2d(8, 8, 1), nn.ReLU6(), nn.Hardswish(), nn.Softplus()),
        (1, 3, 6, 6), 1e-4),
    "prelu_silu": (_PreluSilu, (2, 2, 5, 5), 1e-4),
    "avg_pool_positional": (_Avg1, (1, 2, 6, 6), 1e-5),
    "avg_pool_exclude_pad": (_Avg2, (1, 2, 6, 6), 1e-5),
    "max_pool_positional": (_Max, (1, 2, 8, 8), 1e-6),
    "view_size": (_View, (2, 3, 4), 1e-4),
    "pla_roundtrip": (lambda: nn.Sequential(
        nn.Conv2d(3, 4, 3, padding=1), nn.ReLU(), nn.AdaptiveAvgPool2d(1),
        nn.Flatten(), nn.Linear(4, 2)), (1, 3, 8, 8), 1e-4),
}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_fx_to_graph_matches_the_jax_lowering(name):
    """The same graph JSON and weights as the JAX package's lowering; the
    port's program and float32 executor on the CPU within the JAX test's
    tolerance of the module's own forward."""
    build, shape, tol = MODULES[name]
    torch.manual_seed(0)
    module = build().eval()
    tg, tblob = t_fx(module)
    jg, jblob = j_fx(module)
    assert np.asarray(tblob).tobytes() == np.asarray(jblob).tobytes()
    tw = t_unpack(tg, tblob)
    _same_graph(tg, tw, jg, j_unpack(jg, jblob))
    x = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    with torch.no_grad():
        ref = module(torch.from_numpy(x)).numpy()
    net = TNet(tg, tw, device="cpu")
    for out in (net(x), net(x, engine="oracle")):
        np.testing.assert_allclose(out, ref, rtol=tol, atol=tol)


def test_fx_to_graph_errors_match():
    class Bad(nn.Module):
        def forward(self, x):
            return x.view(x.size(0) * x.size(1), -1)

    for module, match in ((nn.Sequential(nn.Conv2d(3, 4, 1), nn.GLU(1)),
                           "GLU"), (Bad(), "reshape")):
        with pytest.raises(NotImplementedError, match=match) as je:
            j_fx(module)
        with pytest.raises(NotImplementedError, match=match) as te:
            t_fx(module)
        assert str(te.value) == str(je.value)


def test_torch2planer_writes_a_pla_the_jax_package_reads(tmp_path):
    module = MODULES["pla_roundtrip"][0]().eval()
    p = pt.torch2planer(module, str(tmp_path / "m"))
    assert p.endswith(".pla")
    from planer_tpu import read_net as j_read
    x = np.random.default_rng(1).standard_normal((1, 3, 8, 8)).astype(
        np.float32)
    jref = np.asarray(j_read(str(tmp_path / "m")).forward(x,
                                                          engine="numpy"))
    out = pt.read_net(str(tmp_path / "m"), device="cpu")(x)
    np.testing.assert_allclose(out, jref, rtol=1e-5, atol=1e-5)
    q = pt.torch2planer(module, str(tmp_path / "q"), quantize="int8",
                        zip=False)
    assert q.endswith(".json")
    assert pt.read_net(str(tmp_path / "q"), device="cpu").graph.quant


# ---------------------------------------------------------- .onnx on disk

def test_read_net_and_onnx2pla(tmp_path):
    """read_net reads .onnx (after .pla and .json in the lookup order) and
    onnx2pla writes the JAX package's .pla."""
    from planer_tpu import io as jio
    model, xshape = _small(np.random.default_rng(0))
    p = str(tmp_path / "small.onnx")
    TP.save_model(TP.ModelProto.parse(model.dump()), p)
    x = np.random.default_rng(2).standard_normal(xshape).astype(np.float32)
    net = pt.read_net(p, device="cpu")
    ref = np.asarray(jio.read_net(p).forward(x, engine="numpy"))
    np.testing.assert_allclose(net(x), ref, rtol=1e-5, atol=1e-5)
    out = pt.onnx2pla(p)
    assert out == str(tmp_path / "small.pla")
    jg, _ = jio.load_graph(str(tmp_path / "small.pla"))
    tg, tblob = t_convert(TP.load_model(p))
    assert jg.to_json() == tg.to_json()
    # the .pla now comes first in the lookup
    assert pt.load_graph(p)[0].to_json() == tg.to_json()
    q = pt.onnx2pla(p, zip=False, quantize="int8")
    assert q == str(tmp_path / "small.json")


# ------------------------------------------------------ the whole slice

SIZE = 224


@pytest.fixture(scope="module")
def r18(tmp_path_factory):
    """The torchvision-layout ResNet-18 of chip_smoke.py, as fx graphs and
    as ONNX bytes written by its writer, in both packages."""
    module = chip_smoke.resnet18_module()
    path = str(tmp_path_factory.mktemp("r18") / "r18_onnx.onnx")
    chip_smoke.resnet18_onnx(module, path)
    data = open(path, "rb").read()
    return {"module": module, "onnx": path, "data": data}


def test_resnet18_graphs_match(r18):
    """Both frontends give the JAX package's graph JSON and weights, the
    ONNX writer writes bytes both codecs parse alike, and the fx graph runs
    the module's forward within 1e-4 on the port's CPU path."""
    module = r18["module"]
    tg, tblob = t_fx(module)
    jg, jblob = j_fx(module)
    _same_graph(tg, t_unpack(tg, tblob), jg, j_unpack(jg, jblob))
    assert {l.op for l in tg.layers} == {"conv", "batchnorm", "relu",
                                         "maxpool", "add", "gap", "flatten",
                                         "dense", "return"}
    og, oblob = t_convert(TP.ModelProto.parse(r18["data"]))
    jog, joblob = j_convert(JP.ModelProto.parse(r18["data"]))
    _same_graph(og, t_unpack(og, oblob), jog, j_unpack(jog, joblob))
    assert TP.ModelProto.parse(r18["data"]).dump() == r18["data"]
    x = next(jev.synthetic_images(1, (3, 64, 64), seed=5, batch=1))
    with torch.no_grad():
        ref = module(torch.from_numpy(x)).numpy()
    for g, blob in ((tg, tblob), (og, oblob)):
        out = TNet(g, t_unpack(g, blob), device="cpu")(x)
        assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()


def _calib():
    return list(jev.synthetic_images(1, (3, SIZE, SIZE), seed=3, batch=1))


@pytest.fixture(scope="module")
def slice_nets(r18, tmp_path_factory):
    """The whole slice through both frontends in both packages: optimize
    -> calibrate -> quantize("int8", activations="static").  The port's net
    ``t`` uses its own scales; ``tj`` is the same optimized net quantized
    with the JAX package's scales, so the passes alone are compared."""
    module = r18["module"]
    fx = pt.torch2planer(module, str(tmp_path_factory.mktemp("slice")
                                     / "r18_fx"))
    nets = {}
    for src, path in (("fx", fx), ("onnx", r18["onnx"])):
        if src == "fx":
            jg, jblob = j_fx(module)
        else:
            jg, jblob = j_convert(JP.ModelProto.parse(r18["data"]))
        jnet = JNet(jg, j_unpack(jg, jblob))
        jnet.optimize()
        j_scales = dict(j_calibrate(jnet, _calib()))
        jnet.quantize("int8", activations="static")
        tnet = pt.read_net(path, device="cpu")
        tnet.optimize()
        t_scales = dict(t_calibrate(tnet, _calib()))
        tj = TNet(copy.deepcopy(tnet.graph), [w.copy() for w in tnet.weights],
                  device="cpu")
        tj.graph.meta["act_scales"] = dict(j_scales)
        for net in (tnet, tj):
            net.quantize("int8", activations="static")
        nets[src] = {"t": tnet, "tj": tj, "j": jnet, "t_scales": t_scales,
                     "j_scales": j_scales}
    ref = tm.resnet18(device="cpu")
    ref.optimize()
    t_calibrate(ref, _calib())
    ref.quantize("int8", activations="static")
    nets["models_ops"] = Counter(l.op for l in ref.graph.layers)
    return nets


@pytest.mark.parametrize("src", ["fx", "onnx"])
def test_slice_graph_and_scales_match(slice_nets, src):
    """The same calibrated scales (float32 executors, 1e-5), and with the
    JAX package's scales the same quantized graph JSON and weight bytes;
    one stage64 and the opcodes of models.resnet18() through the same
    pipeline."""
    n = slice_nets[src]
    assert sorted(n["t_scales"]) == sorted(n["j_scales"])
    assert len(n["t_scales"]) == 20
    for k, v in n["j_scales"].items():
        np.testing.assert_allclose(n["t_scales"][k], v, rtol=1e-5,
                                   err_msg=k)
    _same_graph(n["tj"].graph, n["tj"].weights, n["j"].graph,
                n["j"].weights)
    tnet = n["t"]
    assert sum(l.op == "stage64" for l in tnet.graph.layers) == 1
    assert Counter(l.op for l in tnet.graph.layers) == \
        slice_nets["models_ops"]


def test_slice_frontends_agree(slice_nets):
    """Both imports quantize to the same weights (chip_smoke.op_weights,
    what path 12 checks on the card) and answer bit for bit alike on the
    CPU path."""
    a = chip_smoke.op_weights(slice_nets["fx"]["t"])
    b = chip_smoke.op_weights(slice_nets["onnx"]["t"])
    assert len(a) == len(b) > 40
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)
    xs = next(jev.synthetic_images(2, (3, SIZE, SIZE), seed=21, batch=2))
    np.testing.assert_array_equal(slice_nets["fx"]["t"](xs),
                                  slice_nets["onnx"]["t"](xs))


def _jax_run(jnet, xs, cdt):
    prog = j_program(jnet.graph, jnet.weights, compute_dtype=cdt)
    prog.op_overrides = {"stage64": {"interpret": True}}
    return np.asarray(prog(xs))


@pytest.mark.parametrize("cdt", ["float32", "bfloat16"])
@pytest.mark.parametrize("src", ["fx", "onnx"])
def test_slice_logits_match_the_jax_package(slice_nets, src, cdt):
    """Static INT8 at 224, batch 2: the port's program (the stage64
    kernels' plain versions on the CPU) on the JAX package's quantized net
    against the JAX program (stage64 in interpret mode), max|d|/max|y|
    within test_torch_resnet18.py's bounds, 5e-3 in f32 and 0.02 in bf16
    (a few flipped codes amplify downstream); the port's own pipeline
    within 0.02."""
    n = slice_nets[src]
    cd = None if cdt == "float32" else cdt
    xs = next(jev.synthetic_images(2, (3, SIZE, SIZE), seed=21, batch=2))
    yj = _jax_run(n["j"], xs, cd)
    rels = []
    # the same quantized net, then the port's own pipeline (its own scales)
    for net in (n["tj"], n["t"]):
        tnet = pt.net_from_arrays(net.graph.to_json_dict(), net.weights,
                                  device="cpu", compute_dtype=cd)
        yt = tnet(xs)
        assert yt.dtype == np.float32 and yt.shape == yj.shape == (2, 1000)
        rels.append(float(np.abs(yt - yj).max() / np.abs(yj).max()))
    print(f"{src} {cdt} logits: max|d|/max|y| = {rels}")
    # f32: test_torch_resnet18.py's 5e-3; bf16: its 0.02 (the reference's
    # skipped bf16 roundings flip codes that amplify: 9.2e-3 here)
    assert rels[0] <= (5e-3 if cd is None else 0.02)
    # the port's own scales sit within 1e-5 of the reference's (float32
    # executors summing in another order), and the quantized chain
    # amplifies the codes they flip: 5.6e-3 in f32 here
    assert rels[1] <= 0.02


# ------------------------------------------- chip_smoke.py's path 13 graphs

def _smoke_graphs():
    rng = np.random.default_rng(0)
    x = np.asarray(rng.standard_normal((2, 8, 12, 12)) * 2, np.float32)
    out = {"zoo": (chip_smoke.op_zoo(rng), x)}
    for op, lens in (("LSTM", True), ("GRU", False)):
        xs = np.asarray(rng.standard_normal((16, 8, 64)), np.float32)
        out[f"{op.lower()}"] = (chip_smoke.rnn_onnx(op, rng, lens), xs)
    out["tail"] = (chip_smoke.tail_onnx(), x)
    return out


@pytest.mark.parametrize("name", ["zoo", "lstm", "gru", "tail"])
def test_smoke_op_graphs_match_the_jax_package(name):
    """The ONNX graphs chip_smoke.py's path 13 runs on the card (the op
    zoo, the LSTM and GRU, the graph cut at nonzero) convert to the JAX
    converter's graph, and the port's program on the CPU answers as the
    JAX package's (jit prefix and numpy tail): integers equal, floats
    within 1e-5 of max|y| (op by op the bounds of test_torch_ops_lib.py
    hold)."""
    from planer_tpu.ops import modes as jmodes
    from planer_tpu_torch.ops import modes as tmodes
    (model, outs), x = _smoke_graphs()[name]
    data = model.dump()
    tg, tblob = t_convert(TP.ModelProto.parse(data))
    jg, jblob = j_convert(JP.ModelProto.parse(data))
    tw = t_unpack(tg, tblob)
    _same_graph(tg, tw, jg, j_unpack(jg, jblob))
    tnet = TNet(tg, tw, device="cpu")
    if name == "tail":
        assert tnet.program.plan.cut == 1
    for mode in (("exact", "lut") if name == "zoo" else ("exact",)):
        jmodes.set_erf_mode(mode)
        tmodes.set_erf_mode(mode)
        try:
            # a JAX program bakes the erf mode in when it compiles; the
            # port reads it at call time
            got, ref = tnet(x), JNet(jg, j_unpack(jg, jblob))(x)
        finally:
            jmodes.set_erf_mode("exact")
            tmodes.set_erf_mode("exact")
        got = got if isinstance(got, tuple) else (got,)
        ref = ref if isinstance(ref, tuple) else (ref,)
        assert len(got) == len(ref) == len(outs)
        for (oname, opcode), a, b in zip(outs, got, ref):
            a, b = np.asarray(a), np.asarray(b)
            assert a.shape == b.shape, (oname, opcode)
            if a.dtype.kind != "f":
                np.testing.assert_array_equal(a, b, err_msg=opcode)
            else:
                big = np.abs(b).max() if b.size else 0.0
                assert np.abs(a - b).max() <= 1e-5 * big, (opcode, mode)
    covered = {op for _, op in outs}
    if name == "zoo":
        assert chip_smoke.OP_LIBRARY - covered == {"const", "lstm", "gru",
                                                  "nonzero"}
