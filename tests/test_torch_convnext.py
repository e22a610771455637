"""ConvNeXt in the port: the ``layernorm`` opcode against torch's
LayerNorm and its oracle, the zoo's ConvNeXt (``models.convnext``) against
the benchmark's plain reference (``portbench/configs/convnext_ref.py``) on
the CPU through the user's int8 pipeline, the ``dense.route.*``,
``conv.route.*`` and ``layernorm`` counters against the reference's route
plan, and a torch-defined ConvNeXt stem and blocks through
``torch2planer``.

The small size keeps every route of the benchmark's cell: widths (128,
128, 256, 256) make every Linear a ``dense_q`` kernel-branch GEMM and the
classifier (N = 1000) its fallback; at 128 px and b4 the first
downsampling conv reads 4 x 32 x 32 = 4,096 rows (W8A8), the other two
fewer (float), and the stem and every depthwise conv take the float
route."""
import json

import numpy as np
import pytest
import torch
import torch.nn as nn
import torch.nn.functional as F

from planer_tpu_torch import registry
from planer_tpu_torch.frontend.torch2planer import fx_to_graph
from planer_tpu_torch.ir import unpack_weights
from planer_tpu_torch.models import GraphBuilder, convnext, convnext_base
from planer_tpu_torch.models.convnext import weight_shapes
from planer_tpu_torch.ops import torch_ops as tops
from planer_tpu_torch.ops.qtypes import QTensor
from planer_tpu_torch.runtime import profiler
from planer_tpu_torch.runtime.net import Net
from portbench import compare, harness, inputs
from portbench.configs import convnext as cx
from portbench.configs import convnext_ref as ref

SIDE, BATCH, SEED = 128, 4, 2 ** 31 + 61
SMALL = {"depths": [1, 1, 2, 1], "widths": [128, 128, 256, 256],
         "image_side": SIDE}
# the program's logits against the reference's at the small size: the
# whole gap is the last rounding of the bfloat16 convs and LayerNorms
# (torch's bfloat16 kernels and the reference's wider sums round
# differently in a few elements, which then grow through the blocks; with
# the library's kernels in their places the reference is the program bit
# for bit, below).  Sound readings are 0.0051-0.0090 over 8 seeds, the
# 4-bit control's 0.30-0.38
TOL = 0.05


def config(**kw):
    c = next(c for c in harness.load_spec()["configs"]
             if c["name"] == "convnext-base-int8-224")
    with open(harness.CHECKOUT / c["file"]) as f:
        return {**json.load(f), **kw}


@pytest.fixture(scope="module")
def built():
    cfg = config(**SMALL)
    a = cx.arrays(cfg, SEED, "cpu")
    cal = cx.calibration(cfg, SEED, "cpu")
    net = cx.build(cfg, a, cal, "cpu")
    x = inputs.images(BATCH, SIDE, inputs.generator(SEED, "test", "cpu"))
    with profiler.record() as rec:
        y = net(x)
    return {"cfg": cfg, "arrays": a, "calib": cal, "net": net, "x": x,
            "y": y, "counters": dict(rec.counters),
            "ref": cx.reference(cfg, a, cal, "cpu")}


def _bf16_ulps(got, want):
    """|got - want| in units of the bfloat16 spacing at want."""
    w = want.float()
    spacing = torch.finfo(torch.bfloat16).eps * torch.exp2(
        torch.floor(torch.log2(w.abs().clamp_min(1e-30))))
    return float(((got.float() - w).abs() / spacing).max())


@pytest.mark.parametrize("axis", [-1, -2])
def test_layernorm_is_torchs_in_float32_and_its_oracle(axis):
    rng = np.random.default_rng(1)
    x = torch.as_tensor(rng.standard_normal((2, 5, 6, 64)) * 3 + 1,
                        dtype=torch.float32)
    shape = x.shape[axis:]
    s = torch.as_tensor(1 + 0.1 * rng.standard_normal(shape),
                        dtype=torch.float32)
    b = torch.as_tensor(0.1 * rng.standard_normal(shape), dtype=torch.float32)
    want = F.layer_norm(x, shape, s, b, 1e-6)
    spec = registry.get_op("layernorm")
    for fn in (spec.fn, spec.oracle_fn):
        got = fn(x, s, b, axis=axis, epsilon=1e-6)
        assert got.dtype == torch.float32
        torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the default epsilon is ONNX's
    torch.testing.assert_close(tops.layernorm(x, s, b, axis=axis),
                               F.layer_norm(x, shape, s, b, 1e-5),
                               rtol=0, atol=0)


def test_layernorm_in_bf16_rounds_the_float32_result_once():
    """A bf16 x takes its statistics and affine in float32 with the scale
    and bias rounded to bf16: within one bf16 ulp of the float32 LayerNorm
    of the same bf16 values, rounded."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((4, 7, 7, 256)) * 4 - 2,
                        dtype=torch.float32).to(torch.bfloat16)
    s = torch.as_tensor(1 + 0.05 * rng.standard_normal(256),
                        dtype=torch.float32)
    b = torch.as_tensor(0.05 * rng.standard_normal(256), dtype=torch.float32)
    got = tops.layernorm(x, s, b, epsilon=1e-6)
    assert got.dtype == torch.bfloat16
    sb, bb = (v.to(torch.bfloat16).float() for v in (s, b))
    want = registry.get_op("layernorm").oracle_fn(x.float(), sb, bb,
                                                  epsilon=1e-6)
    torch.testing.assert_close(
        want, F.layer_norm(x.float(), (256,), sb, bb, 1e-6), rtol=0, atol=0)
    assert _bf16_ulps(got, want) <= 1.0


def test_layernorm_counts_each_application_and_the_builder_has_it():
    b = GraphBuilder(["x"])
    y = b.layernorm("x", b.weight("s", np.ones(8, np.float32)),
                    b.weight("b", np.zeros(8, np.float32)), epsilon=1e-6)
    b.ret(b.layernorm(y, b.weight("s2", np.ones(8, np.float32)),
                      b.weight("b2", np.zeros(8, np.float32))))
    net = b.build_net("cpu")
    x = np.random.default_rng(3).standard_normal((3, 8)).astype(np.float32)
    with profiler.record() as rec:
        out = net(x)
    assert rec.counters["layernorm"] == 2
    want = F.layer_norm(F.layer_norm(torch.as_tensor(x), (8,), eps=1e-6),
                        (8,))
    np.testing.assert_allclose(out, want.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape, want", [
    ((4, 32, 32, 128), "kernel"), ((8, 256), "kernel"), ((7, 256), "fallback"),
    ((1, 1, 7, 128), "fallback"), ((4, 1000), "fallback")])
def test_dense_route_reads_the_rows_of_a_4d_input(shape, want):
    n = 1000 if shape[-1] == 1000 else 512
    K = QTensor(torch.zeros((n, shape[-1]), dtype=torch.int8),
                torch.ones((n, 1)))
    assert tops.dense_route(shape, K) == want
    assert ref.dense_route(int(np.prod(shape[:-1])), n, shape[-1]) == want


def test_the_zoo_and_the_reference_name_the_same_weights():
    base = {"depths": [3, 3, 27, 3], "widths": [128, 256, 512, 1024],
            "num_classes": 1000}
    assert weight_shapes() == ref.weight_shapes(base)
    assert sum(np.prod(s) for _, s in weight_shapes()) == 88_591_464
    net = convnext(SMALL["depths"], SMALL["widths"], device="cpu")
    assert [(n, tuple(s)) for n, s, _ in net.graph.inits] == \
        ref.weight_shapes({**SMALL, "num_classes": 1000})
    ops = [layer.op for layer in net.graph.layers]
    assert ops.count("layernorm") == ref.layernorms(
        {**SMALL, "num_classes": 1000}) == 10
    assert ops.count("dense") == 11 and ops.count("gelu") == 5
    # the Base builder: 41 LayerNorms, 73 Linears, 40 convs (weights zero)
    zero = {n: np.broadcast_to(np.float32(0), s) for n, s in weight_shapes()}
    ops = [layer.op for layer in convnext_base(device="cpu",
                                               weights=zero).graph.layers]
    assert (ops.count("layernorm"), ops.count("dense"), ops.count("conv"),
            ops.count("gelu")) == (41, 73, 40, 36)


def test_a_weight_of_another_shape_is_refused():
    w = {n: np.zeros(s, np.float32) for n, s in weight_shapes(
        SMALL["depths"], SMALL["widths"])}
    w["s2.1.fc1.w"] = np.zeros((1024, 128), np.float32)
    with pytest.raises(ValueError, match="s2.1.fc1.w"):
        convnext(SMALL["depths"], SMALL["widths"], device="cpu", weights=w)


def test_no_codes_reach_a_grouped_conv_a_layernorm_or_an_add(built):
    """``annotate_output_quant`` hands no conv's output on as int8 codes:
    each is read by a LayerNorm (through a transpose), a depthwise conv or
    a residual add of two bf16 maps."""
    for layer in built["net"].graph.layers:
        assert "out_scale" not in layer.kwargs, layer.name
        assert "qadd" not in layer.kwargs, layer.name


def test_calibration_scales_are_the_programs(built):
    got = built["net"].graph.meta["act_scales"]
    want = built["ref"].act
    assert {k[:-2] for k in got} == set(want)
    for k, v in want.items():
        assert np.float64(got[k + ".w"]) == np.float64(v), k


def test_program_logits_match_the_reference_and_the_control_does_not(built):
    r = built["ref"].forward(built["x"], batch=BATCH)
    gap = compare.max_rel_gap(built["y"], r)
    assert gap <= TOL
    low = cx.control(built["cfg"], built["arrays"], built["calib"], "cpu")
    assert compare.max_rel_gap(low(built["x"]), r) > TOL


def test_with_the_librarys_convs_and_layernorm_the_reference_is_the_program(
        built, monkeypatch):
    """The reference sums the float convs' exact products in float64 (the
    stem) or float32 (the depthwise convs) and rounds each LayerNorm once
    from torch's float32 kernel; with torch's bfloat16 conv and LayerNorm
    kernels in their places, every other step (the routes, the dequants,
    the W8A8 codes, the kernel-branch and fallback GEMMs, GELU's rounded
    constants, the layer scale, the adds, the pool) gives the program's
    logits bit for bit."""
    def library_conv(x, w, stride, pad):
        return F.conv2d(x, w, None, stride, pad)

    def library_dwconv(x, w, pad):
        return F.conv2d(x, w, None, 1, pad, 1, x.shape[1])

    def library_ln(t, s, b):
        return F.layer_norm(t, (t.shape[-1],), s.to(t.dtype), b.to(t.dtype),
                            ref.EPS)
    monkeypatch.setattr(ref.rr, "fconv", library_conv)
    monkeypatch.setattr(ref, "dwconv", library_dwconv)
    monkeypatch.setattr(ref, "_ln", library_ln)
    r = built["ref"].forward(built["x"], batch=BATCH)
    torch.testing.assert_close(torch.as_tensor(built["y"]), r, rtol=0,
                               atol=0)


def _routed(counters):
    return {k: v for k, v in counters.items()
            if k.startswith(("conv.route.", "dense.route.", "layernorm"))}


def test_route_counters_give_the_reference_plan(built):
    want = ref.plan(built["cfg"], SIDE, BATCH)
    assert want == {"conv.route.w8a8": 1, "conv.route.float": 8,
                    "dense.route.kernel": 10, "dense.route.fallback": 1,
                    "layernorm": 10}
    assert _routed(built["counters"]) == want


def test_route_counters_at_the_cells_batch(built):
    """A b1 image whose gates read the batch as 64 (``logical_batch``):
    all three downsampling convs reach 4,096 rows and take W8A8."""
    x = built["x"][:1]
    with tops.logical_batch(64), profiler.record() as rec:
        built["net"].program._run(x)
    want = ref.plan(built["cfg"], SIDE, 64)
    assert want["conv.route.w8a8"] == 3 and want["conv.route.float"] == 6
    assert _routed(rec.counters) == want


def test_the_work_counts_the_published_multiply_adds():
    cfg = config()
    w = cx.work(cfg, 64)
    macs = (w["int8_ops"] + w["bf16_ops"]) / 2 / 64
    assert abs(macs - 15.35e9) < 0.01e9     # torchvision: 15.36 GFLOPS
    ops, nbytes = w["dense_q"]
    assert abs(ops / (w["int8_ops"] + w["bf16_ops"]) - 0.964) < 0.001
    # x, weights, scales, bias and output of the 72 kernel-branch Linears
    assert nbytes == sum(2 * 64 * h * h * (n + kd) + n * kd + 6 * n
                         for name, (r, h) in ref.routes(cfg, 224, 64).items()
                         if r == "kernel"
                         for lname, n, kd in ref.linears(cfg)
                         if lname == name)


class _LayerNorm2d(nn.LayerNorm):
    """torchvision's LayerNorm2d: traced through, ``F.layer_norm``."""

    def forward(self, x):
        x = x.permute(0, 2, 3, 1)
        x = F.layer_norm(x, self.normalized_shape, self.weight, self.bias,
                         self.eps)
        return x.permute(0, 3, 1, 2)


class _Block(nn.Module):
    def __init__(self, c):
        super().__init__()
        self.dwconv = nn.Conv2d(c, c, 7, padding=3, groups=c)
        self.norm = nn.LayerNorm(c, eps=1e-6)
        self.pwconv1 = nn.Linear(c, 4 * c)
        self.act = nn.GELU()
        self.pwconv2 = nn.Linear(4 * c, c)
        self.gamma = nn.Parameter(0.5 + 0.1 * torch.randn(c))

    def forward(self, x):
        # the three spellings of a permute
        y = torch.permute(self.dwconv(x), (0, 2, 3, 1))
        y = self.pwconv2(self.act(self.pwconv1(self.norm(y))))
        return x + (self.gamma * y).permute((0, 3, 1, 2))


class _TinyConvNeXt(nn.Module):
    def __init__(self, c=32):
        super().__init__()
        self.stem = nn.Sequential(nn.Conv2d(3, c, 4, 4),
                                  _LayerNorm2d(c, eps=1e-6))
        self.blocks = nn.Sequential(_Block(c), _Block(c))
        self.head = nn.LayerNorm(c, eps=1e-6, elementwise_affine=False)
        self.fc = nn.Linear(c, 10)

    def forward(self, x):
        y = self.blocks(self.stem(x)).mean((-2, -1))
        return self.fc(self.head(y))


def test_torch2planer_converts_a_convnext_stem_and_blocks():
    torch.manual_seed(0)
    m = _TinyConvNeXt().eval()
    with torch.no_grad():
        for p in m.parameters():
            if p.ndim == 1:
                p.add_(0.05 * torch.randn_like(p))
    g, blob = fx_to_graph(m)
    ops = [layer.op for layer in g.layers]
    assert ops.count("layernorm") == 4 and ops.count("mul") == 2
    # the layer scale is a weight operand of its mul
    inits = set(g.init_names())
    muls = [e for e in g.flow if g.layer_map()[e.layers[0]].op == "mul"]
    assert all(any(s in inits for s in e.src) for e in muls)
    net = Net(g, unpack_weights(g, blob), device="cpu")
    x = torch.randn(2, 3, 32, 32)
    with torch.no_grad():
        want = m(x)
    np.testing.assert_allclose(net(x), want.numpy(), rtol=0, atol=1e-5)
