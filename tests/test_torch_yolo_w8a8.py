"""Static W8A8 YOLO-v3 against the benchmark's plain reference
(``portbench/configs/yolo_ref.py``) on the CPU, at the configuration's
widths and a 128 px side, batch 4: the family's graph is the zoo's, the
reference's float model is a plain float32 Darknet-53 + FPN forward, the
program's three heads sit within the cell's limit of the reference and the
4-bit control does not (with the library's bf16 conv in the reference,
they are equal), and the program's ``conv.route.*`` counters give
the reference's route plan (YOLO-v3 and, outside its fused stage,
ResNet-18), its ``w8a8.cast_fused`` counter the passes of that plan
whose dtype conversion rides inside the arithmetic, and the separate
casts those passes replaced (``separate_casts``) the same answers."""
import collections
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import separate_casts as sc
from planer_tpu_torch.models import yolov3
from planer_tpu_torch.ops import torch_ops as tops
from planer_tpu_torch.runtime import profiler
from portbench import compare, harness, inputs
from portbench.configs import resnet, resnet_ref, yolo, yolo_ref

SIDE, BATCH, SEED = 128, 4, 2 ** 31 + 21


def config(name, **kw):
    c = next(c for c in harness.load_spec()["configs"] if c["name"] == name)
    with open(harness.CHECKOUT / c["file"]) as f:
        return {**json.load(f), **kw}


def routed(counters):
    return {k[len("conv.route."):]: v for k, v in counters.items()
            if k.startswith("conv.route.")}


def plan(routes, skip=()):
    return dict(collections.Counter(r for r, _ in routes.values()
                                    if r not in skip))


@pytest.fixture(scope="module")
def built():
    cfg = config("yolov3-int8-416", image_side=SIDE)
    a = yolo.arrays(cfg, SEED, "cpu")
    cal = yolo.calibration(cfg, SEED, "cpu")
    net = yolo.build(cfg, a, cal, "cpu")
    x = inputs.images(BATCH, SIDE, inputs.generator(SEED, "test", "cpu"))
    with profiler.record() as rec:
        heads = net.forward(x)
    return {"cfg": cfg, "arrays": a, "calib": cal, "x": x, "heads": heads,
            "net": net,
            "counters": dict(rec.counters),
            "ref": yolo.reference(cfg, a, cal, "cpu")}


def test_the_familys_graph_is_the_zoos():
    cfg = config("yolov3-int8-416")
    assert yolo.graph_json(cfg) == \
        yolov3(decode=False, device="cpu").graph.to_json_dict()


def plain_float(a, x, cfg):
    """Conv, BatchNorm as its affine, LeakyReLU(0.1), written out from the
    published layout: the unfolded float32 network's three heads."""
    def cbl(t, n, stride=1, head=False):
        w = torch.as_tensor(a[f"{n}.w"])
        y = F.conv2d(t, w, None, stride, w.shape[-1] // 2)
        if head:
            return y + torch.as_tensor(a[f"{n}.b"]).reshape(1, -1, 1, 1)
        y = y * torch.as_tensor(a[f"{n}.bn.k"]) \
            + torch.as_tensor(a[f"{n}.bn.b"])
        return F.leaky_relu(y, 0.1)

    y, feats = cbl(x, "d0"), []
    for i, blocks in enumerate([1, 2, 8, 8, 4]):
        y = cbl(y, f"d{i + 1}", 2)
        for j in range(blocks):
            y = y + cbl(cbl(y, f"r{i + 1}.{j}.1"), f"r{i + 1}.{j}.2")
        feats.append(y)
    heads = []
    for s in (5, 4, 3):
        if s < 5:
            up = F.interpolate(cbl(y, f"route{s}"), scale_factor=2,
                               mode="nearest")
            y = torch.cat([up, feats[s - 1]], 1)
        for i in range(5):
            y = cbl(y, f"h{s}.{i}")
        heads.append(cbl(cbl(y, f"det{2 ** s}.conv"), f"det{2 ** s}.out",
                         head=True))
    return heads


def test_reference_float_model_is_the_plain_forward(built):
    x = torch.cat(built["calib"])
    want = plain_float(built["arrays"], x, built["cfg"])
    got = built["ref"].float_forward(x)
    assert [tuple(t.shape) for t in got] == \
        [(4, 255, SIDE // s, SIDE // s) for s in (32, 16, 8)]
    for g, w in zip(got, want, strict=True):
        assert float((g - w).abs().max() / w.abs().max()) < 1e-4


def test_calibration_scales_are_the_programs(built):
    net = yolo.build(built["cfg"], built["arrays"], built["calib"], "cpu")
    got = net.graph.meta["act_scales"]
    assert {k[:-2] for k in got} == set(built["ref"].act)
    for k, v in built["ref"].act.items():
        assert np.float64(got[k + ".w"]) == np.float64(v)


def test_program_heads_match_the_reference_within_the_limit(built):
    r = built["ref"].forward(built["x"], batch=BATCH)
    limit = built["cfg"]["limit"]["max_rel_gap"]
    gaps = [compare.max_rel_gap(g, w)
            for g, w in zip(built["heads"], r, strict=True)]
    assert max(gaps) <= limit
    low = yolo.control(built["cfg"], built["arrays"], built["calib"], "cpu")
    ctl = [compare.max_rel_gap(g, w)
           for g, w in zip(low.forward(built["x"]), r, strict=True)]
    assert min(ctl) > limit


def test_with_the_librarys_bf16_conv_the_reference_is_the_program(
        built, monkeypatch):
    """The program's gap to the reference comes from its bfloat16 convs
    alone: their sums rounded once by the library where the reference
    rounds exact ones, one ulp apart now and then, and grown through 75
    convs.  With the library's conv in place of the float64 one, every
    code, add, LeakyReLU, upsample and concat of the reference gives the
    program's three heads bit for bit."""
    def library_conv(x, w, stride, pad):
        return F.conv2d(x.to(torch.bfloat16), w.to(torch.bfloat16), None,
                        stride, pad)
    monkeypatch.setattr(resnet_ref, "fconv", library_conv)
    r = built["ref"].forward(built["x"], batch=BATCH)
    for g, w in zip(built["heads"], r, strict=True):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_route_counters_give_the_reference_plan_for_yolo(built):
    want = plan(yolo_ref.routes(built["cfg"], SIDE, BATCH))
    # codes cross the residual adds: r2.1.1, d3 and the later blocks' 1x1
    # convs take them; r2.0.1 is the one W8A8 conv at 4,096 rows
    assert want == {"float": 54, "s8": 20, "w8a8": 1}
    assert routed(built["counters"]) == want


def test_route_counters_give_the_reference_plan_for_resnet18():
    cfg = config("resnet18-int8-224", image_side=64)
    a = resnet.arrays(cfg, SEED, "cpu")
    net = resnet.build(cfg, a, resnet.calibration(cfg, SEED, "cpu"), "cpu")
    x = inputs.images(2, 64, inputs.generator(SEED, "test", "cpu"))
    with profiler.record() as rec:
        net.forward(x)
    want = plan(resnet_ref.routes(cfg, 64, 2), skip=("stage64",))
    assert want == {"float": 2, "s8": 13}
    assert routed(rec.counters) == want
    # a replayed call on the CPU runs the list again and counts the same
    with profiler.record() as rec:
        net.forward(x)
    assert routed(rec.counters) == want


def test_cast_fused_counts_the_plans_passes_for_yolo(built, monkeypatch):
    """At 128 px b4: the one W8A8 conv's two passes, the 20 s8 convs'
    dequants and the 23 residual adds' rescales and sums; a walk with the
    separate casts gives the same heads bit for bit and counts none."""
    routes = plan(yolo_ref.routes(built["cfg"], SIDE, BATCH))
    want = sc.planned_casts(built["net"], routes)
    assert want == 66
    assert built["counters"][sc.COUNTER] == want
    sc.use(monkeypatch)
    with profiler.record() as rec:
        old = built["net"].program._run(built["x"])
    assert sc.COUNTER not in rec.counters
    for g, w in zip(built["heads"], old, strict=True):
        sc.same_bits(g, w)


@pytest.mark.parametrize("batch", [1, 64])
def test_cast_fused_counts_the_plans_passes_for_resnet18(batch, monkeypatch):
    """At 224 px, b1 and the b64 plan (a b1 image whose gates read the
    batch as 64, ``logical_batch``): 13 s8 dequants, 14 requants of convs
    that emit codes, the stem's prologue and the six residual adds' 9
    passes; the separate casts give the same logits bit for bit."""
    cfg = config("resnet18-int8-224")
    a = resnet.arrays(cfg, SEED, "cpu")
    net = resnet.build(cfg, a, resnet.calibration(cfg, SEED, "cpu"), "cpu")
    x = inputs.images(1, 224, inputs.generator(SEED, "test", "cpu"))
    routes = plan(resnet_ref.routes(cfg, 224, batch), skip=("stage64",))
    want = sc.planned_casts(net, routes)
    assert want == 37
    with tops.logical_batch(batch), profiler.record() as rec:
        y = net.program._run(x)
    assert routed(rec.counters) == routes
    assert rec.counters[sc.COUNTER] == want
    sc.use(monkeypatch)
    with tops.logical_batch(batch):
        sc.same_bits(y, net.program._run(x))
