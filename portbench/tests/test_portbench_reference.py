"""The plain reference at small sizes on the CPU: its float model against a
plain float32 forward of the same arrays, the port's program against it
within the configuration's limit, and the control (the reference at 4
bits) beyond that limit."""
import json

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from portbench import compare, harness, inputs
from portbench.configs import resnet, resnet_ref


def config(name, side):
    c = next(c for c in harness.load_spec()["configs"] if c["name"] == name)
    with open(harness.CHECKOUT / c["file"]) as f:
        return {**json.load(f), "image_side": side}


def plain_float(cfg, a, x):
    """Conv, BatchNorm as its affine, ReLU: the unfolded network."""
    def cbn(t, c, relu=True):
        y = F.conv2d(t, torch.as_tensor(a[f"{c.name}.w"]), None, c.stride,
                     c.pad)
        y = y * torch.as_tensor(a[f"{c.name}.bn.k"]) \
            + torch.as_tensor(a[f"{c.name}.bn.b"])
        return torch.relu(y) if relu else y

    y = F.max_pool2d(cbn(x, resnet_ref.STEM), 3, 2, 1)
    for b in resnet_ref.blocks_of(cfg):
        t = y
        for i, c in enumerate(b.convs):
            t = cbn(t, c, i < len(b.convs) - 1)
        y = torch.relu(t + (cbn(y, b.down, False) if b.down else y))
    return y.mean((2, 3)) @ torch.as_tensor(a["fc.w"]).t() \
        + torch.as_tensor(a["fc.b"])


CASES = [("resnet18-int8-224", 64, 2), ("resnet50-int8-fuseall-224", 112, 1),
         ("resnet50-int8-fuseall-224", 112, 2)]


@pytest.fixture(scope="module")
def built():
    out = {}
    for name, side, _ in CASES:
        if (name, side) in out:
            continue
        cfg = config(name, side)
        a = resnet.arrays(cfg, 2 ** 31 + 5, "cpu")
        cal = resnet.calibration(cfg, 2 ** 31 + 5, "cpu")
        out[name, side] = (cfg, a, cal, resnet.reference(cfg, a, cal, "cpu"))
    return out


@pytest.mark.parametrize("name, side", sorted({c[:2] for c in CASES}))
def test_reference_float_model_is_the_plain_forward(built, name, side):
    cfg, a, cal, ref = built[name, side]
    x = torch.cat(cal)
    want = plain_float(cfg, a, x)
    got = ref.float_forward(x)
    assert float((got - want).abs().max() / want.abs().max()) < 1e-5


@pytest.mark.parametrize("name, side, batch", CASES)
def test_program_matches_reference_and_control_does_not(built, name, side,
                                                        batch):
    cfg, a, cal, ref = built[name, side]
    net = resnet.build(cfg, a, cal, "cpu")
    x = inputs.images(batch, side, inputs.generator(3, "test", "cpu"))
    r = ref.forward(x)
    limit = cfg["limit"]["max_rel_gap"]
    prog = compare.max_rel_gap(net(x), r)
    assert prog <= limit
    low = resnet.reference(cfg, a, cal, "cpu", bits=4)
    ctl = compare.max_rel_gap(low.forward(x), r)
    assert ctl > limit and ctl > 3 * prog


def test_calibration_scales_are_the_programs(built):
    cfg, a, cal, ref = built["resnet18-int8-224", 64]
    net = resnet.build(cfg, a, cal, "cpu")
    got = net.graph.meta["act_scales"]
    assert {k[:-2] for k in got} == set(ref.act)
    for k, v in ref.act.items():
        assert np.float64(got[k + ".w"]) == np.float64(v)
