"""UNet in the port (planer_tpu_torch/models/unet.py, utils/tile.py,
utils/image.py) against the JAX package on the CPU, at full width
(base 8-16, depth 3-4, the convtranspose and the nearest-upsample decoders)
and 64-128 pixel sides.

Tolerances, stated per test:
  * f32, float or weight-only int8 weights: 1e-5 of the largest output
    (XLA's convs sum in another order);
  * bf16: XLA keeps f32 between fused bf16 ops where the port rounds
    (excess precision), and the sigmoid's last division stays f32 there:
    p99 2e-2 and max 5e-2 of the largest output (a few bf16 ulps);
  * tile against the JAX package's tile on the same windows: equal (the
    same numpy blend); the port's tiled net against the JAX package's:
    1e-5, as the nets.
"""

import numpy as np
import pytest

import planer_tpu.models as jm
from planer_tpu import io as jio
from planer_tpu.models import eval as jev
from planer_tpu.quant import calibrate_act_scales as jcalibrate
from planer_tpu.utils import image as jimage
from planer_tpu.utils.tile import tile as jtile

import planer_tpu_torch as pt
import planer_tpu_torch.models as tm
from planer_tpu_torch import io as tio
from planer_tpu_torch.quant import calibrate_act_scales
from planer_tpu_torch.utils import image as timage
from planer_tpu_torch.utils.tile import tile

MODES = ["convtranspose", "nearest"]


def _port(jnet, compute_dtype=None):
    return pt.net_from_arrays(jnet.graph.to_json_dict(), jnet.weights,
                              device="cpu", compute_dtype=compute_dtype)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.abs(a - b).max() / np.abs(a).max())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("size", [dict(), dict(base=8, depth=3, in_ch=3,
                                               out_ch=2)])
def test_builder_makes_the_reference_graph_and_weights(mode, size):
    jn = jm.unet(upsample_mode=mode, **size)
    tn = tm.unet(upsample_mode=mode, device="cpu", **size)
    assert tn.graph.to_json() == jn.graph.to_json()
    assert len(tn.weights) == len(jn.weights)
    for a, b in zip(jn.weights, tn.weights):
        assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("quant", [None, "int8"])
@pytest.mark.parametrize("mode", MODES)
def test_unet_matches_reference(mode, quant, dtype):
    """Float and weight-only int8 weights (the convtranspose weights
    quantized per output channel on axis 1), f32 and bf16 compute."""
    jn = jm.unet(base=16, depth=4, upsample_mode=mode)
    jn.optimize()
    if quant:
        jn.quantize(quant)
        info = jn.graph.quant.get("up0.w")
        if mode == "convtranspose":
            assert info["axis"] == 1
            scale = jn.weights[jn.graph.init_index()[info["scale"]]]
            assert scale.shape == (1, 16, 1, 1)
    cd = None if dtype == "float32" else dtype
    jn.astype_compute(cd)
    x = next(jev.synthetic_images(2, (1, 64, 64), seed=1, batch=2))
    yj, yt = np.asarray(jn(x)), _port(jn, cd)(x)
    assert yt.shape == yj.shape == (2, 1, 64, 64) and yt.dtype == np.float32
    d = np.abs(yt - yj) / np.abs(yj).max()
    if cd is None:
        assert d.max() <= 1e-5
    else:
        assert np.percentile(d, 99) <= 2e-2 and d.max() <= 5e-2


def test_bf16_gap_to_the_executor_is_the_references():
    """Weight-only int8 UNet (base 32, depth 4, the chip's model) in bf16
    sits as far from the float32 executor in the port as in the JAX
    package (within 25% and 0.01): chip_smoke.py bounds path 10's leg 3 by
    the reference's gap."""
    jn = jm.unet(in_ch=1, out_ch=1, base=32, depth=4)
    jn.optimize()
    jn.quantize("int8")
    jn.astype_compute("bfloat16")
    tn = _port(jn, "bfloat16")
    x = next(jev.synthetic_images(4, (1, 128, 128), seed=29, batch=4))
    oracle = tn(x, engine="oracle")

    def gap(y):
        d = np.abs(np.asarray(y) - oracle).reshape(4, -1).max(1)
        return d / np.abs(oracle).reshape(4, -1).max(1)
    gap_t, gap_j = gap(tn(x)), gap(jn(x))
    print(f"bf16 gap to the executor: port {np.round(gap_t, 4)}, JAX "
          f"package {np.round(gap_j, 4)}")
    assert gap_t.max() <= 1.25 * gap_j.max() + 0.01


def test_pipeline_gives_the_reference_graph():
    """optimize, calibration through the float32 executor (scales within
    1e-5: f32 sums in another order), quantize(activations="static") with
    annotate: the same graph and annotations, the convtranspose weights
    quantized on axis 1."""
    jn, tn = (jm.unet(base=8, depth=3),
              tm.unet(base=8, depth=3, device="cpu"))
    for n in (jn, tn):
        n.optimize()
    assert tn.graph.to_json() == jn.graph.to_json()
    batches = lambda: jev.synthetic_images(4, (1, 64, 64), seed=11,  # noqa
                                           batch=2)
    sj, st = jcalibrate(jn, batches()), calibrate_act_scales(tn, batches())
    assert sorted(sj) == sorted(st)
    for k in sj:
        np.testing.assert_allclose(st[k], sj[k], rtol=1e-5, err_msg=k)
    for n in (jn, tn):
        n.graph.meta["act_scales"] = dict(sj)
        n.quantize("int8", activations="static")
    assert tn.graph.to_json() == jn.graph.to_json()
    assert tn.graph.quant["up0.w"]["axis"] == 1


def test_pla_written_by_jax_loads(tmp_path):
    jn = jm.unet(base=8, depth=3)
    jn.quantize("int8")
    p = jio.save_pla(str(tmp_path / "unet.pla"), jn.graph, jn.weights)
    loaded = tio.read_net(p, device="cpu")
    x = next(jev.synthetic_images(1, (1, 64, 64), seed=2, batch=1))
    np.testing.assert_array_equal(loaded(x), _port(jn)(x))
    assert _rel(np.asarray(jn(x)), loaded(x)) <= 1e-5


def test_image_resize_is_the_reference():
    rng = np.random.default_rng(3)
    img = rng.standard_normal((37, 23, 2)).astype(np.float32)
    for size in ((64, 48), (20, 11), (37, 23)):
        np.testing.assert_array_equal(timage.resize(img, size),
                                      jimage.resize(img, size))


@pytest.mark.parametrize("opts", [
    dict(window=64, margin=16, glob=16),
    dict(window=48, margin=0.25, glob=16),
    dict(window=256, margin=8, glob=16),          # one window, collapsed
    dict(window=64, margin=16, glob=16, sample=0.75)])
def test_tile_matches_reference(opts):
    """The port's tile against the JAX package's on the same function and
    image: equal; the port's UNet tiled against the JAX UNet tiled: within
    1e-5.  (Tiled against whole runs at 512 on the card, chip_smoke.py path
    10: windows this small cut the depth-4 receptive field everywhere.)"""
    jn = jm.unet(base=8, depth=4)
    tn = _port(jn)
    rng = np.random.default_rng(4)
    img = rng.standard_normal((128, 112)).astype(np.float32)

    def run(net):
        def f(win2d):
            out = np.asarray(net(win2d[None, None].astype(np.float32)))[0]
            return out.transpose(1, 2, 0)
        return f

    tiled = tile(**opts)(run(tn))(img)
    np.testing.assert_array_equal(tiled, jtile(**opts)(run(tn))(img))
    assert _rel(jtile(**opts)(run(jn))(img), tiled) <= 1e-5
    assert tiled.shape == (128, 112, 1)
