"""The port's quantization tools against the JAX package's:
``layer_quant_errors`` on tests/test_accuracy.py's corrupted ResNet-18 at
64 px (the same keys, each value within 1e-3 relative of the reference's,
the same top-ranked layer) and ``quantize_auto``'s trial loop (success with
no fallback, the found configuration applied in place and equal to the JAX
package's quantization of the same net, and the loud failure)."""
import numpy as np
import pytest

from planer_tpu import models as jm
from planer_tpu.models import eval as jev
from planer_tpu.quant import layer_quant_errors as j_errors
from planer_tpu.quant import quantize_net as j_quantize

from planer_tpu_torch import models as tm
from planer_tpu_torch.quant import layer_quant_errors, quantize_auto

WNAME = "layer2.0.conv1.w"
# float32 convs in another order (numpy oracle vs torch), divided by
# max|y|: the relative errors agree to far better than this
REL_TOL = 1e-3


def _corrupted(mod, **kw):
    """Two large opposite taps in one output channel: they cancel on smooth
    inputs but crush the channel's absmax scale."""
    net = mod.resnet18(num_classes=16, **kw)
    net.optimize()
    w = net.weights[net.graph.init_index()[WNAME]]
    w[0, 0, 0, 0] = 60.0
    w[0, 0, 0, 2] = -60.0
    net._invalidate()
    return net


@pytest.mark.parametrize("activations", [None, "dynamic"])
def test_layer_quant_errors_match_reference(activations):
    cal = list(jev.synthetic_images(4, (3, 64, 64), seed=7, batch=2))
    ref = j_errors(_corrupted(jm), cal, mode="int8", activations=activations)
    got = layer_quant_errors(_corrupted(tm, device="cpu"), cal, mode="int8",
                             activations=activations)
    assert set(got) == set(ref) and len(got) >= 15
    for k in ref:
        assert abs(got[k] - ref[k]) <= REL_TOL * max(ref[k], 1e-6), \
            (k, got[k], ref[k])
    assert max(got, key=got.get) == max(ref, key=ref.get)
    if activations is None:        # the weight corruption ranks first
        assert max(got, key=got.get) == WNAME


def test_quantize_auto_success_applies_the_reference_quantization():
    net = tm.resnet18(num_classes=16, device="cpu")
    net.optimize()
    rep = quantize_auto(net, mode="int8", budget_top1=0.99, budget_rel=0.05,
                        eval_n=64, eval_shape=(3, 64, 64), min_margin=0.05,
                        max_fallbacks=2)
    assert rep["top1"] >= 0.99 and rep["skip"] == []
    assert rep["delta"]["max_rel"] <= 0.05 and WNAME in rep["layer_errors"]
    ref = jm.resnet18(num_classes=16)
    ref.optimize()
    j_quantize(ref, mode="int8")
    assert net.graph.to_json() == ref.graph.to_json()
    for a, b in zip(net.weights, ref.weights):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_quantize_auto_fails_loudly():
    """An unachievable budget: the loop falls back layer by layer in error
    order, then raises; the caller's net stays unquantized."""
    net = tm.resnet18(num_classes=16, device="cpu")
    net.optimize()
    with pytest.raises(RuntimeError, match="could not meet budget.*fallbacks"):
        quantize_auto(net, mode="int8", budget_top1=0.99, budget_rel=1e-4,
                      eval_n=32, eval_shape=(3, 64, 64), min_margin=0.05,
                      max_fallbacks=2)
    assert not net.graph.quant
