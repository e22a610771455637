"""The whole slice: INT8 ResNet-18 built, calibrated, quantized and fused by
the JAX package, carried across with ``convert.net_from_arrays``, and run by
the port on the CPU against the JAX program (stage64 in interpret mode) on
the same batch — plus the port's own IR passes, calibration and .pla I/O
held against the JAX package's.

The model runs at 224, the main path's resolution: a quantized net with
random weights amplifies any one-code difference chaotically, and at small
resolutions the global average pool has too few pixels to damp it.
"""
import copy

import numpy as np
import pytest

import jax.numpy as jnp

import torch

from planer_tpu import io as jio
from planer_tpu import models as jm
from planer_tpu.ir import Graph as JGraph
from planer_tpu.models import eval as jev
from planer_tpu.optimize import fuse_stage64 as j_fuse
from planer_tpu.quant import calibrate_act_scales as j_calibrate
from planer_tpu.quant import make_quant_program as j_program

import planer_tpu_torch as pt
from planer_tpu_torch import io as tio
from planer_tpu_torch import models as tm
from planer_tpu_torch.optimize import fuse_stage64 as t_fuse
from planer_tpu_torch.quant import calibrate_act_scales as t_calibrate

SIZE = 224
MARGIN = 0.02          # bench.py's decisive-logit filter


def _calib(size=SIZE):
    return list(jev.synthetic_images(1, (3, size, size), seed=3, batch=1))


@pytest.fixture(scope="module")
def ref():
    """The JAX package's main path at SIZE, with snapshots of each step."""
    net = jm.resnet18()
    net.optimize()
    optimized = (copy.deepcopy(net.graph), [w.copy() for w in net.weights])
    scales = j_calibrate(net, _calib())
    net.quantize("int8", activations="static")
    return {"net": net, "optimized": optimized, "scales": dict(scales)}


def _jax_run(graph, weights, xs, cdt):
    prog = j_program(graph, weights, compute_dtype=cdt)
    prog.op_overrides = {"stage64": {"interpret": True}}
    return prog(xs)


def _same_ir(tnet, jgraph, jweights):
    assert tnet.graph.to_json() == jgraph.to_json()
    assert len(tnet.weights) == len(jweights)
    for a, b in zip(tnet.weights, jweights):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == np.asarray(b).tobytes()


def test_ir_passes_identical(ref):
    """fold_bn_into_conv (+ pool hints), then quantize_net, fuse_stage64 and
    annotate_output_quant: the same IR JSON and byte-identical weights."""
    net = tm.resnet18(device="cpu")
    report = net.optimize()
    assert report["fold_bn_into_conv"] == 20
    _same_ir(net, *ref["optimized"])
    # the same act scales in, so the passes alone are compared
    net.graph.meta["act_scales"] = dict(ref["scales"])
    net.quantize("int8", activations="static")
    jnet = ref["net"]
    _same_ir(net, jnet.graph, jnet.weights)
    assert sum(l.op == "stage64" for l in net.graph.layers) == 1
    assert sum(bool(l.kwargs.get("out_scale")) for l in net.graph.layers) == 14


def test_calibration_matches(ref):
    net = tm.resnet18(device="cpu")
    net.optimize()
    scales = t_calibrate(net, _calib())
    assert sorted(scales) == sorted(ref["scales"])
    for k, v in ref["scales"].items():
        np.testing.assert_allclose(scales[k], v, rtol=1e-5, err_msg=k)


def test_calibration_replays_fused_stage():
    """A graph fused before calibration replays the stage's conv chain."""
    nets = []
    for mod, fuse, cal in ((jm, j_fuse, j_calibrate),
                           (tm, t_fuse, t_calibrate)):
        net = mod.resnet18() if mod is jm else mod.resnet18(device="cpu")
        net.optimize()
        assert fuse(net) == 1
        nets.append(cal(net, _calib(64)))
    js, ts = nets
    assert sorted(js) == sorted(ts) and len(ts) == 20
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-5, err_msg=k)


def _fma_bound(ref):
    """What contracting acc*f + b + r*sx into FMAs can move a bf16 result:
    one bf16 ulp of the result, plus float32 rounding of the terms, which
    are at most the plane's magnitude (cancellation leaves tiny results)."""
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(ref), 1e-30))) - 7)
    return ulp + 2.0 ** -20 * np.abs(ref).max()


def _with_taps(graph_json):
    """The graph with the stage64 output and every annotated conv's and
    qadd's output appended to the returned tensors, so both programs expose
    their intermediate planes."""
    d = copy.deepcopy(graph_json)
    kinds = {l[0]: l for l in d["layers"]}
    taps = []
    for src, lay, dst in d["flow"]:
        kw = kinds[lay[0]][2]
        if (kinds[lay[0]][1] == "stage64" or kw.get("out_scale")
                or (kw.get("qadd") or [None] * 3)[2]):
            taps.append((lay[0], dst if isinstance(dst, str) else dst[0]))
    ret = d["flow"][-1]
    ret[0] = ([ret[0]] if isinstance(ret[0], str) else ret[0]) \
        + [t for _, t in taps]
    return d, [n for n, _ in taps]


def test_f32_matches_reference(ref):
    jnet = ref["net"]
    d, names = _with_taps(jnet.graph.to_json_dict())
    xs = next(jev.synthetic_images(4, (3, SIZE, SIZE), seed=21, batch=4))
    outs_j = _jax_run(JGraph.from_json_dict(d), jnet.weights, xs, None)
    tnet = pt.net_from_arrays(d, jnet.weights, device="cpu")
    outs_t = tnet(xs)
    (stage_j, stage_t), *codes = zip(outs_j[1:], outs_t[1:])
    # the stage's last plane is bf16 (cast to f32 here): its only allowed
    # difference is the reference's FMA contraction in its f32 epilogue
    stage_j = np.asarray(stage_j)
    assert (np.abs(stage_t - stage_j) <= _fma_bound(stage_j)).all()
    print(f"stage64 plane: {int((stage_t != stage_j).sum())} of "
          f"{stage_j.size} elements differ by FMA contraction")
    flips = []
    for name, (a, b) in zip(names[1:], codes):
        a = np.asarray(a)
        assert a.dtype == b.dtype == np.int8, name
        flips.append(f"{name}={int((a != b).sum())}/{a.size}")
    print("flipped codes per annotated producer:", ", ".join(flips))
    yj, yt = np.asarray(outs_j[0]), outs_t[0]
    assert yt.dtype == np.float32 and yt.shape == yj.shape == (4, 1000)
    rel = np.abs(yt - yj).max() / np.abs(yj).max()
    print(f"f32 logits: max|d|/max|y| = {rel:.3g}")
    assert rel <= 5e-3


def test_bf16_matches_reference(ref):
    jnet = ref["net"]
    xs = next(jev.synthetic_images(8, (3, SIZE, SIZE), seed=22, batch=8))
    yj = np.asarray(_jax_run(jnet.graph, jnet.weights, xs, "bfloat16"))
    tnet = pt.net_from_arrays(jnet.graph.to_json_dict(), jnet.weights,
                              device="cpu", compute_dtype="bfloat16")
    yt = tnet(xs)
    assert yt.dtype == np.float32 and np.isfinite(yt).all()
    rels = np.abs(yt - yj).max(1) / (np.abs(yj).max(1) + 1e-9)
    p99 = float(np.percentile(rels, 99))
    srt = np.sort(yj, axis=1)
    keep = (srt[:, -1] - srt[:, -2]) / (np.abs(yj).max(1) + 1e-9) >= MARGIN
    agree = (yt.argmax(1) == yj.argmax(1))[keep]
    print(f"bf16 logits: p99 rel {p99:.3g}, margin-filtered argmax "
          f"{agree.mean():.3f} over {int(keep.sum())} decisive images")
    assert p99 <= 0.02
    assert keep.sum() >= 1 and agree.all()


def test_pla_both_directions(ref, tmp_path):
    """A .pla written by planer_tpu loads in the port with identical output,
    and a .pla written by the port loads in planer_tpu likewise."""
    jnet = ref["net"]
    xs = next(jev.synthetic_images(2, (3, SIZE, SIZE), seed=23, batch=2))
    p = jio.save_pla(str(tmp_path / "jax_written.pla"), jnet.graph,
                     jnet.weights)
    loaded = tio.read_net(p, device="cpu")
    direct = pt.net_from_arrays(jnet.graph.to_json_dict(), jnet.weights,
                                device="cpu")
    np.testing.assert_array_equal(loaded(xs), direct(xs))
    _same_ir(loaded, jnet.graph, jnet.weights)

    p2 = tio.save_pla(str(tmp_path / "port_written.pla"), direct.graph,
                      direct.weights)
    back = jio.read_net(p2)
    np.testing.assert_array_equal(np.asarray(back.program(xs)),
                                  np.asarray(jnet.program(xs)))
    assert back.graph.to_json() == jnet.graph.to_json()


def test_session_run_and_oracle(ref):
    """InferenceSession-style run() answers like __call__, and the float32
    executor (the port's oracle) stays near the quantized program on the
    calibration distribution; the executor itself is held against the JAX
    package's oracle through test_calibration_matches."""
    jnet = ref["net"]
    xs = next(jev.synthetic_images(2, (3, SIZE, SIZE), seed=24, batch=2))
    tnet = pt.net_from_arrays(jnet.graph.to_json_dict(), jnet.weights,
                              device="cpu")
    (y,) = tnet.run(None, {"x": xs})
    np.testing.assert_array_equal(y, tnet(xs))
    orc = tnet(xs, engine="oracle")
    assert orc.shape == y.shape and np.isfinite(orc).all()
    assert np.abs(y - orc).max() / np.abs(orc).max() < 0.1
