"""The port's user examples (``examples/torch_*``) on the CPU, each held
against the JAX example's own steps through ``planer_tpu``: the same calls,
seeds and constants on the same inputs.

Sizes and tolerances, per example:
  * classify: ResNet-18 at 224, weight-only INT8, bf16 compute; logits
    within max|d|/max|y| <= 0.02 (the bf16 bound of test_torch_resnet18.py),
    the top-5 ids equal at every rank the difference cannot swap
    (``chip_smoke.top5_decided``);
  * detect: YOLO-v3 (80 classes, float32) at 160 (the example's 416 is a
    full-size run); raw heads within 1e-4 of each head's max|y|, the score
    filter's survivors equal, the detections equal in number and within
    1e-3 of the largest coordinate, away from the thresholds
    (``chip_smoke.detections_agree``).  The untrained net's raw heads reach
    1e5, so every box fails ``detect``'s size filter in both packages: the
    detections are empty, and the score filter carries the comparison;
  * segment: UNet (base 16, depth 3) tiled over the example's 700 x 900
    image with its settings; the mask within 1e-4 of max|y|;
  * serve: 32 answers of the float ResNet-18 (100 classes, 64 px), each
    within 1e-4 of its max|y| against the JAX ``net(x)``;
  * zoo: both packages' ``resnet18_tiny.pla`` hold array-equal weights,
    and each loads in the other package.
Then the four scripts run as a user runs them, with ``--device cpu``; without
it, and without a card, every example's ``main`` raises.
"""
import inspect
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import planer_tpu as jpt
import planer_tpu.models as jm
from planer_tpu.models import eval as jev
from planer_tpu.models import yolo_post as jpost

import planer_tpu_torch as pt
import planer_tpu_torch.models as tm
from planer_tpu_torch.models import yolo_post as tpost
from planer_tpu_torch.utils import zoo

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
import chip_smoke  # noqa: E402  (the comparisons path 17 makes on the card)

DETECT_SIZE = 160


def _example(name):
    return chip_smoke.load_example(name)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def test_classify_matches_the_jax_example():
    logits = _example("torch_classify_resnet.py").main(device="cpu")
    net = jm.resnet18()
    net.quantize("int8").astype_compute("bfloat16")
    x = next(jm.eval.synthetic_images(1, (3, 224, 224), seed=7, batch=1))
    want = np.asarray(net(x))[0]
    assert logits.shape == want.shape == (1000,)
    assert np.isfinite(logits).all()
    assert _rel(logits, want) <= 0.02
    decided, bad = chip_smoke.top5_decided(logits, want)
    assert decided and not bad, (decided, bad)


def test_detect_matches_the_jax_example():
    """``detect`` calls its net once: the JAX side's is a function giving
    heads computed before, so the heads compared and its detections come
    from one forward."""
    dets = _example("torch_detect_yolov3.py").main(device="cpu",
                                                   size=DETECT_SIZE)
    img = next(jm.eval.synthetic_images(1, (3, DETECT_SIZE, DETECT_SIZE),
                                        seed=3, batch=1))
    jheads = [np.asarray(h) for h in jm.yolov3()(img)]
    want = jpost.detect(lambda _: jheads, img, conf_thresh=0.3)
    theads = tm.yolov3(device="cpu")(img)
    assert [h.shape for h in theads] == [h.shape for h in jheads] == [
        (1, 255, DETECT_SIZE // s, DETECT_SIZE // s) for s in (32, 16, 8)]
    for a, b in zip(theads, jheads):
        assert _rel(a, b) <= 1e-4
    n, problems = chip_smoke.filtered_agree(
        tpost.decode_heads(theads)[0], jpost.decode_heads(jheads)[0])
    assert n > 100 and not problems, (n, problems)
    _, cands = jpost.detect(lambda _: jheads, img, conf_thresh=0.3,
                            return_candidates=True)
    assert len(dets) == len(want) == 1
    _, _, problems = chip_smoke.detections_agree(dets[0], want[0], cands[0])
    assert not problems, problems


def test_detections_agree_leaves_out_rows_at_a_threshold():
    """The comparison path 17 and the test above make: equal answers pass;
    another count, a moved box or another class fails; a row whose score
    sits at ``conf_thresh``, or whose IoU with a candidate sits at the NMS
    threshold, is left out of both sides."""
    a = np.array([[10, 10, 50, 50, 0.9, 1], [60, 60, 90, 95, 0.5, 2]],
                 np.float32)
    cands = np.concatenate([a, np.zeros((2, 1), np.float32)], 1)
    assert chip_smoke.detections_agree(a, a.copy(), cands) == (2, 0, [])
    assert chip_smoke.detections_agree(a[:1], a, cands)[2]
    moved = a.copy()
    moved[1, 2] += 1.0
    assert chip_smoke.detections_agree(moved, a, cands)[2]
    other = a.copy()
    other[0, 5] = 3
    assert chip_smoke.detections_agree(other, a, cands)[2]
    edge = np.concatenate([a, [[0, 0, 5, 5, 0.30005, 4]]]).astype(np.float32)
    assert chip_smoke.detections_agree(edge, a, cands) == (2, 1, [])
    # a box at IoU 0.45 with a same-class candidate: kept on one side only
    # under a higher-scored one; the higher one is compared
    side = np.array([[10, 10, 50, 50, 0.8, 1]], np.float32)
    box = np.array([[10, 10, 50, 28, 0.7, 1]], np.float32)
    c2 = np.concatenate([np.concatenate([side, box]),
                         np.zeros((2, 1), np.float32)], 1)
    got = chip_smoke.detections_agree(np.concatenate([side, box]), side, c2)
    assert got == (1, 1, [])


def test_segment_matches_the_jax_example():
    mask = _example("torch_segment_unet_tiled.py").main(device="cpu")
    net = jm.unet(in_ch=1, out_ch=1, base=16, depth=3)
    big = np.random.default_rng(0).standard_normal((700, 900)).astype(
        np.float32)

    def run_window(img2d):
        return np.asarray(net(img2d[None, None]))[0, 0]

    want = jpt.tile(window=256, margin=24, glob=8)(run_window)(big)
    assert mask.shape == want.shape == (700, 900)
    assert mask.dtype == want.dtype and np.isfinite(mask).all()
    assert _rel(mask, want) <= 1e-4


def test_serve_matches_the_jax_net():
    rng = np.random.default_rng(12)
    imgs = [rng.standard_normal((3, 64, 64)).astype(np.float32)
            for _ in range(32)]
    answers, stats = _example("torch_serve_continuous.py").main(
        device="cpu", imgs=imgs)
    net = jm.resnet18(num_classes=100)
    assert len(answers) == 32
    for got, img in zip(answers, imgs):
        want = np.asarray(net(img[None]))[0]
        assert got.shape == want.shape == (100,)
        assert _rel(got, want) <= 1e-4
    assert stats["requests"] == 32 and stats["batches"] >= 4
    rows = stats["requests"] / (1 - stats["pad_fraction"])
    assert 32 <= round(rows) <= 8 * stats["batches"]


def test_zoo_packages_write_the_same_model(tmp_path, monkeypatch):
    """Each package's zoo example writes ``resnet18_tiny.pla`` into its
    cache dir (``tmp_path``, never ``$HOME``); the two files hold
    array-equal weights and each loads in the other package."""
    from planer_tpu.utils import zoo as jzoo
    monkeypatch.setattr(zoo, "root", str(tmp_path / "torch"))
    monkeypatch.setattr(jzoo, "root", str(tmp_path / "jax"))
    monkeypatch.syspath_prepend(os.path.join(ROOT, "examples"))
    try:
        tnet = _example("torch_planer_zoo_example").main(device="cpu")
        tpkg = sys.modules["torch_planer_zoo_example"]
        tpla = tmp_path / "torch" / "torch_planer_zoo_example" / \
            "resnet18_tiny.pla"
        assert tpla.exists() and tpkg.root == str(tpla.parent)
        import planer_zoo_example as jpkg
        jpkg.root = str(tmp_path / "jax" / "planer_zoo_example")
        jpla = jpkg._ensure_local() + ".pla"
        jnet = jzoo.Model(jpkg, auto=True)._net
    finally:
        sys.modules.pop("torch_planer_zoo_example", None)
        sys.modules.pop("planer_zoo_example", None)
    ref = tm.resnet18(num_classes=10, device="cpu").weights
    cross_t = pt.read_net(jpla[:-4], device="cpu")
    cross_j = jpt.read_net(str(tpla)[:-4])
    for ws in (tnet.weights, jnet.weights, cross_t.weights, cross_j.weights):
        assert len(ws) == len(ref)
        assert all(np.array_equal(np.asarray(a), b) for a, b in zip(ws, ref))
    x = np.random.default_rng(1).standard_normal((1, 3, 32, 32)).astype(
        np.float32)
    y = tpkg.predict(x)
    assert y.shape == (1, 10)
    np.testing.assert_array_equal(y, cross_t(x))
    assert _rel(y, np.asarray(cross_j(x))) <= 1e-5


# each script with --device cpu, and a line its output must hold
SCRIPTS = {
    "torch_classify_resnet.py": ([], "top-5 class ids: ["),
    "torch_detect_yolov3.py": (["--size", "128"], "0 detections: [x1 y1 x2 "
                                                  "y2 score class]"),
    "torch_segment_unet_tiled.py": ([], "input  (700, 900) -> mask (700, "
                                        "900) range ["),
    "torch_serve_continuous.py": ([], "served 32 requests; stats: {"),
}


def test_scripts_run_as_a_user_runs_them():
    """``python examples/torch_*.py --device cpu``, the four at once: each
    exits 0 and prints the JAX example's lines (``chip_smoke.EXAMPLES``
    holds the ones path 17 looks for on the card)."""
    assert set(SCRIPTS) == set(chip_smoke.EXAMPLES)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = {name: subprocess.Popen(
        [sys.executable, os.path.join("examples", name), "--device", "cpu",
         *args], cwd=ROOT, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for name, (args, _) in SCRIPTS.items()}
    try:
        for name, p in procs.items():
            out, err = p.communicate(timeout=300)
            assert p.returncode == 0, (name, err[-2000:])
            assert SCRIPTS[name][1] in out, (name, out)
            for want in chip_smoke.EXAMPLES[name]:
                assert want in out, (name, want, out)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()


def test_examples_want_the_card(tmp_path, monkeypatch):
    """Without ``device="cpu"`` every example asks for the CUDA card and,
    where there is none, raises as ``device.resolve_device`` does."""
    monkeypatch.setattr(zoo, "root", str(tmp_path))
    try:
        for name in ("torch_classify_resnet.py", "torch_detect_yolov3.py",
                     "torch_segment_unet_tiled.py",
                     "torch_serve_continuous.py", "torch_planer_zoo_example"):
            main = _example(name).main
            assert inspect.signature(main).parameters["device"].default \
                == "cuda"
            if not torch.cuda.is_available():
                with pytest.raises(RuntimeError, match="device='cpu'"):
                    main()
    finally:
        sys.modules.pop("torch_planer_zoo_example", None)
