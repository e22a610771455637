"""The port's serving engine and HTTP front end, case by case against
tests/test_serving.py: batching, buckets, stats, retries, closing, the
spatial signature and the fused-stage fall-off, on ``device="cpu"`` nets
(the kernels' plain versions).  Served answers are held to the port's own
net (1e-4, the JAX test's tolerance; the batch rows are computed apart) and
to the JAX package's net with the same weights (1e-4: float32 convs in
another order)."""
import io
import json
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from planer_tpu import models as jm

from planer_tpu_torch import models
from planer_tpu_torch.models import eval as ev
from planer_tpu_torch.ops.kernels import stage64 as st
from planer_tpu_torch.ops.kernels import stagen as sg
from planer_tpu_torch.parallel.multihost import health_check
from planer_tpu_torch.quant import calibrate_act_scales
from planer_tpu_torch.runtime.http_server import PlanerHTTPServer
from planer_tpu_torch.runtime.serving import ServingEngine

TOL = dict(rtol=1e-4, atol=1e-4)


@pytest.fixture(scope="module")
def net():
    return models.resnet18(num_classes=8, device="cpu")


@pytest.fixture(scope="module")
def jnet():
    return jm.resnet18(num_classes=8)


def test_single_request(net, jnet, rng):
    x = rng.standard_normal((3, 32, 32)).astype(np.float32)
    with ServingEngine(net, buckets=(1, 2, 4), max_delay_ms=1) as eng:
        out = eng.infer(x)
    np.testing.assert_allclose(out, net(x[None])[0], **TOL)
    np.testing.assert_allclose(out, np.asarray(jnet(x[None]))[0], **TOL)


def test_concurrent_requests_batched(net, jnet, rng):
    xs = [rng.standard_normal((3, 32, 32)).astype(np.float32)
          for _ in range(16)]
    with ServingEngine(net, buckets=(1, 2, 4, 8), max_delay_ms=30) as eng:
        futs = [eng.submit(x) for x in xs]
        outs = [f.result(timeout=60) for f in futs]
        st_ = eng.stats()
    ref = net(np.stack(xs))
    jref = np.asarray(jnet(np.stack(xs)))
    for i, o in enumerate(outs):
        np.testing.assert_allclose(o, ref[i], rtol=1e-3, atol=1e-3)
        np.testing.assert_allclose(o, jref[i], rtol=1e-3, atol=1e-3)
    assert st_["requests"] == 16
    assert st_["batches"] < 16
    assert 0 < st_["avg_occupancy"] <= 1


def test_padding_to_bucket(net, rng):
    """3 concurrent requests -> bucket 4 with 1 padding row."""
    xs = [rng.standard_normal((3, 32, 32)).astype(np.float32)
          for _ in range(3)]
    with ServingEngine(net, buckets=(4,), max_delay_ms=50) as eng:
        futs = [eng.submit(x) for x in xs]
        [f.result(timeout=60) for f in futs]
        st_ = eng.stats()
    assert st_["batches"] >= 1
    assert st_["pad_fraction"] > 0


def test_error_propagation():
    class Broken:
        def __call__(self, x):
            raise RuntimeError("boom")

    with ServingEngine(Broken(), buckets=(1,), max_delay_ms=1) as eng:
        fut = eng.submit(np.zeros((3, 8, 8), np.float32))
        with pytest.raises(RuntimeError, match="boom"):
            fut.result(timeout=10)
        assert eng._thread.is_alive()      # the batch failed, not the thread


def test_throughput_stats(net, rng):
    with ServingEngine(net, buckets=(1, 2, 4), max_delay_ms=10) as eng:
        for _ in range(5):
            eng.infer(rng.standard_normal((3, 32, 32)).astype(np.float32))
        st_ = eng.stats()
    assert st_["requests"] == 5
    assert st_["p50_ms"] > 0 and st_["p99_ms"] >= st_["p50_ms"]
    # one latency sample per answered request, not per batch
    assert len(eng.stats_data.latencies_ms) == 5


def test_retry_then_fail():
    calls = [0]

    class Flaky:
        def __call__(self, x):
            calls[0] += 1
            if calls[0] <= 2:
                raise RuntimeError("transient")
            return np.zeros((x.shape[0], 4), np.float32)

    with ServingEngine(Flaky(), buckets=(1,), max_delay_ms=1) as eng:
        out = eng.infer(np.zeros((3, 8, 8), np.float32), retries=3)
    assert out.shape == (4,)
    assert calls[0] == 3
    calls[0] = 0
    with ServingEngine(Flaky(), buckets=(1,), max_delay_ms=1) as eng:
        with pytest.raises(RuntimeError, match="transient"):
            eng.infer(np.zeros((3, 8, 8), np.float32), retries=1)


def test_health_check(monkeypatch):
    """Without a card the probe reports the CPU by name; a device whose
    probe fails, or does not answer by the deadline, is reported
    unhealthy instead of blocking."""
    h = health_check(deadline_s=30)
    assert h["healthy"]
    assert all(v["ok"] for v in h["devices"].values())
    if not torch.cuda.is_available():
        assert list(h["devices"]) == ["cpu"]
    names = list(h["devices"])

    def broken(*a, **kw):
        raise RuntimeError("device lost")
    monkeypatch.setattr(torch, "ones", broken)
    bad = health_check(deadline_s=5)
    assert not bad["healthy"] and list(bad["devices"]) == names
    assert all("device lost" in v["error"] for v in bad["devices"].values())
    monkeypatch.setattr(torch, "ones", lambda *a, **kw: time.sleep(3))
    t0 = time.monotonic()
    late = health_check(deadline_s=0.5)
    assert time.monotonic() - t0 < 2.5
    assert all(v == {"ok": False, "error": "probe timed out"}
               for v in late["devices"].values())


def test_mixed_shapes_dont_kill_dispatcher(net, rng):
    """Different request shapes batch separately; dispatcher survives."""
    with ServingEngine(net, buckets=(1, 2, 4), max_delay_ms=30) as eng:
        f1 = eng.submit(rng.standard_normal((3, 32, 32)).astype(np.float32))
        f2 = eng.submit(rng.standard_normal((3, 64, 64)).astype(np.float32))
        o1 = f1.result(timeout=60)
        o2 = f2.result(timeout=60)
        assert o1.shape == (8,) and o2.shape == (8,)
        assert eng._thread.is_alive()


def test_close_fails_pending_futures():
    class Slow:
        def __call__(self, x):
            time.sleep(0.5)
            return np.zeros((x.shape[0], 2), np.float32)

    eng = ServingEngine(Slow(), buckets=(1,), max_delay_ms=1)
    futs = [eng.submit(np.zeros((3, 4, 4), np.float32)) for _ in range(8)]
    eng.close()
    results, errors = 0, 0
    for f in futs:
        try:
            f.result(timeout=10)
            results += 1
        except RuntimeError as e:
            assert "closed" in str(e)
            errors += 1
    assert results + errors == 8 and errors >= 1


def test_http_server_roundtrip(net, jnet, rng):
    with ServingEngine(net, buckets=(1, 2, 4), max_delay_ms=5) as eng:
        with PlanerHTTPServer(eng, port=0) as srv:
            url = f"http://127.0.0.1:{srv.port}"
            x = rng.standard_normal((3, 32, 32)).astype(np.float32)
            buf = io.BytesIO()
            np.save(buf, x)
            req = urllib.request.Request(f"{url}/predict",
                                         data=buf.getvalue(), method="POST")
            resp = urllib.request.urlopen(req)
            assert resp.status == 200
            out = np.load(io.BytesIO(resp.read()))
            np.testing.assert_allclose(out, net(x[None])[0], **TOL)
            np.testing.assert_allclose(out, np.asarray(jnet(x[None]))[0],
                                       **TOL)
            st_ = json.loads(urllib.request.urlopen(f"{url}/stats").read())
            assert st_["requests"] == 1
            h = json.loads(urllib.request.urlopen(f"{url}/health").read())
            assert h["healthy"]
            for path, data, code in (("/predict", b"garbage", 400),
                                     ("/nope", b"", 404)):
                req = urllib.request.Request(f"{url}{path}", data=data,
                                             method="POST")
                with pytest.raises(urllib.error.HTTPError) as e:
                    urllib.request.urlopen(req)
                assert e.value.code == code
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(f"{url}/nope")
            assert e.value.code == 404
            # a request the net cannot take: the future fails -> 500
            buf = io.BytesIO()
            np.save(buf, np.zeros((5, 32, 32), np.float32))
            req = urllib.request.Request(f"{url}/predict",
                                         data=buf.getvalue(), method="POST")
            with pytest.raises(urllib.error.HTTPError) as e:
                urllib.request.urlopen(req)
            assert e.value.code == 500


def test_hw_buckets_zero_recompiles(rng):
    """Mixed image sizes pad to spatial buckets: the net only ever sees
    bucket shapes, and the counter agrees."""
    seen = []

    class Recorder:
        def __call__(self, x):
            seen.append(x.shape)
            return np.zeros((x.shape[0], 4), np.float32)

    with ServingEngine(Recorder(), buckets=(1, 2, 4), max_delay_ms=1,
                       hw_buckets=(32, 64)) as eng:
        sizes = [(3, 20, 28), (3, 32, 32), (3, 17, 31), (3, 40, 64),
                 (3, 64, 48), (3, 33, 33), (3, 21, 27), (3, 64, 64)]
        futs = [eng.submit(rng.standard_normal(s).astype(np.float32))
                for s in sizes]
        for f in futs:
            assert f.result(timeout=60).shape == (4,)
        st_ = eng.stats()
    allowed_hw = {(32, 32), (64, 64)}
    assert all((s[-2], s[-1]) in allowed_hw for s in seen), seen
    assert st_["recompiles"] == len(set(seen))
    assert st_["recompiles"] <= len(allowed_hw) * 3


def test_hw_bucket_output_cropping(rng):
    """Spatially mapped outputs crop back to the request's own size."""
    class Seg:
        def __call__(self, x):
            return x * 2.0

    with ServingEngine(Seg(), buckets=(1, 2), max_delay_ms=1,
                       hw_buckets=(16,)) as eng:
        x = rng.standard_normal((1, 11, 13)).astype(np.float32)
        out = eng.infer(x)
    assert out.shape == (1, 11, 13)
    np.testing.assert_allclose(out, x * 2.0, rtol=1e-6)


def test_hw_bucket_scaled_output_cropping(rng):
    """Outputs at a spatial scale (stride-2 head) crop by the same scale."""
    class Down2:
        def __call__(self, x):
            return x[..., ::2, ::2]

    with ServingEngine(Down2(), buckets=(1,), max_delay_ms=1,
                       hw_buckets=(32,)) as eng:
        x = rng.standard_normal((1, 20, 24)).astype(np.float32)
        out = eng.infer(x)
    assert out.shape == (1, 10, 12)


def test_hw_bucket_oversize_falls_back_exact(rng):
    """An image larger than every bucket keeps exact-shape semantics."""
    seen = []

    class Recorder:
        def __call__(self, x):
            seen.append(x.shape)
            return np.zeros((x.shape[0], 2), np.float32)

    with ServingEngine(Recorder(), buckets=(1,), max_delay_ms=1,
                       hw_buckets=(16,)) as eng:
        eng.infer(rng.standard_normal((3, 40, 40)).astype(np.float32))
    assert seen == [(1, 3, 40, 40)]


def test_hw_buckets_mixed_sizes_share_batch(net, rng):
    """Two different sizes padding to one bucket ride the same batch, and
    each answer is the net's on the edge-padded image."""
    xs = [rng.standard_normal((3, 28, 30)).astype(np.float32),
          rng.standard_normal((3, 32, 32)).astype(np.float32)]
    with ServingEngine(net, buckets=(1, 2, 4), max_delay_ms=50,
                       hw_buckets=(32,)) as eng:
        futs = [eng.submit(x) for x in xs]
        outs = [f.result(timeout=60) for f in futs]
        st_ = eng.stats()
    assert st_["batches"] == 1
    padded = np.pad(xs[0], [(0, 0), (0, 4), (0, 2)], mode="edge")
    np.testing.assert_allclose(outs[0], net(padded[None])[0], **TOL)
    np.testing.assert_allclose(outs[1], net(xs[1][None])[0], **TOL)


def test_hw_bucket_yolo_decode_outputs_uncropped(rng):
    """yolov3(decode=True) under hw_buckets: its (boxes, 9) output does not
    scale with the image, so the signature marks it non-spatial and it
    keeps the bucket's shape, as in the JAX package."""
    ynet = models.yolov3(num_classes=4, decode=True, device="cpu")
    jref = np.asarray(jm.yolov3(num_classes=4, decode=True)(
        np.zeros((1, 3, 128, 128), np.float32)))
    with ServingEngine(ynet, buckets=(1,), max_delay_ms=1,
                       hw_buckets=(128,)) as eng:
        out = eng.infer(rng.standard_normal((3, 96, 96)).astype(np.float32))
        sig = eng._sig_cache.get((3, 128, 128))
    assert sig == [None]
    assert np.asarray(out).shape == jref.shape[1:]


def test_hw_bucket_net_classifier_positive_signal(net, rng):
    """A classification head (GAP + FC) is positively non-spatial."""
    with ServingEngine(net, buckets=(1,), max_delay_ms=1,
                       hw_buckets=(64,)) as eng:
        out = eng.infer(rng.standard_normal((3, 48, 48)).astype(np.float32))
        sig = eng._sig_cache.get((3, 64, 64))
    assert out.shape == (8,)
    assert sig is not None and sig != "host_tail" and sig[0] is None


def test_hw_bucket_net_segmentation_positive_signal(rng):
    """A spatial head (UNet) crops by the signature's factor, and the crop
    is the JAX net's answer on the padded image, cropped."""
    net = models.unet(in_ch=1, out_ch=2, base=8, depth=2, device="cpu")
    x = rng.standard_normal((1, 44, 52)).astype(np.float32)
    with ServingEngine(net, buckets=(1,), max_delay_ms=1,
                       hw_buckets=(64,)) as eng:
        out = eng.infer(x)
        sig = eng._sig_cache.get((1, 64, 64))
    assert out.shape == (2, 44, 52)
    assert sig and sig[0] == (1.0, 1.0)
    padded = np.pad(x, [(0, 0), (0, 20), (0, 12)], mode="edge")
    jref = np.asarray(jm.unet(in_ch=1, out_ch=2, base=8, depth=2)(
        padded[None]))[0, :, :44, :52]
    np.testing.assert_allclose(out, jref, **TOL)


def test_warmup_derives_the_crop_signature(rng, monkeypatch):
    """With ``warmup``, each spatial bucket's crop signature is derived in
    ``__init__``: the first padded request finds it cached and runs no
    probe, and its answer is still cropped by it."""
    net = models.unet(in_ch=1, out_ch=2, base=8, depth=2, device="cpu")
    with ServingEngine(net, buckets=(1, 2), max_delay_ms=1,
                       hw_buckets=(32, 64), warmup=True,
                       example_shape=(1, 64, 64)) as eng:
        assert eng._sig_cache == {(1, 32, 32): [(1.0, 1.0)],
                                  (1, 64, 64): [(1.0, 1.0)]}
        probes = []
        monkeypatch.setattr(eng, "_spatial_signature", lambda shape: (
            probes.append(shape), eng._sig_cache[shape])[1])
        x = rng.standard_normal((1, 44, 52)).astype(np.float32)
        out = eng.submit(x).result(timeout=60)
    assert probes == [(1, 64, 64)]          # answered from the cache
    padded = np.pad(x, [(0, 0), (0, 20), (0, 12)], mode="edge")
    np.testing.assert_allclose(out, net(padded[None])[0, :, :44, :52],
                               **TOL)


def _static_int8(side):
    """The main path at ``side``: optimize, calibrate on one image,
    static INT8 (the stage64 op), bf16 compute, on the CPU."""
    net = models.resnet18(num_classes=8, device="cpu")
    net.optimize()
    calibrate_act_scales(net, ev.synthetic_images(1, (3, side, side),
                                                  seed=3, batch=1))
    net.quantize("int8", activations="static")
    net.astype_compute("bfloat16")
    return net


def test_serving_hw_bucket_keeps_stage64_fast_path(rng):
    """At the 224 bucket the stage64 op takes its kernel route (on the CPU
    the kernels' plain versions): FALLOFF stays empty, nothing is reported
    as a fall-off, and the spatial probe (the float32 executor) moves no
    counter."""
    net = _static_int8(224)
    st.FALLOFF.clear()
    sg.FALLOFF.clear()
    with ServingEngine(net, buckets=(1,), max_delay_ms=1,
                       hw_buckets=(224,)) as eng:
        x = rng.standard_normal((3, 200, 210)).astype(np.float32)
        out = eng.infer(x)
        stats = eng.stats()
        assert eng._sig_cache[(3, 224, 224)] == [None]
    assert out.shape == (8,) and np.isfinite(out).all()
    assert not st.FALLOFF, dict(st.FALLOFF)
    assert "fused_stage_falloff" not in stats, stats
    padded = np.pad(x, [(0, 0), (0, 24), (0, 14)], mode="edge")
    np.testing.assert_array_equal(out, net(padded[None])[0])


def test_serving_offgrid_bucket_falls_off_visibly(rng):
    """Control: the 220 bucket (R = 55 needs RS = 128, past the halo)
    decomposes and says so in FALLOFF and in stats()."""
    net = _static_int8(220)
    st.FALLOFF.clear()
    with ServingEngine(net, buckets=(1,), max_delay_ms=1,
                       hw_buckets=(220,)) as eng:
        out = eng.infer(rng.standard_normal((3, 220, 220)).astype(np.float32))
        stats = eng.stats()
    assert out.shape == (8,)
    assert st.FALLOFF.get("geometry", 0) >= 1, dict(st.FALLOFF)
    assert stats["fused_stage_falloff"]["geometry"] >= 1
    st.FALLOFF.clear()
