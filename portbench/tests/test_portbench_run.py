"""A run of the harness at a small size on the CPU: its last line, the
check seeing the control in the program's place and an answer altered
where the program produces it, the launch check, and the reduction of a
trace."""
import json
import subprocess
import sys

import pytest
import torch

from portbench import control, generators, harness, trace
from portbench.configs import resnet

SMALL = {"r18-offline-b64-dev": 64, "r50all-b1-closed": 112}


def small(name, **cfg):
    batch = 2 if "offline" in name else 1
    return {"config": {"image_side": SMALL[name], "kernels": {}, **cfg},
            "traffic": {"batch": batch, "pool": 2, "sample": 2,
                        "warmup_calls": 1, "trace_seconds": 0.3}}


@pytest.mark.parametrize("name", sorted(SMALL))
def test_a_run_prints_the_contract_line(name):
    out = harness.run_cell(name, 2 ** 31 + 11, 0.3, False, device="cpu",
                           overrides=small(name))
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 1
    spec = harness.load_spec()
    want = {m["name"] for m in harness.cell(spec, name).end_to_end}
    assert set(out["metrics"]) == want
    assert all(v["value"] > 0 for v in out["metrics"].values())
    json.dumps(out)


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    build = resnet.build

    def altered(*a, **kw):
        net = build(*a, **kw)

        def call(x):
            y = net(x)
            y[:, 7] += 0.1 * abs(y).max()
            return y
        return call

    monkeypatch.setattr(resnet, "build", altered)
    name = "r18-offline-b64-dev"
    out = harness.run_cell(name, 2 ** 31 + 12, 0.3, False, device="cpu",
                           overrides=small(name))
    assert out["correct"] is False
    assert out["checks"]["max_rel_gap"]["value"] > \
        out["checks"]["max_rel_gap"]["limit"]


@pytest.mark.parametrize("name", sorted(SMALL))
def test_the_control_in_the_programs_place_is_not_correct(name):
    r = control.readings(name, 2 ** 31 + 14, 0.3, device="cpu",
                         overrides=small(name))
    assert r["correct"] == [True, False]
    prog, ctl = r["program"]["max_rel_gap"], r["control"]["max_rel_gap"]
    assert prog["value"] <= prog["limit"] < ctl["value"]
    assert r["control"]["failed_calls"]["value"] == 0


def test_a_missing_kernel_launch_fails_every_call():
    name = "r18-offline-b64-dev"
    ov = small(name, kernels={"stage64": {"names": ["stem_kernel"],
                                          "launches": {"stem_pool_requant": 1}}})
    out = harness.run_cell(name, 2 ** 31 + 13, 0.3, False, device="cpu",
                           overrides=ov)
    assert out["correct"] is False
    assert out["failed"] == out["attempted"] >= 1


def test_trace_reduction_unions_intervals_and_names_the_gaps():
    w = (0, 100)
    dev = [(10, 30, "void (anonymous namespace)::stem_kernel<0>(x)"),
           (20, 40, "void block_kernel<true, false>(y)"),
           (50, 60, "elementwise_kernel"), (95, 120, "reduce_block_kernel")]
    host = [(0, 100, trace.WINDOW), (0, 45, trace.CALL),
            (38, 44, "aten::copy_"), (45, 58, trace.CALL)]
    t = trace.reduce_events(dev, host, w, {"stage64": ["stem_kernel",
                                                       "block_kernel"]})
    assert t.busy_s == pytest.approx(45e-9)
    assert t.window_s == pytest.approx(100e-9)
    assert t.launches == {"stage64": 2}
    assert t.module_s["stage64"] == pytest.approx(40e-9)
    assert t.idle_by_host == pytest.approx(
        {trace.CALL: 10e-9, "aten::copy_": 10e-9, "host: untraced": 35e-9})
    b = t.breakdown()
    assert set(b) == {"device_ops", "idle_gaps"}
    assert b["device_ops"][0][1] == pytest.approx(20e-9)
    assert b["idle_gaps"][0] == ["host: untraced", pytest.approx(35e-9)]


def _run(name, tr=None):
    cfg = harness.cell(harness.load_spec(), name).cfg
    win = generators.Window(10, 640, 0, 0.05, [0.005] * 10, [])
    traced = generators.Window(8, 512, 0, 0.05, [0.00625] * 8, [])
    return harness.Run(cfg, {}, 1.0, win, traced if tr else None, tr,
                       resnet.work(cfg, 64),
                       {"int8_ops": 1979e12, "bf16_flops": 989e12,
                        "hbm_bytes": 3.35e12}, True)


def test_readers_read_nothing_where_there_is_nothing():
    spec = harness.load_spec()
    for name in ("r18-offline-b64-dev", "r50all-offline-b64-dev"):
        c = harness.cell(spec, name)
        for m in c.per_layer:
            assert c.readers[m["name"]](_run(name)) is None
    # 8 traced calls, 4.5 ms busy each; the untraced window 5 ms a call
    t = trace.Trace(0.05, 0.036, {"stem_kernel": 0.0008, "x": 0.032},
                    {"stage64": 8}, {"stage64": 0.0008}, {})
    c = harness.cell(spec, "r18-offline-b64-dev")
    vals = {m["name"]: c.readers[m["name"]](_run(c.name, t))
            for m in c.per_layer}
    least = (resnet.work(c.cfg, 64)["int8_ops"] / 1979e12
             + resnet.work(c.cfg, 64)["bf16_ops"] / 989e12)
    assert vals["step_mfu.offline"] == pytest.approx(100 * least / 0.005)
    assert 0 < vals["stage64_roofline.offline"] < 100
    assert vals["ops_device_ms.offline"] == pytest.approx(4.0)
    assert vals["device_idle.offline"] == pytest.approx(10.0)
    stagen = harness.cell(spec, "r50all-offline-b64-dev").readers[
        "stagen_roofline.offline"]
    assert stagen(_run("r18-offline-b64-dev", t)) is None
    b1 = harness.cell(spec, "r18-b1-closed")
    assert b1.readers["step_device_ms.b1"](_run(b1.name, t)) == \
        pytest.approx(4.5)
    assert b1.readers["device_idle.b1"](_run(b1.name, t)) == \
        pytest.approx(10.0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.load_spec()["workloads"]])
def test_a_cell_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", name,
         "--seed", "2147483999", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.CHECKOUT, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.splitlines()[-1])["correct"] is True


@pytest.mark.cuda
@pytest.mark.parametrize("name", [w["name"] for w in
                                  harness.load_spec()["workloads"]])
def test_the_control_on_the_card_at_the_cells_size(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    harness.use_cache_dirs()
    r = control.readings(name, 2147483998, 1.0)
    assert r["correct"] == [True, False], r
