"""The YOLO cell through the harness at a small size on the CPU: its last
line, the control in the program's place and an answer altered where the
program produces it both not correct."""
import json
import subprocess
import sys

import pytest

from portbench import control, harness
from portbench.configs import yolo

NAME = "yolov3-w8a8-416-b16"
SMALL = {"config": {"image_side": 128},
         "traffic": {"batch": 4, "pool": 2, "sample": 2, "warmup_calls": 1,
                     "trace_seconds": 0.3}}


def test_a_run_prints_the_contract_line():
    out = harness.run_cell(NAME, 2 ** 31 + 31, 0.3, False, device="cpu",
                           overrides=SMALL)
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics",
                             "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True and out["failed"] == 0
    want = {m["name"] for m in harness.cell(harness.load_spec(),
                                            NAME).end_to_end}
    assert set(out["metrics"]) == want == {"img_per_s", "setup_s"}
    json.dumps(out)


def test_the_control_in_the_programs_place_is_not_correct():
    r = control.readings(NAME, 2 ** 31 + 32, 0.3, device="cpu",
                         overrides=SMALL)
    assert r["correct"] == [True, False]
    prog, ctl = r["program"]["max_rel_gap"], r["control"]["max_rel_gap"]
    assert prog["value"] <= prog["limit"] < ctl["value"]


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    build = yolo.build

    class Altered:
        def __init__(self, net):
            self.net = net

        def forward(self, x):
            a, b, c = self.net.forward(x)
            b = b.clone()
            b[:, 7] += 0.5 * b.abs().max()
            return a, b, c

    monkeypatch.setattr(yolo, "build", lambda *a, **kw: Altered(build(*a,
                                                                     **kw)))
    out = harness.run_cell(NAME, 2 ** 31 + 33, 0.3, False, device="cpu",
                           overrides=SMALL)
    assert out["correct"] is False
    gap = out["checks"]["max_rel_gap"]
    assert gap["value"] > gap["limit"]


@pytest.mark.parametrize("batch, want", [(16, (36, 20, 19)),
                                         (64, (48, 20, 7))])
def test_the_work_follows_the_route_plan(batch, want):
    cfg = harness.cell(harness.load_spec(), NAME).cfg
    w = yolo.work(cfg, batch)
    macs = (w["int8_ops"] + w["bf16_ops"]) / 2 / batch
    assert abs(macs - 32.93e9) < 0.01e9     # YOLOv3-416: 65.86 BFLOPs
    routes = [r for r, _ in yolo.ref.routes(cfg, 416, batch).values()]
    assert tuple(routes.count(r) for r in ("w8a8", "s8", "float")) == want
    assert w["s8_gemm"][0] == w["int8_ops"]


def _run(tr):
    from portbench import generators
    cfg = harness.cell(harness.load_spec(), NAME).cfg
    win = generators.Window(10, 160, 0, 0.2, [0.02] * 10, [])
    traced = generators.Window(8, 128, 0, 0.2, [0.025] * 8, [])
    return harness.Run(cfg, {}, 1.0, win, traced if tr else None, tr,
                       yolo.work(cfg, 16),
                       {"int8_ops": 1979e12, "bf16_flops": 989e12,
                        "hbm_bytes": 3.35e12}, True)


def test_the_new_readers_read_the_kernels_they_name():
    from portbench import trace
    c = harness.cell(harness.load_spec(), NAME)
    assert {m["name"] for m in c.per_layer} == {
        "step_mfu.offline", "ops_device_ms.offline", "device_idle.offline",
        "s8_gemm_roofline.offline", "float_conv_device_ms.offline"}
    for m in c.per_layer:
        assert c.readers[m["name"]](_run(None)) is None
    # 8 traced calls: names as an H100 trace of the cell gives them
    ops = {"void cutlass::Kernel2<cutlass_80_tensorop_i16832gemm_s8_128x64_"
           "128x3_tn_align16>(x)": 0.012,
           "sm90_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc"
           "_tilesize256x128x64": 0.004,
           "void cudnn::engines_precompiled::nchwToNhwcKernel<__nv_bfloat16>"
           "(y)": 0.002,
           "void implicit_convolve_sgemm<__nv_bfloat16, __nv_bfloat16, 1024>"
           "(z)": 0.001,
           "nvjet_tst_256x32_64x5_2x1_v_ssched_bz_NNT": 0.001,
           "void at::native::elementwise_kernel<128, 2>(w)": 0.14}
    t = trace.Trace(0.2, 0.16, ops, {}, {}, {})
    vals = {m["name"]: c.readers[m["name"]](_run(t)) for m in c.per_layer}
    assert vals["float_conv_device_ms.offline"] == pytest.approx(1.0)
    least = max(w / p for w, p in zip(yolo.work(c.cfg, 16)["s8_gemm"],
                                      (1979e12, 3.35e12)))
    assert vals["s8_gemm_roofline.offline"] == \
        pytest.approx(100 * least / 0.0015)
    assert vals["ops_device_ms.offline"] == pytest.approx(20.0)
    assert vals["device_idle.offline"] == pytest.approx(0.0)


def test_the_reference_imports_no_port_and_no_jax():
    code = ("import sys; import portbench.configs.yolo_ref; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'planer_tpu_torch', 'planer_tpu', 'jax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.CHECKOUT, check=True)
    assert out.stdout.strip() == "[]"
