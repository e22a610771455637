"""The ConvNeXt cell through the harness at a small size on the CPU (widths
(128, 128, 256, 256), depths (1, 1, 2, 1), 128 px, b4: every route of the
cell): its last line, the control in the program's place and an answer
altered where the program produces it both not correct; the readers of
its two per-layer metrics against kernel names as an H100 trace gives
them."""
import json
import subprocess
import sys

import pytest

from portbench import control, generators, harness, trace
from portbench.configs import convnext

NAME = "convnext-b-offline-b64-dev"
# the CPU runs plain versions: no kernel launches to hold to the plan
SMALL = {"config": {"depths": [1, 1, 2, 1], "widths": [128, 128, 256, 256],
                    "image_side": 128, "kernels": {}},
         "traffic": {"batch": 4, "pool": 2, "sample": 2, "warmup_calls": 1,
                     "trace_seconds": 0.3}}


def test_a_run_prints_the_contract_line():
    out = harness.run_cell(NAME, 2 ** 31 + 71, 0.3, False, device="cpu",
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
    r = control.readings(NAME, 2 ** 31 + 72, 0.3, device="cpu",
                         overrides=SMALL)
    assert r["correct"] == [True, False]
    prog, ctl = r["program"]["max_rel_gap"], r["control"]["max_rel_gap"]
    assert prog["value"] <= prog["limit"] < ctl["value"]


def test_an_answer_altered_where_it_is_produced_is_not_correct(monkeypatch):
    build = convnext.build

    def altered(*a, **kw):
        net = build(*a, **kw)

        def call(x):
            y = net(x)
            y[:, 7] += 0.5 * abs(y).max()
            return y
        return call

    monkeypatch.setattr(convnext, "build", altered)
    out = harness.run_cell(NAME, 2 ** 31 + 73, 0.3, False, device="cpu",
                           overrides=SMALL)
    assert out["correct"] is False
    gap = out["checks"]["max_rel_gap"]
    assert gap["value"] > gap["limit"]


def _run(tr):
    cfg = harness.cell(harness.load_spec(), NAME).cfg
    win = generators.Window(10, 640, 0, 0.4, [0.04] * 10, [])
    traced = generators.Window(8, 512, 0, 0.4, [0.05] * 8, [])
    return harness.Run(cfg, {}, 1.0, win, traced if tr else None, tr,
                       convnext.work(cfg, 64),
                       {"int8_ops": 1979e12, "bf16_flops": 989e12,
                        "hbm_bytes": 3.35e12}, True)


def test_the_new_readers_read_the_kernels_they_name():
    c = harness.cell(harness.load_spec(), NAME)
    assert {m["name"] for m in c.per_layer} == {
        "step_mfu.offline", "ops_device_ms.offline", "device_idle.offline",
        "dense_q_roofline.offline", "norm_act_device_ms.offline"}
    for m in c.per_layer:
        assert c.readers[m["name"]](_run(None)) is None
    # 8 traced calls: names as an H100 trace of the cell gives them
    s = "void at::native::"
    ops = {
        "void dense_q_kernel<128, __nv_bfloat16, 0>(CUtensorMap_st)": 0.040,
        s + "(anonymous namespace)::vectorized_layer_norm_kernel<c10::"
        "BFloat16, float, false>(int)": 0.001,
        "conv2d_c1_k1_nhwc_specialized": 0.002,
        "erfc_kernel_vectorized4_kernel": 0.003,
        s + "vectorized_elementwise_kernel<4, at::native::neg_kernel_cuda("
        "at::TensorIteratorBase&)::{lambda()#2}": 0.004,
        s + "vectorized_elementwise_kernel<8, at::native::bfloat16_copy_"
        "kernel_cuda(at::TensorIteratorBase&)::{lambda(float)#1}": 0.005,
        s + "unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda("
        "at::TensorIteratorBase&)::{lambda()#3}::operator()() const::"
        "{lambda()#7}::operator()() const::{lambda(float)#1}, std::array"
        "<char*, 2ul>, 4>": 0.006,
        s + "vectorized_elementwise_kernel<4, at::native::BinaryFunctor<"
        "float, float, float, at::native::binary_internal::MulFunctor<float>"
        " >, std::array<char*, 3ul> >": 0.007,
        s + "elementwise_kernel<128, 2, at::native::gpu_kernel_impl_nocast<"
        "at::native::BinaryFunctor<float, float, float, at::native::binary_"
        "internal::MulFunctor<float> > >": 0.008,
        s + "elementwise_kernel<128, 4, at::native::gpu_kernel_impl_nocast<"
        "at::native::BinaryFunctor<c10::BFloat16, c10::BFloat16, c10::"
        "BFloat16, at::native::binary_internal::MulFunctor<float> > >": 0.009,
        # not matched: the W8A8 chain's mixed-dtype multiply, the adds, the
        # int8 cast, the stem's conv
        s + "elementwise_kernel<128, 4, at::native::gpu_kernel_impl<at::"
        "native::BinaryFunctor<float, float, float, at::native::binary_"
        "internal::MulFunctor<float> > >": 0.1,
        s + "vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<"
        "c10::BFloat16>, std::array<char*, 3ul> >": 0.1,
        s + "unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda("
        "at::TensorIteratorBase&)::{lambda()#3}::operator()() const::"
        "{lambda()#2}::operator()() const::{lambda(signed char)#1}>": 0.1,
        "void precomputed_convolve_sgemm<__nv_bfloat16, 128, 6, 7, 3, 3, 5, "
        "1, false>(int)": 0.1}
    t = trace.Trace(0.4, 0.3168, ops, {"gemm": 576}, {"gemm": 0.040}, {})
    vals = {m["name"]: c.readers[m["name"]](_run(t)) for m in c.per_layer}
    assert vals["norm_act_device_ms.offline"] == pytest.approx(5.625)
    least = max(w / p for w, p in zip(convnext.work(c.cfg, 64)["dense_q"],
                                      (989e12, 3.35e12)))
    assert vals["dense_q_roofline.offline"] == pytest.approx(
        100 * least / 0.005)
    assert vals["ops_device_ms.offline"] == pytest.approx(
        1e3 * (sum(ops.values()) - 0.040) / 8)
    assert vals["device_idle.offline"] == pytest.approx(1.0)


def test_the_reference_imports_no_port_and_no_jax():
    code = ("import sys; import portbench.configs.convnext_ref; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'planer_tpu_torch', 'planer_tpu', 'jax', 'jaxlib'}))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=harness.CHECKOUT, check=True)
    assert out.stdout.strip() == "[]"


def test_the_reference_turns_tf32_off():
    import torch
    from portbench.configs import convnext_ref, resnet_ref
    src = open(convnext_ref.__file__).read()
    assert "rr._no_tf32()" in src
    mm = torch.backends.cuda.matmul
    saved = mm.allow_tf32
    mm.allow_tf32 = True
    try:
        with resnet_ref._no_tf32():
            assert not mm.allow_tf32
            assert not torch.backends.cudnn.allow_tf32
        assert mm.allow_tf32
    finally:
        mm.allow_tf32 = saved
