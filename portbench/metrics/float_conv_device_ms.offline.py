"""Device time per call, in ms, of the bfloat16 convs (the convs the route
gate sends off the int8 path): cuDNN's conv kernels, its NCHW <-> NHWC
transposes around them and the bfloat16 GEMMs it hands 1x1 convs to, in
the traced window."""
import re

# on the card (an H100 trace of the YOLO cell): sm90_xmma_fprop_implicit_
# gemm_bf16bf16_*, implicit_convolve_sgemm<__nv_bfloat16, ...>, cudnn's
# nchwToNhwcKernel / nhwcToNchwKernel, and cuBLAS's nvjet_* and
# cutlass_*_bf16_*gemm_bf16_* for the 1x1 convs
KERNEL = re.compile(r"fprop_implicit_gemm_bf16|implicit_convolve_sgemm<"
                    r"__nv_bfloat16|nchwToNhwc|nhwcToNchw|nvjet|gemm_bf16")


def read(run):
    t, w = run.trace, run.traced
    if t is None or not (w.calls - w.failed) or not run.kernels_ok:
        return None
    busy = sum(v for n, v in t.device_ops.items() if KERNEL.search(n))
    if not busy:
        return None
    return 1e3 * busy / (w.calls - w.failed)
