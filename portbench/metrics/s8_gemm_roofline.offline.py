"""The least time of the s8 GEMMs' work (the convs whose GEMM is an s8 one,
``work["s8_gemm"]``: their operations and least bytes from the layer
shapes) over the device time of the s8 GEMM kernels per call in the
traced window, in %: the library GEMM's share of its roofline."""
import re

from portbench.peaks import least_seconds

# the int8 GEMMs ``torch._int_mm`` launches on the card (an H100 trace of the
# YOLO cell: cutlass_80_tensorop_i16832gemm_s8_*)
KERNEL = re.compile(r"gemm_s8")


def read(run):
    t, w = run.trace, run.traced
    work = run.work.get("s8_gemm")
    if (t is None or run.peaks is None or not run.kernels_ok or work is None
            or not (w.calls - w.failed)):
        return None
    busy = sum(v for n, v in t.device_ops.items() if KERNEL.search(n))
    if not busy:
        return None
    least = least_seconds(*work, run.peaks["int8_ops"], run.peaks["hbm_bytes"])
    return 100.0 * least / (busy / (w.calls - w.failed))
