"""The least time of the work the fused stage64 stage covers (its convs'
operations and its least bytes, from the layer shapes, not the kernel's
padding or tiles) over the device time of its kernels per step in the
traced window, in %."""
from portbench.peaks import least_seconds


def read(run):
    t, w = run.trace, run.traced
    work = run.work.get("stage64")
    if (t is None or run.peaks is None or not run.kernels_ok or work is None
            or not t.module_s.get("stage64") or not (w.calls - w.failed)):
        return None
    least = least_seconds(*work, run.peaks["int8_ops"], run.peaks["hbm_bytes"])
    return 100.0 * least / (t.module_s["stage64"] / (w.calls - w.failed))
