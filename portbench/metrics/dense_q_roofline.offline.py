"""The least time of the work on ``dense_q``'s kernel branch (the Linears
it runs, ``work["dense_q"]``: their operations and least bytes from the
layer shapes, at the card's bfloat16 peak and memory bandwidth) over the
device time of the gemm module's kernels per call in the traced window, in
%: the hand-written dense_q's share of its roofline."""
from portbench.peaks import least_seconds


def read(run):
    t, w = run.trace, run.traced
    work = run.work.get("dense_q")
    if (t is None or run.peaks is None or not run.kernels_ok or not work
            or not work[0] or not t.module_s.get("gemm")
            or not (w.calls - w.failed)):
        return None
    least = least_seconds(*work, run.peaks["bf16_flops"],
                          run.peaks["hbm_bytes"])
    return 100.0 * least / (t.module_s["gemm"] / (w.calls - w.failed))
