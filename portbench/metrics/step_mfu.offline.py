"""The step's least time at the card's published peaks (int8 ops at the
int8 rate, bfloat16 ones at the bfloat16 rate, counted from the layer
shapes) over the measured window's time per call (host clock, untraced, so
the profiler's own cost is not in it), in %."""


def read(run):
    w, p, step = run.work, run.peaks, run.step_s()
    if (run.trace is None or p is None or step is None
            or "int8_ops" not in w):
        return None
    least = w["int8_ops"] / p["int8_ops"] + w["bf16_ops"] / p["bf16_flops"]
    return 100.0 * least / step
