"""Device time per step of every device operation that is not one of the
port's hand kernels (the W8A8 chain, cuDNN and cuBLAS, copies), in ms, in
the traced window."""


def read(run):
    t, w = run.trace, run.traced
    if (t is None or not t.busy_s or not (w.calls - w.failed)
            or not run.kernels_ok):
        return None
    other = sum(t.device_ops.values()) - sum(t.module_s.values())
    return 1e3 * other / (w.calls - w.failed)
