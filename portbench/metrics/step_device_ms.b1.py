"""Device busy time per request in the traced window (the union of the
device's operations), in ms."""


def read(run):
    t, w = run.trace, run.traced
    if t is None or not t.busy_s or not (w.calls - w.failed):
        return None
    return 1e3 * t.busy_s / (w.calls - w.failed)
