"""Share of a request in which no operation runs on the device, in %: at
batch 1, the host's part of each request (the API and program layers'
copies, entry lookup and replay launch).  One less the device's busy time
per request (the union of its operations in the traced window) over the
measured window's time per request (host clock, untraced, so the
profiler's own cost at each launch is not counted as idle)."""


def read(run):
    t, w, step = run.trace, run.traced, run.step_s()
    if t is None or not t.busy_s or step is None or not (w.calls - w.failed):
        return None
    return 100.0 * (1.0 - t.busy_s / (w.calls - w.failed) / step)
