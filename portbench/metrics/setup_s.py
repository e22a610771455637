"""Process start to the first timed call: build the net, calibrate,
quantize, load or build the kernels, make the traffic, capture and warm
the cell's one signature (host clock)."""


def read(run):
    return run.setup_s
