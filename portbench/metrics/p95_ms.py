"""The 95th percentile of every call's latency in the window, submit to
numpy answer (host clock), in milliseconds."""
import numpy as np


def read(run):
    return float(np.percentile(run.window.latencies, 95)) * 1e3
