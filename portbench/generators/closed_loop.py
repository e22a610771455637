"""One closed-loop client (``"generator": "closed_loop"``).  Its mix's
parameters:

  * ``batch``: images per call;
  * ``pool``: distinct batches, made from the seed in set-up and cycled;
  * ``inputs_on``: "device" (batches made and kept on the card, handed over
    as CUDA tensors) or "host" (float32 numpy arrays in pageable memory);
  * ``sample``: answers kept for the correctness check, a reservoir sample
    over every call of the window, drawn from the seed;
  * ``warmup_calls``: calls made in set-up, before the window;
  * ``trace_seconds``: the length of the traced window (``--trace 1``).

One client calls back to back (a closed loop): the next call starts when
the previous answer is a numpy array.  Every call is timed on the host
clock from submit to that answer.
"""
from __future__ import annotations

import random
import sys
import time
import traceback

import torch

from . import Window

KEYS = {"generator", "batch", "pool", "inputs_on", "sample", "warmup_calls",
        "trace_seconds"}


def make(traffic: dict, make_inputs, seed: int):
    return ClosedLoop(traffic, make_inputs, seed)


class ClosedLoop:
    def __init__(self, traffic: dict, make_inputs, seed: int):
        if set(traffic) != KEYS:
            raise ValueError(f"traffic keys {sorted(traffic)}, expected "
                             f"{sorted(KEYS)}")
        if traffic["inputs_on"] not in ("device", "host"):
            raise ValueError(f"inputs_on {traffic['inputs_on']!r}")
        self.t = traffic
        self.seed = seed
        b, n = traffic["batch"], traffic["pool"]
        x = make_inputs(b * n)
        self.device_batches = list(torch.split(x, b))
        self.pool = (self.device_batches if traffic["inputs_on"] == "device"
                     else [t.cpu().numpy() for t in self.device_batches])

    def inputs(self, key):
        """The pool batch ``key`` (a sampled answer's key) on the device."""
        return self.device_batches[key]

    def warm(self, call):
        for i in range(self.t["warmup_calls"]):
            call(self.pool[i % len(self.pool)])

    def run(self, call, seconds: float, span=None) -> Window:
        """Call back to back for ``seconds``; ``span(name)``, if given, is a
        context manager entered around each call (the traced run's)."""
        k = self.t["sample"]
        rng = random.Random(f"{self.seed}:sample")
        lat, sample, failed, ok, i = [], [], 0, 0, 0
        t0 = now = time.perf_counter()
        end = t0 + seconds
        while now < end:
            x = self.pool[i % len(self.pool)]
            ts = time.perf_counter()
            try:
                if span is None:
                    y = call(x)
                else:
                    with span("portbench.call"):
                        y = call(x)
            except Exception:
                if not failed:
                    traceback.print_exc(file=sys.stderr)
                failed += 1
                y = None
            now = time.perf_counter()
            lat.append(now - ts)
            if y is not None:
                ok += 1
                entry = (i % len(self.pool), y)
                if len(sample) < k:
                    sample.append(entry)
                else:
                    j = rng.randrange(ok)
                    if j < k:
                        sample[j] = entry
            i += 1
        return Window(i, i * self.t["batch"], failed, now - t0, lat,
                      sample)
