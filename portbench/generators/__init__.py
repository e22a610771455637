"""Traffic generators.  Every traffic mix (``traffic/<mix>.json``) holds
``generator``, ``batch`` (images per call of the program, which the
step's work and the reference's routes follow) and ``trace_seconds`` (the
traced window's length), besides its generator's own keys.  The harness
imports ``generators/<generator>.py`` and calls its ``make(traffic,
make_inputs, seed)``, where ``make_inputs(n)`` returns ``n`` seeded inputs
of the cell's configuration on the device.  The load it returns has

  * ``warm(call)``: the set-up's calls, on every signature the window uses;
  * ``run(call, seconds, span=None) -> Window``: the measured window,
    ``span(name)`` (the traced run's) entered around each call;
  * ``inputs(key) -> tensor``: the inputs behind a sampled answer's key, on
    the device, for the reference.

A new generator is a new module here; a new mix of an existing one is a
data file.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class Window:
    calls: int
    images: int
    failed: int
    seconds: float
    latencies: list            # seconds, one per call
    sample: list               # (key, answer) pairs for the reference
