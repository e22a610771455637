"""The readings the correctness limits are set from, on the card at a
cell's own size: for each seed, a run of the cell as the benchmark runs it
(the lower reading: the program's checks), and a run with the family's
control in the program's place (the upper reading: the reference with
4-bit weights and activation codes, put through the same window, sample
and comparison, which has to come out as not correct).

    python3 -m portbench.control --workload <cell> --seeds 1,2,3 --seconds 1

One process runs each seed's two runs in turn; one JSON line per seed.
The benchmark's own runs never run the control."""
from __future__ import annotations

import argparse
import json
import sys

from . import harness


def readings(name, seed, seconds, device="cuda", spec=None, overrides=None):
    """{"program": checks, "control": checks, "correct": [program's,
    control's]} of one seed, each from ``harness.run_cell``."""
    runs = [harness.run_cell(name, seed, seconds, False, device=device,
                             spec=spec, overrides=overrides, control=ctl)
            for ctl in (False, True)]
    return {"program": runs[0]["checks"], "control": runs[1]["checks"],
            "correct": [r["correct"] for r in runs],
            "calls": [r["attempted"] for r in runs]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=1.0)
    args = ap.parse_args(argv)
    harness.use_cache_dirs()
    import torch
    torch.set_num_threads(1)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = readings(args.workload, seed, args.seconds)
        print(json.dumps({"workload": args.workload, "seed": seed, **r}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
