"""Run one cell of the port's benchmark once:

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The last line of standard output is the result (JSON); the numbers the
correctness check compared, each beside its limit, are the last lines of
standard error."""
import sys

from portbench.harness import main

if __name__ == "__main__":
    sys.exit(main())
