"""The benchmark of zkrollup_torch: one run of one cell.

    python3 rollbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

run from the root of a checkout, on a machine with the CUDA devices the
cell asks for (without them it exits 3 and prints no result). The last
line of standard output is the run's JSON result; standard error ends
with each number the check compared, beside its limit. See harness.py.
"""

import os
import sys
import time

# set-up is timed from here: the process's first statement
T_START = time.time()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def main(argv=None) -> int:
    from rollbench import harness
    return harness.main(argv, T_START)


if __name__ == "__main__":
    sys.exit(main())
