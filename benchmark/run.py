"""The benchmark of focalsv_tpu_torch: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for; see focalbench/harness.py and PERF.md.
"""

import os
import sys


def _start() -> float:
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:0] = [os.path.dirname(here), here]
    from focalbench.harness import process_start
    return process_start()


if __name__ == "__main__":
    t_start = _start()
    from focalbench import harness
    sys.exit(harness.main(sys.argv[1:], t_start))
