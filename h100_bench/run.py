#!/usr/bin/env python3
"""Run one cell of the benchmark of ``esme_tpu_torch`` once, on the card.

    python3 h100_bench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. Prints the result as the last line of
standard output (see ``h100_bench/hbench/harness.py``); exits non-zero and
prints no result without a CUDA card.
"""

import time

T_START = time.perf_counter()

import sys                                      # noqa: E402
from pathlib import Path                        # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from hbench.harness import main                 # noqa: E402

if __name__ == '__main__':
    sys.exit(main(sys.argv[1:], T_START))
