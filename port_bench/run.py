"""Run one benchmark cell on the H100 and print its result as the last
line of standard output:

    python3 port_bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Exits non-zero, printing no result, without
the CUDA devices the cell asks for.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# the checkout's root, not this folder, heads the import path
sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

from port_bench.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(t_start=T_START))
