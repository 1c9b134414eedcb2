"""Run one cell of the benchmark of ``fmm_bem_tpu_torch``.

    python3 bench_h100/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1> [--rehearse]

from the root of a checkout.  The last line of standard output is the
result; ``README.md`` beside this file says more.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from bench_h100.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
