"""Run one benchmark cell once on the card this process finds.

    python -m vio_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout; see ``vio_bench/harness.py``.
"""

import time

T_START = time.perf_counter()

import sys  # noqa: E402

if __name__ == "__main__":
    from vio_bench.harness import main

    sys.exit(main(sys.argv[1:], T_START))
