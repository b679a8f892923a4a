"""Run one cell of the benchmark:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Prints the compared numbers beside their
limits on stderr and one JSON line last on stdout; exits non-zero, with no
line, where the card or the program is missing. See benchmark/harness.py.
"""

import os
import sys
import time

T0 = time.perf_counter()
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
# kernel caches at fixed paths inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(ROOT, ".bench_cache", "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, ".bench_cache", "triton")

if __name__ == "__main__":
    from benchmark.harness import main

    sys.exit(main(t0=T0))
