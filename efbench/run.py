"""Entry point of the benchmark of `elasticfusion_tpu_torch`:

    python3 efbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON result line last (see
`efbench/harness.py`); exits with another code than 0, and prints no result,
without enough CUDA devices or without the program beside it.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the kernels' build directory and every cache stay inside the checkout
os.environ.setdefault("CUDA_CACHE_PATH", os.path.join(ROOT, "build", "efbench", "nv"))

if __name__ == "__main__":
    sys.path.insert(0, ROOT)
    from efbench.harness import main

    main(t_start=T_START)
