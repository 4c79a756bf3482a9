"""The benchmark of the PyTorch/CUDA port: one cell, one run, on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds ``exp_ldpc_tpu_torch/`` beside
``BENCHMARK.json``; ``harness.py`` says what a run does and prints.
"""
import time

T0 = time.perf_counter()   # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from benchmark.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
