#!/usr/bin/env python3
"""The benchmark of the PyTorch/CUDA port (``graphvqa_tpu_torch``): one run
of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload gat.train.gqa_b200 --seed 7 \
        --seconds 20 --trace 0

Run from the root of a checkout on a machine with the cards the cell asks
for; it exits non-zero, printing no result, without them. See
``benchmark/harness/main.py`` for what it prints.
"""
import time

T_START = time.perf_counter()

import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# caches of builds and kernels at fixed paths inside the checkout
CACHE = CHECKOUT / "build" / "benchmark_cache"
os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
os.environ["USE_FLAX"] = "0"
os.environ["USE_TF"] = "0"
sys.path.insert(0, str(HERE))
sys.path.append(str(CHECKOUT))

from harness.main import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T_START))
