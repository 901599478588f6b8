#!/usr/bin/env python3
"""Run one cell of the benchmark of ventjax_torch once.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints one JSON line (the last on standard
output) and exits 0, or exits non-zero with no result: without a CUDA
card, with too few cards for the cell, or when the run loaded the JAX
stack or the JAX package.  See portbench/README.md.
"""
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# Fixed cache directories inside the checkout, set before CUDA starts: the
# driver's JIT cache (the port's kernels are built for sm_90a, so it should
# stay empty) and the few threads the host side needs.
os.environ.setdefault("CUDA_CACHE_PATH", str(ROOT / "build" / "cuda_cache"))
os.environ.setdefault("OMP_NUM_THREADS", "2")
sys.path.insert(0, str(ROOT))

from portbench.harness import run  # noqa: E402

if __name__ == "__main__":
    sys.exit(run(sys.argv[1:]))
