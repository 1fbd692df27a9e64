#!/usr/bin/env python3
"""Run one benchmark cell of the PyTorch/CUDA port (``mst_torch``) once.

    python3 benchmark/run.py --workload serve.fp32.r3x3 --seed 7 \
        --seconds 30 --trace 0

Run from the root of a checkout, on a machine with the cards the cell
needs. It makes the cell's inputs and weights from ``--seed``, sets up and
warms up, measures for ``--seconds``, checks the outputs against the plain
reference (``benchmark/reference``), and prints one JSON line last:
``correct``, ``attempted``, ``failed``, ``metrics`` (the end-to-end metrics,
or with ``--trace 1`` the per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and ``checks`` (each number compared, with its limit). It
exits non-zero and prints no result without the cards, or when JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

# one process with few threads: the host's math libraries run on one
# thread, so that a run's host work does not spread over cores that other
# work on the machine shares
for _var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[_var] = "1"

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from benchmark import harness  # noqa: E402

if __name__ == "__main__":
    sys.exit(harness.main(sys.argv[1:], T_START))
