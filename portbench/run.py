#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds BENCHMARK.json and shortseq_torch/,
on a machine with the CUDA devices the cell asks for (see README.md).
"""

import time

T0 = time.perf_counter()  # set-up is timed from here

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

# The program under test sits at the checkout's root, beside portbench/.
sys.path.insert(1, str(Path(__file__).resolve().parent.parent))

from harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main(sys.argv[1:], T0))
