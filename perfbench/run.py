#!/usr/bin/env python3
"""The benchmark of bags_tpu_torch: one run of one cell of BENCHMARK.json.

    python3 perfbench/run.py --workload pose-train --seed 7 --seconds 10 --trace 0

Run from the root of the repository, on a machine with the CUDA cards the
cell asks for. See `harness/cli.py` for what a run does and prints.
"""

import os
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
# The harness and its reference first; the repository root last, so that
# the program imports and the standard library's modules are not shadowed
# by the root's scripts.
sys.path.insert(0, HERE)
sys.path.append(os.path.dirname(HERE))

from harness import cli  # noqa: E402

if __name__ == "__main__":
    sys.exit(cli.main(sys.argv[1:]))
