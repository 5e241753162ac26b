#!/usr/bin/env python3
"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout that holds the port (fgdp_tpu_torch) beside
this folder. It measures the port on one CUDA card; without a card it
exits 2 and prints no result. With --trace 0 its last line of standard
output holds the cell's end-to-end metrics, with --trace 1 its per-layer
metrics; see portbench/README.md.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from lib import harness  # noqa: E402

if __name__ == "__main__":
    harness.one_thread_a_process()
    sys.exit(harness.main())
