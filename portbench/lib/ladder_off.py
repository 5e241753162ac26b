"""The program's own path with the escalation ladder switched off
(Aligner.ESCALATE_LEVELS = 0): a read that overflows the primary pass
keeps the regions of that pass. On the sweep engine (chr20-pe-mem) most
overflowed reads have none and are reported unmapped, so the paired-end
cell's unmapped_pct fails it: a later change that cut the ladder for
speed would read so. On the LCP engine (ecoli-se-pipeline) those regions
place almost every such read, so there this path is the witness of the
ladder's fault (PERF.md, Open questions).

    python3 portbench/lib/ladder_off.py --workload <cell> --seed <n> \
        --seconds <s> --trace 0

prints the run's result line (its checks hold the numbers). Needs the
card, as a run does.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from lib import harness  # noqa: E402

if __name__ == "__main__":
    harness.one_thread_a_process()
    sys.path.insert(0, harness.ROOT)
    from fgdp_tpu_torch.pipeline import Aligner
    Aligner.ESCALATE_LEVELS = 0
    sys.exit(harness.main())
