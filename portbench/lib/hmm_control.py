"""The control of the somatic cell, read at the cell's own size: a run
of the cell whose comparison also puts the reference, in bfloat16, in
the program's place on the same drawn pairs and logs its gap beside the
program's.

    python3 portbench/lib/hmm_control.py --workload chr20-somatic \
        --seed <n> --seconds <s> --trace 0

Needs the card, as a run does.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from lib import harness  # noqa: E402


def judge(ctx, run):
    from reference import somatic
    pairs = somatic.drawn_pairs(ctx, run.pairs)
    if pairs:
        harness.log(f"control hmm_max_abs_log10 = "
                    f"{somatic.hmm_gap(pairs, bf16=True)} over "
                    f"{len(pairs[1])} pairs")
    return inner(ctx, run)


inner = harness.judge

if __name__ == "__main__":
    harness.one_thread_a_process()
    harness.judge = judge
    sys.exit(harness.main())
