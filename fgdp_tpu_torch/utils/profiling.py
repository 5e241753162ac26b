"""Phase timers with the reference's taxonomy.

The reference accumulates rdtsc per (event, thread) in a global matrix
and prints a per-phase report (bwa-mem2-lcp/src/profiling.cpp:79,
event IDs src/macro.h:69-179; sortmardup's time_stamp main.cpp:597).
Here: named wall-clock accumulators + a display_stats-style report;
a device phase that must include the device's work ends in a sync.
"""

from __future__ import annotations

import contextlib
import sys
import time
from collections import defaultdict

# the reference's phase names (macro.h) kept for report familiarity
READ_IO = "READ_IO"
WORKER_SAM = "WORKER_SAM"       # finalize + SAM text
SAM_IO = "SAM_IO"
HMM_WAIT = "HMM_WAIT"           # PairHMM collect(): sync + copy back
HMM_F64 = "HMM_F64"             # PairHMM f64 re-run on the host


class Profiler:
    def __init__(self):
        self.acc = defaultdict(float)
        self.hits = defaultdict(int)
        self.counts = defaultdict(int)   # named event counts (count())

    @contextlib.contextmanager
    def phase(self, name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.acc[name] += time.perf_counter() - t0
            self.hits[name] += 1

    def reset(self):
        self.acc.clear()
        self.hits.clear()
        self.counts.clear()

    def add(self, name, seconds):
        self.acc[name] += seconds
        self.hits[name] += 1

    def count(self, name, n=1):
        self.counts[name] += n

    def display_stats(self, out=sys.stderr, units=None, unit_name=""):
        """Per-phase report (display_stats, src/profiling.cpp:79)."""
        total = sum(self.acc.values())
        print("phase breakdown:", file=out)
        for name, t in sorted(self.acc.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total else 0.0
            rate = f"  {units / t:,.0f} {unit_name}/s" \
                if units and t > 0 else ""
            print(f"  {name:<14s} {t:8.2f}s {pct:5.1f}%  "
                  f"x{self.hits[name]}{rate}", file=out)
        print(f"  {'TOTAL':<14s} {total:8.2f}s", file=out)


PROF = Profiler()
