"""Phase timers and event counts with the reference's taxonomy.

The reference accumulates rdtsc per (event, thread) in a global matrix
and prints a per-phase report (bwa-mem2-lcp/src/profiling.cpp:79,
event IDs src/macro.h:69-179; sortmardup's time_stamp main.cpp:597).
Here: named wall-clock accumulators, always on, and a display_stats-style
report. A phase's time is host wall time; the device's work shows in it
only where the phase waits for the device (a fetch, a host read).

Phases (`PROF.acc[name]`: inclusive seconds; `PROF.self_acc[name]`: the
same less the phases opened inside it on the same thread; `hits`: calls):

  READ_IO       cli: reading a FASTQ batch (prefetch thread)
  SAM_IO        cli `mem`: writing SAM lines (writer thread)
  MEM_DEVICE    pipeline.Aligner._device_regs_async: enqueueing a
                primary batch's device program
  REG_SYNC      pipeline_stream.overlapped_regs: a primary batch's fetch
                (Aligner._regs_to_np) and its escalation ladder
  ESC_RETRY     Aligner._retry_overflow: the whole ladder of one batch
                (inside REG_SYNC, or the stream's deferred flush)
  ESC_PACK      inside ESC_RETRY: copying the batch's regs, building
                each rung chunk's codes, lens and active arrays
  ESC_DISPATCH  inside ESC_RETRY: enqueueing a rung's device program
  ESC_FETCH     inside ESC_RETRY: a rung's fetch (its `.cpu()`: the wait
                for its device work, and the copy)
  ESC_MERGE     inside ESC_RETRY: unpacking a rung's regs, widening the
                batch's, copying the rung's rows and flags back
  DP_SYNC       host_read: a point of the device program where the host
                waits for the card, a read of a device value or a
                blocking copy to the card (inside MEM_DEVICE or
                ESC_DISPATCH on the aligner's path; a replayed dispatch
                has none)
  DP_CAPTURE    pipeline._GraphRunner: capturing a shape's device program
                into a CUDA graph (inside MEM_DEVICE or ESC_DISPATCH)
  WORKER_SAM    Aligner.finalize_batch: finalize in the main process
  POOL_SUBMIT   pipeline_stream streams: handing a batch to FinalizePool
  POOL_WAIT     pipeline_stream streams: FinalizePool.collect, waiting
                for a batch's SAM lines
  POOL_WORK     FinalizePool.collect adds each batch's finalize seconds
                as its worker measured them: time of other processes,
                never nested, overlapping the main process's phases
  SORT_FEED     stream_fastq_to_bam: feeding SAM lines to the sort
  SORT_FINISH   stream_fastq_to_bam: the sort's last pass (holds SD_*)
  SD_DUPSCAN, SD_SORT, SD_ENCODE, SD_BGZF, SD_BAI
                sortdup/driver.py: duplicate scan, coordinate order, BAM
                encode, BGZF, BAI (inside SORT_FINISH in a stream)
  HMM_WAIT      ops/pairhmm.py: a PairHMM launch's fetch
  HMM_F64       ops/pairhmm.py: float64 re-run of underflowed pairs

Counts (`PROF.counts[name]`):

  HMM_F64         pairs re-run in float64
  ESC_ACTIVE      reads in a rung chunk, summed over the rungs
  ESC_LANES       a rung chunk's batch (a power of two), summed
  ESC_UNRESOLVED  reads still flagged overflowed when a ladder returns
  DP_SYNC         calls of host_read
  DP_REPLAY       card dispatches of the device program that replayed its
                  captured CUDA graph (pipeline._GraphRunner)
  DP_CAPTURE      card dispatches that ran their shape's program op by op
                  and then captured it
  DP_EAGER        card dispatches run op by op with no capture: their
                  shape's capture failed (or a test asked for it); the
                  three add up to the card's dispatches, and the CPU
                  counts none of them

While a torch profiler records, every phase is also a
`torch.profiler.record_function("fgdp.<PHASE>")` annotation, so a trace of
the port shows its phases on the device's timeline. Without a profiler
no annotation is entered (the check costs well under a microsecond).
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import defaultdict

import torch

# the reference's phase names (macro.h) kept for report familiarity
READ_IO = "READ_IO"
WORKER_SAM = "WORKER_SAM"       # finalize + SAM text
SAM_IO = "SAM_IO"
HMM_WAIT = "HMM_WAIT"           # PairHMM collect(): sync + copy back
HMM_F64 = "HMM_F64"             # PairHMM f64 re-run on the host
DP_SYNC = "DP_SYNC"             # the host waits for the card (host_read)

_profiler_enabled = torch._C._autograd._profiler_enabled


class Profiler:
    def __init__(self):
        self.acc = defaultdict(float)
        self.self_acc = defaultdict(float)
        self.hits = defaultdict(int)
        self.counts = defaultdict(int)   # named event counts (count())
        self._open = threading.local()   # per thread: child s of open phases

    @contextlib.contextmanager
    def phase(self, name):
        ann = None
        if _profiler_enabled():
            ann = torch.profiler.record_function("fgdp." + name)
            ann.__enter__()
        stack = self._stack()
        stack.append(0.0)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.acc[name] += dt
            self.hits[name] += 1
            self.self_acc[name] += dt - stack.pop()
            if stack:
                stack[-1] += dt
            if ann is not None:
                ann.__exit__(None, None, None)

    def _stack(self):
        s = getattr(self._open, "stack", None)
        if s is None:
            s = self._open.stack = []
        return s

    def reset(self):
        self.acc.clear()
        self.self_acc.clear()
        self.hits.clear()
        self.counts.clear()

    def add(self, name, seconds):
        self.acc[name] += seconds
        self.self_acc[name] += seconds
        self.hits[name] += 1

    def count(self, name, n=1):
        self.counts[name] += n

    def display_stats(self, out=sys.stderr, units=None, unit_name=""):
        """Per-phase report (display_stats, src/profiling.cpp:79): each
        phase's self time, so that TOTAL counts no second twice."""
        total = sum(self.self_acc.values())
        print("phase breakdown (self time):", file=out)
        for name, t in sorted(self.self_acc.items(), key=lambda kv: -kv[1]):
            pct = 100.0 * t / total if total else 0.0
            rate = f"  {units / t:,.0f} {unit_name}/s" \
                if units and t > 0 else ""
            print(f"  {name:<14s} {t:8.2f}s {pct:5.1f}%  "
                  f"x{self.hits[name]}{rate}", file=out)
        print(f"  {'TOTAL':<14s} {total:8.2f}s", file=out)


PROF = Profiler()


def host_read(read, *args, **kw):
    """`read(*args, **kw)`, a point of the device program where the host
    waits for the card: a read of a device value (`int(t.max())`) or a
    blocking copy of host memory to the card (`torch.as_tensor(a,
    device=)`). Timed under the phase DP_SYNC and counted once in
    PROF.counts; on the card each waits for all the work queued before
    it (torch.cuda.set_sync_debug_mode("warn") reports each once). The
    CPU path counts the same calls, where nothing waits."""
    PROF.count(DP_SYNC)
    with PROF.phase(DP_SYNC):
        return read(*args, **kw)
