"""Streaming stage-overlap drivers — the pipeline-parallel analogue.

The reference overlaps its stages two ways:
  * within the aligner, a 3-step pthread pipeline (read chunk -> align
    -> write SAM) keeps I/O off the compute path (kt_pipeline,
    bwa-mem2-lcp/src/fastmap.cpp:191-368, two in-flight batches);
  * between programs, SAM is piped: sormadup ingests the aligner's
    stdout on a dedicated reader thread while shuffle threads parse
    bulks behind it (sortmardup/main.cpp:84-212), and only the final
    sort waits for all input.

Here the same structure runs around the card: a prefetch thread decodes
FASTQ while the device aligns, a writer thread drains SAM lines, and
`StreamingSortMarkdup` runs the native pass-1 parse (numeric key
extraction + rid/pairID assignment) chunk-by-chunk behind the aligner —
at finish only the global dup-scan + coordinate sort + encode remain.
Chunks split on QNAME boundaries so mate pairs never straddle a parse
unit (main.cpp:532-544). `FinalizePool` fans the host SAM finalize out
to spawned worker processes. Single-end workers never touch the card;
the workers of a paired-end pool on the card open it and run their
batches' mate rescue through the kswv kernel there.

Port of the JAX package's pipeline_stream.py.
"""

from __future__ import annotations

import collections
import queue
import threading

import numpy as np
import torch

from .io import native
from .io.sam import SamHeader
from .sortdup import driver as sddriver
from .utils.profiling import PROF

_STOP = object()


class Prefetcher:
    """Run an iterator in a thread with a bounded queue (pipeline depth
    = the reference's 2 in-flight kt_pipeline batches)."""

    def __init__(self, it, depth: int = 2):
        self._q = queue.Queue(maxsize=depth)
        self._err = None
        self._done = False

        def run():
            try:
                for item in it:
                    self._q.put(item)
            except BaseException as e:          # surfaced in __next__
                self._err = e
            finally:
                self._q.put(_STOP)

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:                 # iterator protocol: stay stopped
            raise StopIteration
        item = self._q.get()
        if item is _STOP:
            self._done = True
            self._t.join()
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item


class LineWriter:
    """Drain SAM lines to a file object on a writer thread."""

    def __init__(self, write, depth: int = 4):
        self._q = queue.Queue(maxsize=depth)
        self._err = None

        def run():
            while True:
                lines = self._q.get()
                if lines is _STOP:
                    return
                if self._err is not None:
                    continue               # drain: keep producers moving
                try:
                    for ln in lines:
                        write(ln)
                except BaseException as e:  # re-raised by put()/close()
                    self._err = e

        self._t = threading.Thread(target=run, daemon=True)
        self._t.start()

    def put(self, lines):
        if self._err is not None:
            raise self._err
        self._q.put(lines)

    def close(self):
        self._q.put(_STOP)
        self._t.join()
        if self._err is not None:
            raise self._err


def overlapped_regs(aligner, batch_iter, depth: int = 2,
                    sync_retry: bool = True):
    """Generator keeping `depth` device align dispatches queued ahead of
    the host-side conversion, so the host finalizes batch i while later
    batches are queued on the device. With sync_retry=False overflowed
    reads come back unescalated (the caller defers them).

    Yields (names, seqs, quals, regs_np, id0); id0 counts reads."""
    pending = collections.deque()
    n = 0
    for names, seqs, quals in batch_iter:
        pending.append((names, seqs, quals,
                        aligner._device_regs_async(seqs), n))
        n += len(names)
        if len(pending) > depth:
            nm, sq, ql, rd, i0 = pending.popleft()
            with PROF.phase("REG_SYNC"):
                regs_np = aligner._regs_to_np(rd, sq if sync_retry
                                              else None)
            yield nm, sq, ql, regs_np, i0
    while pending:
        nm, sq, ql, rd, i0 = pending.popleft()
        with PROF.phase("REG_SYNC"):
            regs_np = aligner._regs_to_np(rd, sq if sync_retry else None)
        yield nm, sq, ql, regs_np, i0


def stream_mem(aligner, batch_iter, write_line, paired: bool = False,
               depth: int = 2, progress=None):
    """3-stage overlapped `mem`: prefetched batches -> align -> writer
    thread. Returns total reads aligned."""
    n = 0
    writer = LineWriter(write_line, depth=2 * depth)
    try:
        for nm, sq, ql, regs_np, i0 in overlapped_regs(
                aligner, Prefetcher(batch_iter, depth), depth):
            writer.put(aligner.finalize_batch(nm, sq, ql, regs_np, i0,
                                              paired=paired))
            n = i0 + len(nm)
            if progress is not None:
                progress(n)
    finally:
        writer.close()
    return n


class StreamingSortMarkdup:
    """sormadup with streamed ingest: pass-1 parse runs on a worker
    thread per fed chunk; finish() runs the global dup scan + sort +
    encode (the reference's reader/shuffle-vs-sort split) on `device`."""

    def __init__(self, header_lines, out_bam_path, compress_level: int = 6,
                 device=None):
        import tempfile

        from .utils.device import resolve_device

        self.device = resolve_device(device)
        self.header_lines = [ln.rstrip("\n") for ln in header_lines]
        self.header = SamHeader.parse(self.header_lines)
        self.out_bam_path = out_bam_path
        self.compress_level = compress_level
        self._q = queue.Queue(maxsize=4)
        # chunk text spills to disk (pass-2 re-reads it via mmap, the
        # same larger-than-RAM design as sort_markdup_file): resident
        # state is the numeric key arrays only
        self._spill = tempfile.NamedTemporaryFile(prefix="fgdp_sd_")
        self._spill_off = 0
        self._chunks = []          # (base_offset, parsed, rid, pair_id)
        self._holdback = ""        # lines sharing the last QNAME
        self._err = None
        self._t = threading.Thread(target=self._run, daemon=True)
        self._t.start()

    # ---- worker ----
    def _run(self):
        while True:
            chunk = self._q.get()
            if chunk is _STOP:
                return
            if self._err is not None:
                continue                   # drain: keep the producer moving
            try:
                buf = chunk.encode()
                parsed = native.parse_sam_numeric(buf, buf.count(b"\n") + 1)
                rid, pair_id = native.assign_rid_pairid(buf, parsed,
                                                        self.header.names)
                self._spill.write(buf)
                self._chunks.append((self._spill_off, parsed, rid, pair_id))
                self._spill_off += len(buf)
            except BaseException as e:     # re-raised by feed()/finish()
                self._err = e

    # ---- producer API ----
    def feed(self, lines):
        """Feed SAM body lines (no header). Splits on QNAME boundaries
        so mates stay within one parse unit (main.cpp:532-544)."""
        if self._err is not None:
            raise self._err
        body = [ln.rstrip("\n") for ln in lines
                if ln and not ln.startswith("@")]
        if not body:
            return
        last_qn = body[-1].split("\t", 1)[0]
        cut = len(body)
        while cut > 0 and body[cut - 1].split("\t", 1)[0] == last_qn:
            cut -= 1
        text = self._holdback + "".join(ln + "\n" for ln in body[:cut])
        self._holdback = "".join(ln + "\n" for ln in body[cut:])
        if text:
            self._q.put(text)

    def finish(self):
        """Returns (n_records, n_dup_pairs); writes BAM + BAI."""
        if self._holdback:
            self._q.put(self._holdback)
            self._holdback = ""
        self._q.put(_STOP)
        self._t.join()
        if self._err is not None:
            raise self._err
        if not self._chunks:
            self._spill.close()
            return sddriver.sort_markdup(self.header_lines,
                                         self.out_bam_path,
                                         self.compress_level, self.device)
        # merge chunk arrays; shift byte offsets and pairIDs
        bases, parsed_list, rids, pids = zip(*self._chunks)
        off_keys = ("line_start", "line_end", "qn_start", "qn_end",
                    "rn_start", "rn_end")
        merged = {}
        for k in parsed_list[0]:
            parts = [p[k] + (bases[i] if k in off_keys else 0)
                     for i, p in enumerate(parsed_list)]
            merged[k] = np.concatenate(parts)
        pid_out, pid_base = [], 0
        for p in pids:
            p = np.asarray(p, np.int64)
            pid_out.append(np.where(p > 0, p + pid_base, 0))
            pid_base += int(p.max(initial=0))
        rid = np.concatenate(rids)
        pair_id = np.concatenate(pid_out)
        import ctypes
        import mmap as mmap_mod

        self._spill.flush()
        try:
            with mmap_mod.mmap(self._spill.fileno(), 0,
                               access=mmap_mod.ACCESS_COPY) as mm:
                buf = (ctypes.c_char * len(mm)).from_buffer(mm)
                res = sddriver._native_pass2(
                    buf, merged, rid, pair_id, self.header,
                    self.out_bam_path, self.compress_level, self.device)
                del buf        # release the exported buffer before close
            return res
        finally:
            self._spill.close()


class _DeferredEscalation:
    """Escalated-read pool for the sort-bound stream: overflowed reads
    are pulled out of their batch and re-run through the escalation
    ladder in ONE widened launch per `cap` reads, instead of one
    serialized launch per overflowing batch. Legal only when the
    downstream re-sorts (the coordinate sort destroys read order); the
    SAM-order `mem` path keeps the synchronous per-batch retry.
    Original global read ids ride along so the hash_64 dedup/primary
    tie-breaks produce the same records and dup flags as the sync path;
    record ORDER within a tied unified coordinate may differ (the
    coordinate sort breaks ties by stream-arrival index, and deferred
    reads arrive at the stream tail — sortdup/engine.py
    coordinate_sort_order)."""

    def __init__(self, aligner, cap: int = 0):
        self.aligner = aligner
        self.cap = cap or aligner.shapes.batch_reads
        self.rows = []          # (name, seq, qual, gid, {field: row})

    def split(self, nm, sq, ql, regs_np, i0):
        """Strip overflowed reads from the batch into the pool; returns
        the kept (names, seqs, quals, regs_np, ids) or None."""
        ovf = np.asarray(regs_np["overflow"])
        if not ovf.any():
            return nm, sq, ql, regs_np, i0 + np.arange(len(nm))
        for b in np.flatnonzero(ovf):
            self.rows.append((nm[b], sq[b], ql[b] if ql else None,
                              i0 + int(b),
                              {k: v[b] for k, v in regs_np.items()}))
        keep = np.flatnonzero(~ovf)
        if len(keep) == 0:
            return None
        return ([nm[b] for b in keep], [sq[b] for b in keep],
                [ql[b] for b in keep] if ql else None,
                {k: v[keep] for k, v in regs_np.items()}, i0 + keep)

    def flush_one(self, count: int):
        """Escalate + return the oldest `count` pooled reads as a
        (names, seqs, quals, regs_np, ids) batch (device launch here)."""
        rows, self.rows = self.rows[:count], self.rows[count:]
        nm = [r[0] for r in rows]
        sq = [r[1] for r in rows]
        ql = [r[2] for r in rows]
        if all(q is None for q in ql):
            ql = None
        ids = np.asarray([r[3] for r in rows])
        regs_np = {k: np.stack([r[4][k] for r in rows])
                   for k in rows[0][4]}
        return nm, sq, ql, self.aligner._retry_overflow(regs_np, sq), ids


def stream_fastq_to_bam(aligner, batch_iter, out_bam_path,
                        paired: bool = False, compress_level: int = 6,
                        depth: int = 2, progress=None, pool=None):
    """Aligner stage piped straight into the streaming sormadup — the
    inter-program pipe of the reference, without materialized SAM. The
    sort runs on the aligner's device.

    With `pool` (a FinalizePool), host SAM finalization fans out to
    worker processes while the device aligns ahead — the full
    three-program overlap (align / finalize / sort+markdup) in one
    process tree. Returns (reads, (n_records, n_dup_pairs))."""
    sd = StreamingSortMarkdup(list(aligner.sam_header()), out_bam_path,
                              compress_level, aligner.device)
    n = 0
    # SE only: PE pairing computes the insert-size stats per finalize
    # cohort, so pulling pairs out of their batch would perturb pestat
    # for the rest of the batch; PE keeps the synchronous retry
    defer = None if paired else _DeferredEscalation(aligner)

    def batches():
        nonlocal n
        for nm, sq, ql, regs_np, i0 in overlapped_regs(
                aligner, Prefetcher(batch_iter, depth), depth,
                sync_retry=defer is None):
            n = i0 + len(nm)
            if defer is None:
                yield nm, sq, ql, regs_np, i0
                continue
            kept = defer.split(nm, sq, ql, regs_np, i0)
            if kept is not None:
                yield kept
            while len(defer.rows) >= defer.cap:
                yield defer.flush_one(defer.cap)
        while defer is not None and defer.rows:
            yield defer.flush_one(defer.cap)

    if pool is None:
        for nm, sq, ql, regs_np, ids in batches():
            sd.feed(aligner.finalize_batch(nm, sq, ql, regs_np, ids,
                                           paired=paired))
            if progress is not None:
                progress(n)
    else:
        pending = collections.deque()
        for nm, sq, ql, regs_np, ids in batches():
            with PROF.phase("POOL_SUBMIT"):
                pending.append(pool.submit(nm, sq, ql, regs_np, ids,
                                           paired))
            while len(pending) > depth:
                with PROF.phase("POOL_WAIT"):
                    lines = pool.collect(pending.popleft())
                with PROF.phase("SORT_FEED"):
                    sd.feed(lines)
            if progress is not None:
                progress(n)
        while pending:
            with PROF.phase("POOL_WAIT"):
                lines = pool.collect(pending.popleft())
            with PROF.phase("SORT_FEED"):
                sd.feed(lines)
    with PROF.phase("SORT_FINISH"):
        out = sd.finish()
    return n, out


# ----------------------------------------------------------------------
# Finalize worker pool: the host-side SAM finalization (pure-Python
# CIGAR/MD/tag work) is spread over worker processes, as the reference
# spreads it over its worker_sam kt_for team (src/bwamem.cpp:1845).
# Spawned processes each load the packed reference from the index
# artifact and run pipeline.finalize_se_batch, which never touches the
# card, or pipeline.finalize_pe_batch, whose mate rescue runs on the
# pool's device: a paired-end pool on the card has its workers open the
# card (spawned processes may) and launch the kswv kernel there.
# ----------------------------------------------------------------------

_W_PREF = None
_W_OPT = None
_W_DEVICE = None
# the paired-end workers' kswv work, summed over the batches the pools'
# collect() returned: launches, jobs, DP cells, and the kernel ms of the
# CUDA events the kernel's C entry point records around each launch (0
# unless the pool's caller asked for events)
POOL_KSWV = {"launches": 0, "jobs": 0, "cells": 0, "ms": 0.0}


def _worker_warm(dt):
    import time
    time.sleep(dt)
    return 0


def _finalize_worker_init(pref_path, opt, device, timed=False):
    """Load the reference; with a CUDA `device`, open the card and bind
    the kswv kernel the parent built (raises when the card cannot be
    opened: a paired-end batch never falls back to the CPU), and record
    events around its launches when `timed`."""
    global _W_PREF, _W_OPT, _W_DEVICE
    from .index.reference import PackedReference
    from .ops import kernels

    _W_PREF = PackedReference.load(pref_path)
    _W_OPT = opt
    _W_DEVICE = None if device is None else torch.device(device)
    if _W_DEVICE is not None and _W_DEVICE.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"finalize worker: cannot open {_W_DEVICE}:"
                               " no CUDA device is available")
        torch.zeros(1, device=_W_DEVICE)
        kernels.load("kswv")
        if timed:
            kernels.TIMED["kswv"] = []


def _finalize_worker_run(args):
    """(SAM lines, this batch's work): the seconds of this call, `s`, and
    for a paired-end batch its kswv work."""
    import time

    from . import pipeline as pipemod
    from .ops import kernels, kswv

    t0 = time.perf_counter()
    names, seqs, quals, regs_np, id0, paired = args
    if not paired:
        lines = pipemod.finalize_se_batch(_W_PREF, _W_OPT, None, names,
                                          seqs, quals, regs_np, id0)
        return lines, dict(s=time.perf_counter() - t0)
    l0, w0 = kernels.LAUNCHES["kswv"], dict(kswv.WORK)
    lines = pipemod.finalize_pe_batch(_W_PREF, _W_OPT, names, seqs, quals,
                                      regs_np, id0, _W_DEVICE)
    timed = kernels.TIMED.get("kswv", [])
    work = dict(launches=kernels.LAUNCHES["kswv"] - l0,
                jobs=kswv.WORK["jobs"] - w0["jobs"],
                cells=kswv.WORK["cells"] - w0["cells"],
                ms=sum(s.elapsed_time(e) for s, e in timed))
    timed.clear()
    work["s"] = time.perf_counter() - t0
    return lines, work


class FinalizePool:
    """Process pool for finalize; submission order is delivery order.
    `device` is the device of paired-end batches' mate rescue (the
    aligner's); a pool without one finalizes single-end batches only.
    With the card as `device`, the kernels are built here, before the
    workers start, and each worker opens the card; the workers record
    events around their kswv launches if the caller had asked for them
    (`kernels.TIMED["kswv"]`) when it built the pool."""

    def __init__(self, pref_path: str, opt, workers: int, device=None):
        import concurrent.futures
        import multiprocessing

        from .ops import kernels

        self.device = None if device is None else torch.device(device)
        if self.device is not None and self.device.type == "cuda":
            kernels.build()
        self._ex = concurrent.futures.ProcessPoolExecutor(
            max_workers=workers, mp_context=multiprocessing.get_context(
                "spawn"),
            initializer=_finalize_worker_init,
            initargs=(pref_path, opt, self.device,
                      "kswv" in kernels.TIMED))
        # force every worker to spawn now (spawn is lazy)
        list(self._ex.map(_worker_warm, [0.2] * workers))

    def submit(self, names, seqs, quals, regs_np, id0, paired=False):
        if paired and self.device is None:
            raise ValueError("FinalizePool: paired-end batches need the "
                             "pool's device for mate rescue")
        seqs = [np.asarray(s) for s in seqs]
        return self._ex.submit(_finalize_worker_run,
                               (names, seqs, quals, regs_np, id0, paired))

    @staticmethod
    def collect(fut):
        """The SAM lines of a submitted batch; the worker's seconds on it
        are added to PROF's POOL_WORK, its kswv work to POOL_KSWV."""
        lines, work = fut.result()
        PROF.add("POOL_WORK", work.pop("s"))
        for k, v in work.items():
            POOL_KSWV[k] += v
        return lines

    def shutdown(self):
        self._ex.shutdown()


def stream_mem_pooled(aligner, batch_iter, write_line, pool: FinalizePool,
                      paired: bool = False, depth: int = 3, progress=None):
    """stream_mem with finalize fanned out to worker processes. The
    device stays busy while N workers chew the Python SAM work; lines
    are written in submission order."""
    writer = LineWriter(write_line, depth=2 * depth)
    pending = collections.deque()
    n = 0
    try:
        for nm, sq, ql, regs_np, i0 in overlapped_regs(
                aligner, Prefetcher(batch_iter, depth), depth):
            with PROF.phase("POOL_SUBMIT"):
                pending.append(pool.submit(nm, sq, ql, regs_np, i0,
                                           paired))
            n = i0 + len(nm)
            while len(pending) > depth:
                with PROF.phase("POOL_WAIT"):
                    lines = pool.collect(pending.popleft())
                writer.put(lines)
            if progress is not None:
                progress(n)
        while pending:
            with PROF.phase("POOL_WAIT"):
                lines = pool.collect(pending.popleft())
            writer.put(lines)
    finally:
        writer.close()
    return n
