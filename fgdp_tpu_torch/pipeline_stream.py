"""Streaming stage overlap for `mem` — the kt_pipeline analogue.

The reference overlaps its aligner's stages with a 3-step pthread
pipeline (read chunk -> align -> write SAM) that keeps I/O off the
compute path (kt_pipeline, bwa-mem2-lcp/src/fastmap.cpp:191-368, two
in-flight batches). Here a prefetch thread decodes FASTQ while the
device aligns, and a writer thread drains SAM lines.

Port of the parts of the JAX package's pipeline_stream.py that
single-end `mem` uses; the sort/markdup streaming stages are not part of
the port yet.
"""

from __future__ import annotations

import queue
import threading

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


def overlapped_regs(aligner, batch_iter, depth: int = 2):
    """Generator keeping `depth` device align dispatches queued ahead of
    the host-side conversion, so the host finalizes batch i while later
    batches are queued on the device.

    Yields (names, seqs, quals, regs_np, id0); id0 counts reads."""
    import collections

    pending = collections.deque()
    n = 0
    for names, seqs, quals in batch_iter:
        pending.append((names, seqs, quals,
                        aligner._device_regs_async(seqs), n))
        n += len(names)
        if len(pending) > depth:
            nm, sq, ql, rd, i0 = pending.popleft()
            with PROF.phase("REG_SYNC"):
                regs_np = aligner._regs_to_np(rd, sq)
            yield nm, sq, ql, regs_np, i0
    while pending:
        nm, sq, ql, rd, i0 = pending.popleft()
        with PROF.phase("REG_SYNC"):
            regs_np = aligner._regs_to_np(rd, sq)
        yield nm, sq, ql, regs_np, i0


def stream_mem(aligner, batch_iter, write_line, depth: int = 2,
               progress=None):
    """3-stage overlapped single-end `mem`: prefetched batches -> align
    -> writer thread. Returns total reads aligned."""
    n = 0
    writer = LineWriter(write_line, depth=2 * depth)
    try:
        for nm, sq, ql, regs_np, i0 in overlapped_regs(
                aligner, Prefetcher(batch_iter, depth), depth):
            writer.put(aligner.finalize_batch(nm, sq, ql, regs_np, i0))
            n = i0 + len(nm)
            if progress is not None:
                progress(n)
    finally:
        writer.close()
    return n
