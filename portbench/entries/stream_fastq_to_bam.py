"""Driver of the port's `pipeline` entry,
pipeline_stream.stream_fastq_to_bam: FASTQ -> alignment -> the finalize
pool -> the streaming sort and duplicate marking -> a coordinate-sorted
BAM and its BAI under TMPDIR.

Set-up: the cached index, the aligner, the run's reads as FASTQ, the
finalize pool, and one batch of other reads of the same seed through the
whole path (warm-up). The window then streams the FASTQ until --seconds
have passed, ends the input, and closes when the BAM and BAI are
written.

Cell parameters: batch (reads a device batch), workers (the finalize
pool, or "cpu-1"), compress_level (BGZF), profile ([s into the window,
s long] of the traced run's device trace).
"""

from __future__ import annotations

import os
import types

from lib import aligners, index_cache
from lib.harness import Stopwatch


def run(ctx):
    from fgdp_tpu_torch import cli
    from fgdp_tpu_torch.pipeline_stream import (FinalizePool,
                                                stream_fastq_to_bam)

    p = ctx.params
    clock = Stopwatch("set-up")
    idx = index_cache.ensure(ctx.config)
    genome = index_cache.genome(idx)
    clock.lap("index")
    al = aligners.aligner(ctx, idx)
    clock.lap("aligner")
    reads, fq, warm_fq = aligners.simulate(ctx, genome)
    clock.lap("reads")
    if ctx.tracer is not None:
        aligners.trace_spans(ctx.tracer)
    pool = FinalizePool(index_cache.prefix(idx) + ".ref", al.opt,
                        aligners.workers(ctx)) if aligners.workers(ctx) \
        else None
    clock.lap("pool")
    bam = os.path.join(ctx.tmp, "out.bam")
    try:
        stream_fastq_to_bam(al, cli.read_batches(warm_fq, p["batch"]),
                            os.path.join(ctx.tmp, "warm.bam"),
                            compress_level=p["compress_level"], pool=pool)
        clock.lap("warm-up")

        def stream(batches):
            n, _ = stream_fastq_to_bam(al, batches, bam,
                                       compress_level=p["compress_level"],
                                       pool=pool)
            return n

        rec = aligners.measure(ctx, al, stream,
                               cli.read_batches(fq, p["batch"]))
    finally:
        if pool is not None:
            pool.shutdown()
    del al
    return types.SimpleNamespace(**vars(rec), genome=genome, reads=reads,
                                 fed=ctx.window.fed, bam=bam)
