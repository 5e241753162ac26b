"""Driver of the port's `mem -t` entry, pipeline_stream.stream_mem_pooled:
paired FASTQs -> alignment -> the finalize pool, whose workers open the
card for mate rescue (kswv) -> SAM under TMPDIR, in input order.

Set-up: the cached index, the aligner, the run's pairs as two FASTQs, the
finalize pool on the card, and one batch of other pairs of the same seed
through the whole path (warm-up). The window then streams the pairs
until --seconds have passed, ends the input, and closes when the last
SAM line is written.

Cell parameters: batch (reads a device batch, half as many pairs),
workers (the finalize pool, or "cpu-1"), profile ([s into the window, s
long] of the traced run's device trace).
"""

from __future__ import annotations

import os
import types

from lib import aligners, index_cache
from lib.harness import Stopwatch


def run(ctx):
    from fgdp_tpu_torch import cli
    from fgdp_tpu_torch.pipeline_stream import (FinalizePool,
                                                stream_mem_pooled)

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
                        aligners.workers(ctx), device=al.device)
    clock.lap("pool")
    sam = os.path.join(ctx.tmp, "out.sam")

    def to_sam(path, batches):
        with open(path, "w") as f:
            for ln in al.sam_header():
                f.write(ln + "\n")
            return stream_mem_pooled(al, batches,
                                     lambda ln: f.write(ln + "\n"), pool,
                                     paired=True)

    try:
        to_sam(os.path.join(ctx.tmp, "warm.sam"),
               cli.read_batches(warm_fq, p["batch"]))
        clock.lap("warm-up")
        rec = aligners.measure(ctx, al, lambda b: to_sam(sam, b),
                               cli.read_batches(fq, p["batch"]))
    finally:
        pool.shutdown()
    del al
    return types.SimpleNamespace(**vars(rec), genome=genome, reads=reads,
                                 fed=ctx.window.fed, sam=sam)
