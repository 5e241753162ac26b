"""What the alignment entries share: the port's aligner over the cached
index, the run's reads as FASTQ, the finalize pool, the traced run's
spans, and the window itself."""

from __future__ import annotations

import os
import types

from . import index_cache
from . import reads as readsmod
from .harness import RunFailed, log, process_age_s

# the kernels whose event pairs the traced run sums: the seeding engines
# (LCP: K1-K3; sweep: D9, D10 and K3) and extension (P1)
TIMED_KERNELS = ("smem_lcp", "k2_lcp", "seed_strategy", "sweep_fwd",
                 "sweep_bwd", "sw_extend")


def workers(ctx) -> int:
    """The finalize pool's size: a number, or "cpu-1" for one fewer
    than the host's cores."""
    w = ctx.params["workers"]
    return max((os.cpu_count() or 2) - 1, 1) if w == "cpu-1" else int(w)


def aligner(ctx, idx):
    """The port's aligner as its users build it: the CLI's load_aligner
    for the LCP engine (which finds index.lcp.npz), Aligner(lcp=False)
    for the sweep engine of the port's human-scale path."""
    from fgdp_tpu_torch import cli
    from fgdp_tpu_torch.config import BatchShapes
    from fgdp_tpu_torch.index.fmindex import FMIndex
    from fgdp_tpu_torch.index.reference import PackedReference
    from fgdp_tpu_torch.pipeline import Aligner

    prefix = index_cache.prefix(idx)
    batch = ctx.params["batch"]
    engine = ctx.config["engine"]
    if engine == "lcp":
        return cli.load_aligner(prefix, batch, device=ctx.device)
    if engine == "sweep":
        return Aligner(PackedReference.load(prefix + ".ref"),
                       FMIndex.load(prefix + ".fmi"),
                       shapes=BatchShapes(batch_reads=batch), lcp=False,
                       device=ctx.device)
    raise RunFailed(f"unknown seeding engine {engine!r}")


def simulate(ctx, genome):
    """The window's reads and the warm-up's (other reads of the same
    seed), written as FASTQ under the run's scratch directory. Returns
    (window reads, window FASTQs, warm-up FASTQs)."""
    mix = ctx.mix
    out = {}
    for stream, tag, n in ((0, "", mix["reads"]),
                           (1, "warm", ctx.params["batch"])):
        if mix["kind"] == "se":
            r = readsmod.single_end(genome, n, ctx.seed, stream, mix,
                                    prefix=tag + "s")
            paths = [os.path.join(ctx.tmp, tag + "r.fq")]
            readsmod.write_fastq(paths[0], r)
        elif mix["kind"] == "pe":
            r1, r2, bait = readsmod.paired_end(genome, n // 2, ctx.seed,
                                               stream, mix,
                                               prefix=tag + "p")
            r = (r1, r2, bait)
            paths = [os.path.join(ctx.tmp, tag + f"r{e}.fq")
                     for e in (1, 2)]
            readsmod.write_fastq(paths[0], r1)
            readsmod.write_fastq(paths[1], r2)
        else:
            raise RunFailed(f"unknown traffic kind {mix['kind']!r}")
        out[stream] = (r, paths)
    return out[0][0], out[0][1], out[1][1]


def trace_spans(tracer):
    """The traced run's spans around the port's layers: the device
    program's dispatch (which also starts and stops the profiler: the
    main thread calls it once a batch), its results' way to the host,
    the escalation ladder, the finalize pool and the streaming sort."""
    from fgdp_tpu_torch import pipeline_stream as ps
    from fgdp_tpu_torch.pipeline import Aligner
    tracer.patch(Aligner, "_device_regs_async", "dispatch", tick=True)
    tracer.patch(Aligner, "_regs_to_np", "regs_to_host")
    tracer.patch(Aligner, "_retry_overflow", "ladder")
    tracer.patch(ps.FinalizePool, "submit", "pool_submit")
    tracer.patch(ps.FinalizePool, "collect", "pool_wait", static=True)
    tracer.patch(ps.StreamingSortMarkdup, "feed", "sort_feed")
    tracer.patch(ps.StreamingSortMarkdup, "finish", "sort_finish")


def measure(ctx, al, stream, batches):
    """Open the window, run `stream(batches fed through the window)`,
    close it once the stream has drained. Returns the run's record."""
    import torch

    tr = ctx.tracer
    w = ctx.window
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
        torch.cuda.reset_peak_memory_stats(ctx.device)
    esc0 = al.esc_reads
    if tr is not None:
        al.stage_ms, al.esc_stage_ms = {}, {}
        tr.open(kernels=TIMED_KERNELS, profile=ctx.params["profile"],
                seconds=ctx.args.seconds)
    setup_s = process_age_s()
    w.open()
    done = stream(w.feed(batches, lambda b: len(b[0])))
    if ctx.device.type == "cuda":
        torch.cuda.synchronize(ctx.device)
    w.close()
    if done != w.fed:
        raise RunFailed(f"the entry reports {done} reads, the window fed "
                        f"{w.fed}")
    if tr is not None:
        tr.close(w.fed, w.length, "reads", al)
        tr.counters["esc_reads"] = al.esc_reads - esc0
    peak = torch.cuda.max_memory_allocated(ctx.device) \
        if ctx.device.type == "cuda" else 0
    kind = torch.cuda.get_device_name(ctx.device) \
        if ctx.device.type == "cuda" else "cpu"
    log(f"[window] {w.fed} reads in {w.length:.3f} s = "
        f"{w.fed / w.length:.1f} reads/s; set-up {setup_s:.3f} s; "
        f"escalated {al.esc_reads - esc0}")
    return types.SimpleNamespace(
        unit="reads", fed_unit="reads", metrics={"reads_per_s": w.fed / w.length,
                               "setup_s": setup_s},
        memory_peak_bytes=int(peak), device_kind=kind)
