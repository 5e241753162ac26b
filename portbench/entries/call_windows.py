"""Driver of the port's somatic caller, call.engine.Mutect2Engine
.call_windows: one window of a tumor/normal exome slice per target,
active regions assembled and genotyped by the region workers, PairHMM
batched across regions onto the card (kernel P3).

Set-up: the configuration's genome (from the index cache), the slice's
targets, variants and read bases drawn from --seed (lib/somatic.py), the
engine and its region pool (BQSR and the CNN gate off), and one target
of other reads of the same seed through the engine (warm-up). The window
then feeds targets in order until --seconds have passed and closes when
every region in flight is called. A spy on
ops.pairhmm.compute_log_likelihoods_async keeps a sample of the pairs
each launch computes (drawn from the seed) with the program's
likelihoods for them, and counts every launch's DP cells.

Cell parameters: workers (region workers, or "cpu-1", at most 8),
hmm_sample (pairs the reference recomputes), profile ([s into the window,
s long] of the traced run's device trace).
"""

from __future__ import annotations

import os
import types

import numpy as np

from lib import index_cache, somatic
from lib.harness import RunFailed, Stopwatch, log, process_age_s

# pairs kept a launch, before the final draw of `hmm_sample`
KEEP_A_LAUNCH = 64


class PairSpy:
    """Wraps the PairHMM dispatch: counts pairs and DP cells, keeps a
    seeded sample of each launch's pairs and the likelihoods the program
    returns for them."""

    def __init__(self, inner, seed):
        self.inner = inner
        self.rng = np.random.default_rng([seed % (1 << 64), 5])
        self.active = False
        self.launches = self.pairs = self.cells = 0
        self.kept = []

    def __call__(self, reads, rlens, q, iq, dq, cq, haps, hlens, device):
        collect = self.inner(reads, rlens, q, iq, dq, cq, haps, hlens,
                             device)
        if not self.active:
            return collect
        NP = len(rlens)
        self.launches += 1
        self.pairs += NP
        self.cells += int(np.dot(np.asarray(rlens, np.int64),
                                 np.asarray(hlens, np.int64)))
        pick = self.rng.choice(NP, min(KEEP_A_LAUNCH, NP), replace=False)
        args = tuple(np.array(a[pick]) for a in
                     (reads, rlens, q, iq, dq, cq, haps, hlens))

        def wrapped():
            out = collect()
            self.kept.append(args + (np.array(out[pick]),))
            return out
        return wrapped


def run(ctx):
    import torch
    from fgdp_tpu_torch.call.engine import Mutect2Engine, _ReadIndex
    from fgdp_tpu_torch.ops import kernels, pairhmm

    p = ctx.params
    clock = Stopwatch("set-up")
    idx = index_cache.ensure(ctx.config)
    genome = index_cache.genome(idx)
    clock.lap("genome")
    sl = somatic.draw(genome, ctx.seed, 0, ctx.mix)
    warm = somatic.draw(genome, ctx.seed, 1, ctx.mix, n_targets=1)
    clock.lap("slice")
    w = p["workers"]
    workers = min((os.cpu_count() or 2) - 1, 8) if w == "cpu-1" else int(w)
    eng = Mutect2Engine(genome, ctx.config["contig"],
                        region_workers=workers, device=ctx.device)
    spy = PairSpy(pairhmm.compute_log_likelihoods_async, ctx.seed)
    pairhmm.compute_log_likelihoods_async = spy
    tr = ctx.tracer
    if tr is not None:
        from fgdp_tpu_torch.call.engine import PairHMMBatcher
        tr.patch(PairHMMBatcher, "flush", "hmm_flush", tick=True)
        tr.patch(Mutect2Engine, "_dispatch_region", "dispatch")

    def windows(s, targets, seed):
        for t in targets:
            lo, hi = s.window(t)
            yield (lo, hi, _ReadIndex(s.read_dicts(t, "tumor", seed)),
                   _ReadIndex(s.read_dicts(t, "normal", seed)))

    w = ctx.window
    try:
        eng.call_windows(windows(warm, [0], ctx.seed + 1))
        clock.lap("engine and warm-up")
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
            torch.cuda.reset_peak_memory_stats(ctx.device)
        if tr is not None:
            tr.open(kernels=("pairhmm",), profile=p["profile"],
                    seconds=ctx.args.seconds)
        spy.active = True
        setup_s = process_age_s()
        w.open()
        calls = eng.call_windows(w.feed(
            windows(sl, range(len(sl.starts)), ctx.seed), lambda _: 1))
        if ctx.device.type == "cuda":
            torch.cuda.synchronize(ctx.device)
        w.close()
        spy.active = False
        regions = eng.n_regions
    finally:
        pairhmm.compute_log_likelihoods_async = spy.inner
        eng.close()
    if tr is not None:
        tr.close(regions, w.length, "regions")
        tr.counters.update(hmm_pairs=spy.pairs, hmm_cells=spy.cells,
                           hmm_launches=spy.launches)
    if regions == 0:
        raise RunFailed("no active region in the window")
    peak = torch.cuda.max_memory_allocated(ctx.device) \
        if ctx.device.type == "cuda" else 0
    kind = torch.cuda.get_device_name(ctx.device) \
        if ctx.device.type == "cuda" else "cpu"
    log(f"[window] {w.fed} targets, {regions} active regions in "
        f"{w.length:.3f} s = {regions / w.length:.3f} regions/s; set-up "
        f"{setup_s:.3f} s; PairHMM {spy.launches} launches, {spy.pairs} "
        f"pairs, {spy.cells} cells, kernel launches "
        f"{kernels.LAUNCHES['pairhmm']}")
    return types.SimpleNamespace(
        unit="regions", fed_unit="targets", metrics={"regions_per_s": regions / w.length,
                                 "setup_s": setup_s},
        memory_peak_bytes=int(peak), device_kind=kind, genome=genome,
        slice=sl, calls=calls, fed=w.fed, pairs=spy.kept)
