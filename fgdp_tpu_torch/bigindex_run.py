"""Human-scale contig-sharded alignment on the card.

A synthetic genome of --contigs random contigs of --mb Mb each (default
10 x 128 Mb = 1.28 Gb, whose doubled text, 2.56 G positions, is past
what int32 addresses), one FM index a contig built by the native SA-IS in
--procs worker processes, and ShardedAligner(lcp=False,
shard_fms=...): every shard seeds on the sweep engine (D9, D10) with
int32 coordinates on the card, and the host merges the shards' regions
into int64 global coordinates (parallel/sharded_index.merge_shard_regs).

Checks, each exact: 32 forward reads planted in the last contig and 32
reverse complements of reads from the first contig align at their
contig, position and strand. A reverse-strand hit in shard s lands at rb
+ 2 l_pac - 2 l_s - off, so the first contig's reverse complements are
the plants whose merged rb lies past 2^31 (the last contig's forward
reads stay below it); the largest is printed. Then one timed batch of
reads drawn over every contig as bench.py's headline draws them.

    python -m fgdp_tpu_torch.bigindex_run [--contigs 10] [--mb 128]
        [--procs 3] [--device cuda|cpu] [--build-only]

Without a card it raises unless --device cpu is given. The shard files
live in a temporary directory that is removed at the end (about 1.8 GB a
128 Mb shard).
"""

from __future__ import annotations

import argparse
import os
import resource
import subprocess
import tempfile
import time

import numpy as np

L = 151
PLANTS = 32
# the kernels on the sweep `mem` path whose C entry points record CUDA
# events around each launch (ops/kernels.TIMED)
TIMED_KERNELS = {"sweep_fwd": "D9", "sweep_bwd": "D10",
                 "seed_strategy": "K3", "sw_extend": "P1",
                 "chain_loop": "P2", "chain_flt": "D5"}


def gen_contig(rng, n):
    """Random base + dispersed repeat family (Alu-ish density kept low:
    SA-IS timing is length-driven). Draws as fgdp_tpu's
    scripts/bigindex_run.py does, so a seed gives the same genome."""
    g = rng.integers(0, 4, n, dtype=np.uint8)
    alu = rng.integers(0, 4, 300, dtype=np.uint8)
    for _ in range(n // 100_000):
        p = int(rng.integers(0, n - 300))
        g[p:p + 300] = alu
    return g


def peak_rss_gib():
    """This process's peak resident set (getrusage's ru_maxrss), GiB. A
    new process starts from its parent's at the fork, exec or not."""
    return resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 2**20


def _build_shard(job):
    """Worker: one shard's FM index from its codes file, saved beside it.
    Returns (shard, build seconds, the worker's peak RSS in GiB, whether
    the build raised it above what the worker had when the job began,
    the build's traced peak of numpy allocations in bytes a text
    position: tracemalloc sees numpy's buffers, not the native SA-IS's
    own)."""
    import tracemalloc

    from .index.fmindex import FMIndex
    rss0 = peak_rss_gib()
    i, path, n = job
    codes = np.fromfile(path, np.uint8, count=n)
    tracemalloc.start()
    t0 = time.time()
    fm = FMIndex.build(codes)
    secs = time.time() - t0
    traced = tracemalloc.get_traced_memory()[1] / fm.text_len
    tracemalloc.stop()
    fm.save(path + ".fmi")
    rss = peak_rss_gib()
    return i, secs, rss, rss > rss0, traced


def build_shards(contigs, procs, tmp):
    """Every contig's FM index, built in `procs` workers (codes to a
    file, FMIndex.build, save) and loaded here. The workers fork from
    multiprocessing's fork server, a fresh interpreter that run() starts
    before it makes the genome, so their peak RSS is their own. Returns
    (indexes, then a shard each: build seconds, worker peak RSS GiB,
    whether the build set it, traced numpy peak B a text position; then
    the wall seconds and the bytes of the shard files)."""
    import concurrent.futures as cf
    import multiprocessing as mp

    from .index.fmindex import FMIndex
    from .io import native
    native.get_lib()              # built once here, not in every worker
    jobs = []
    for i, c in enumerate(contigs):
        path = os.path.join(tmp, f"c{i}.u8")
        c.tofile(path)
        jobs.append((i, path, len(c)))
    t0 = time.time()
    with cf.ProcessPoolExecutor(
            procs, mp_context=mp.get_context("forkserver")) as ex:
        done = sorted(ex.map(_build_shard, jobs))
    wall = time.time() - t0
    disk = sum(os.path.getsize(os.path.join(tmp, f))
               for f in os.listdir(tmp))
    fms = [FMIndex.load(path + ".fmi") for _, path, _ in jobs]
    return fms, *([d[k] for d in done] for k in (1, 2, 3, 4)), wall, disk


def plant_reads(contigs, seed=7):
    """(a) fgdp_tpu's script's 32 forward reads of the last contig (its
    rng(7) draws), then (b) 32 reverse complements of reads of the first
    contig (that rng's next draws). Returns (names, reads, truth), truth
    a (contig, 0-based position, reverse) a read."""
    rng = np.random.default_rng(seed)
    last = len(contigs) - 1
    pos = rng.integers(0, len(contigs[last]) - L, PLANTS)
    reads = [contigs[last][p:p + L].astype(np.int64) for p in pos]
    truth = [(last, int(p), False) for p in pos]
    pos = rng.integers(0, len(contigs[0]) - L, PLANTS)
    reads += [(3 - contigs[0][p:p + L][::-1]).astype(np.int64)
              for p in pos]
    truth += [(0, int(p), True) for p in pos]
    return [f"q{i}" for i in range(len(reads))], reads, truth


def sim_batch(pref, n_reads, seed=1):
    """bench.py's headline draw over the whole forward text: a start,
    1% substitutions, the reverse complement for half the reads. Returns
    (names, reads, truth) as plant_reads does."""
    rng = np.random.default_rng(seed)
    reads, truth = [], []
    for p in rng.integers(0, pref.l_pac - L, n_reads):
        c = pref.codes[p:p + L].copy()
        m = rng.random(L) < 0.01
        c[m] = rng.integers(0, 4, int(m.sum()))
        rev = bool(rng.random() < 0.5)
        if rev:
            c = 3 - c[::-1]
        rid = pref.pos2rid(int(p))
        reads.append(c.astype(np.int64))
        truth.append((rid, int(p - pref.offsets[rid]), rev))
    return [f"r{i}" for i in range(n_reads)], reads, truth


def misplaced(pref, lines, names, truth, tol):
    """Names of the reads whose primary record is not at its true contig
    and strand within `tol` bases of its true position."""
    want = dict(zip(names, truth))
    ok = set()
    for ln in lines:
        f = ln.split("\t")
        flag = int(f[1])
        if flag & 0x904:
            continue
        rid, p, rev = want[f[0]]
        if f[2] == pref.names[rid] and bool(flag & 16) == rev and \
                abs(int(f[3]) - (p + 1)) <= tol:
            ok.add(f[0])
    return [n for n in names if n not in ok]


def card_line():
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip()


def run(contigs=10, bp=128_000_000, procs=3, device=None, small=False,
        batch=4096, build_only=False, on_aligner=None, log=print):
    """The human-scale run: generate, build the shards in workers, align
    the plants (every one exact, or raise) and one timed batch of `batch`
    reads (none for 0). small=True allows a genome whose doubled text
    fits int32 (the tests' and the smoke run's sizes); on_aligner(al) is
    called with the ShardedAligner once it is built. Returns what it
    measured and aligned, the shard indexes and the reference."""
    from multiprocessing import forkserver

    import torch

    from .config import BatchShapes
    from .index.reference import PackedReference
    from .ops import kernels
    from .parallel.sharded_index import ShardedAligner
    from .pipeline import finalize_se_batch
    from .utils.device import resolve_device

    dev = resolve_device(device)
    if not small and not 2 * contigs * bp > 2**31:
        raise ValueError(f"{contigs} x {bp} bp is not human scale: the "
                         "doubled text must pass 2^31 (or pass small=True)")
    on_card = dev.type == "cuda"
    if on_card:
        log(f"[bigindex] card: {card_line()}; kernels built in "
            f"{kernels.build():.1f} s")
    out = {}
    forkserver.ensure_running()       # the builds' workers fork from it
    t0 = time.time()
    rng = np.random.default_rng(42)
    seqs = [gen_contig(rng, bp) for _ in range(contigs)]
    pref = PackedReference.from_contigs([f"c{i}" for i in range(contigs)],
                                        seqs)
    log(f"[bigindex] genome: {contigs} x {bp} bp = {pref.l_pac} bp, "
        f"doubled text {2 * pref.l_pac} = {2 * pref.l_pac / 2**31:.3f} x "
        f"2^31; made in {time.time() - t0:.1f} s")
    with tempfile.TemporaryDirectory(prefix="fgdp_bigindex_") as tmp:
        fms, secs, rss, own_peak, traced, wall, disk = build_shards(
            seqs, procs, tmp)
    own = peak_rss_gib()
    log(f"[bigindex] FM index a shard (native SA-IS + FMIndex.build) in "
        f"{procs} workers: seconds {[round(s, 1) for s in secs]} "
        f"(wall {wall:.1f} s, {pref.l_pac / wall / 1e6:.2f} Mb/s); numpy "
        f"peak of a build (tracemalloc) B a text position "
        f"{[round(t, 2) for t in traced]}; worker peak RSS GiB "
        + ", ".join(f"{r:.2f}" if o else f"<={r:.2f}"
                    for r, o in zip(rss, own_peak))
        + f" (<=: the build stayed below what the worker held when its job "
        f"began); this process's peak RSS {own:.2f} GiB; {disk} bytes of "
        f"shard files")
    out.update(pref=pref, fms=fms, build_s=secs, build_wall=wall,
               worker_rss=rss, traced=traced)
    if build_only:
        return out

    t0 = time.time()
    shapes = BatchShapes(read_len=L, batch_reads=max(batch, 2 * PLANTS))
    al = ShardedAligner(pref, n_shards=contigs, lcp=False, shard_fms=fms,
                        shapes=shapes, device=dev)
    if on_aligner is not None:
        on_aligner(al)
    if on_card:
        torch.cuda.synchronize()
        out["card_bytes"] = torch.cuda.memory_allocated()
    log(f"[bigindex] ShardedAligner(lcp=False), {len(al.shards)} shards "
        f"on {dev} in {time.time() - t0:.1f} s"
        + (f"; {out['card_bytes']} bytes on the card" if on_card else ""))

    # ---- the plants: exact positions, merged rb past 2^31 ----
    names, reads, truth = plant_reads(seqs)
    regs = al._device_regs(reads)           # align_batch's two steps
    lines = finalize_se_batch(pref, al.opt, al.shapes, names, reads, None,
                              regs, 0)
    bad = misplaced(pref, lines, names, truth, tol=0)
    rc = [i for i, t in enumerate(truth) if t[2]]
    rb = regs["rb"][rc][regs["valid"][rc]]
    max_rb = int(rb.max()) if rb.size else -1
    log(f"[bigindex] plants: {PLANTS} forward reads of c{contigs - 1} and "
        f"{PLANTS} reverse complements of c0: "
        f"{len(names) - len(bad)}/{len(names)} at their exact contig, "
        f"position and strand {bad[:4]}; merged rb {regs['rb'].dtype}, the "
        f"largest of the c0 plants' {max_rb} "
        f"({'past' if max_rb > 2**31 else 'not past'} 2^31 = {2**31})")
    out.update(plant_lines=lines, plant_names=names, plant_reads=reads,
               max_rb=max_rb)
    if bad or regs["rb"].dtype != np.int64 or \
            (not small and max_rb <= 2**31):
        raise AssertionError("a planted read is not at its exact global "
                             "position, or no merged rb passed 2^31")

    if not batch:
        return out

    # ---- one timed batch over every contig ----
    names, reads, truth = sim_batch(pref, batch)
    for sh in al.shards:
        sh.esc_reads = sh.esc_calls = 0
    before = dict(kernels.LAUNCHES)
    if on_card:
        for k in TIMED_KERNELS:
            kernels.TIMED[k] = []
        torch.cuda.synchronize()
    try:
        t0 = time.time()
        lines = al.align_batch(names, reads)
        wall = time.time() - t0
        if on_card:
            torch.cuda.synchronize()
            each = {k: [s.elapsed_time(e) for s, e in kernels.TIMED[k]]
                    for k in TIMED_KERNELS}
    finally:
        for k in TIMED_KERNELS:
            kernels.TIMED.pop(k, None)
    launches = {k: kernels.LAUNCHES[k] - before[k] for k in TIMED_KERNELS}
    off = misplaced(pref, lines, names, truth, tol=10)
    share = 1 - len(off) / batch
    log(f"[bigindex] timed batch: {batch} reads of {L} bp in {wall:.2f} s "
        f"= {batch / wall:.1f} reads/s (align_batch); {share:.4f} at their "
        f"true contig and strand within 10 bp; escalated reads a shard "
        f"{[sh.esc_reads for sh in al.shards]}, rung calls "
        f"{[sh.esc_calls for sh in al.shards]}")
    if on_card:
        ms = {k: sum(v) for k, v in each.items()}
        log("[bigindex] kernels in the timed batch (launches, summed ms "
            "from the events their C entry points record): " + ", ".join(
                f"{v} {k} {launches[k]}, {ms[k]:.3f} ms"
                for k, v in TIMED_KERNELS.items()))
        # the shards' primary programs run first, one after another, each
        # with a K1 and a K2 launch of D9 and of D10; the rungs follow
        n = len(al.shards)
        for k in ("sweep_fwd", "sweep_bwd"):
            log(f"[bigindex] {TIMED_KERNELS[k]} ({k}) ms of the primary "
                f"launches a shard, K1: "
                f"{[round(v, 4) for v in each[k][:2 * n:2]]}, K2: "
                f"{[round(v, 4) for v in each[k][1:2 * n:2]]}")
        out.update(kernel_ms=ms, kernel_each=each,
                   card_peak=torch.cuda.max_memory_allocated())
        log(f"[bigindex] bytes on the card: {out['card_bytes']} after "
            f"loading, peak {out['card_peak']}")
    log(f"[bigindex] this process's peak RSS {peak_rss_gib():.2f} GiB")
    out.update(batch_lines=lines, batch_names=names, batch_reads=reads,
               reads_per_s=batch / wall, share=share, launches=launches,
               esc=[(sh.esc_reads, sh.esc_calls) for sh in al.shards])
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m fgdp_tpu_torch.bigindex_run",
        description=__doc__.split("\n")[0])
    ap.add_argument("--contigs", type=int, default=10)
    ap.add_argument("--mb", type=int, default=128,
                    help="contig length, Mb")
    ap.add_argument("--procs", type=int, default=3,
                    help="worker processes building the shards")
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--build-only", action="store_true",
                    help="stop after the shard builds (their seconds and "
                         "peak RSS)")
    args = ap.parse_args(argv)
    run(args.contigs, args.mb * 1_000_000, args.procs, args.device,
        small=args.build_only, build_only=args.build_only)


if __name__ == "__main__":
    main()
