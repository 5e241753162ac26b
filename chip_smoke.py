#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (fgdp_tpu_torch) on one NVIDIA card.

Run from the repository root with no arguments:

    python3 chip_smoke.py

It needs one CUDA card and fails (non-zero exit, no result line) when
there is none or when the port is not beside it. Phases, each of which
fails loudly:
  1. card     name and power limit (nvidia-smi), torch and CUDA versions,
              the SM count and the maximum SM clock the bounds use
  2. build    the hand-written kernels from fgdp_tpu_torch/csrc (nvcc),
              ptxas' registers and stack frames; K3's, K1's one-lane, D9's
              and D10's kernels must keep no stack frame (cuobjdump
              -res-usage on their libraries)
  3. kernels  each kernel against its plain PyTorch version on the card
              at the main paths' shapes (seeded inputs; SW, chain loop
              and PairHMM exactly equal; PairHMM at the bench shape, a
              bucket, a batch that underflows into the f64 re-run, a
              launch as mutect_scale makes them and one on the wide
              path; the chain loop at its lane and chunk edges, the bench
              shape, an escalated one, the ladder's widest and the wide
              path, with its path, ms per step of the longest read and
              its serial bound; kswv exactly equal on rescue jobs made as
              pe_scale makes them, at the register path's lane edges, on
              the wide path and on a mostly empty batch, and its clocks a
              warp step from one warp an SM to all; the chain filter
              D5 exactly equal at C 1-384 under three option sets, at the
              ladder's (B, C) and on P2's bench output, with its ms, plain
              ms, bytes and serial bounds and ptxas' registers and stack
              frame); for SW, kswv
              and PairHMM also their warp rows and the SASS instructions of
              the row loops (of the chain loop's step loop), for SW each
              query-length class's share of its time
  4. golden   `index` + `mem` on the golden fixtures (single-end, and the
              pairs pe1.fq/pe2.fq), field-compared with the reference
              aligner's SAM like tests/test_golden.py
  5. ladder   a tight-capacity batch through every escalation rung on
              the card, equal to the port's CPU run
  6. scale    BASELINE config 1 at E. coli size: a 4.6 Mb repeat-rich
              reference (scripts/gen_genome.py's generator) and 8,192
              single-end 151 bp reads; launch counts, reads/s, per-stage
              ms, the SW, chain-loop and seeding kernels' summed time
              (CUDA events around every launch; the chain loop's by
              launch shape), peak device memory, and placement accuracy;
              every launch of the seeding kernels (K1 smem_lcp, K2
              k2_lcp, K3 seed_strategy) in the primary batches and in
              every rung held exactly against its plain version on its
              inputs; the seeding split of the first primary batch (K1,
              K2's jobs, K2, K3 and the final merge, each ended by a
              sync), the kernels against the torch-op loops in turns;
              each seeding kernel's ms on that batch, its bytes bound
              (the table bytes its lanes gather, counted by the kernel)
              and its serial bounds (a read alone on the kernel, and the
              design-independent one: the dependent-gather probe on the
              index, with the cheapest grid barrier a step for K1 and
              K2); K1's wave split (us a grid step by wave); every
              chain filter (D5) launch held
              exactly against its plain version, its launches and
              summed ms by (B, C); the chain split of the first primary
              batch (frac_rep, expand_seeds, P2, the weight and D5, each
              ended by a sync; D5's kernel against its torch ops in
              turns) and its filter ranks n_f; D5's ms, bounds and plain
              ms on that batch and on the widest rung launch
  7. mutect_golden  `mutect` on tests/golden/mutect on the card, held
              against the reference binary's golden.vcf by
              tests/test_golden_vcf.py's rules
  8. mutect_scale   BASELINE config 4's class on the same 4.6 Mb genome:
              300 planted somatic SNVs, 30x tumor at VAF 0.35 and 20x
              normal (scripts/mutect_campaign.py's generator), regions/s,
              PairHMM launches, pairs, cells and kernel ms (events the C
              entry point records around each launch), its launches by
              (R, H) bucket, the share of planted sites called, and the
              first 5 sites' calls equal to the port's CPU run
  9. probes   the S1 issue-rate probe (FP32 FMA chains and their INT32
              twin), the S2 row-gather probe and the dependent-gather
              probe (two 96-byte occ rows a hop): each kernel against its
              plain version (FP32 within rtol 1e-5, INT32, the gather and
              the chase exactly), then the probes' sweeps and the chase's
              latency, cold and warm; their measured rates
              replace the lane counts in the bounds where they are higher
              (runs first, before the kernels phase)
 10. sormadup_scale BASELINE config 3's class: a coordinate-shuffled SAM
              of 1,000,000 records (151 bp pairs with 10% planted
              duplicate pairs, singles, unmapped) on a chr20-length
              contig, through `sormadup` on the card and on the CPU: BAM
              and BAI byte-equal; records/s and the SD_* phase times
 11. pipeline_scale FASTQ -> sorted, duplicate-marked BAM through
              `pipeline -t min(cpu-1, 8)` on the card, on the scale
              phase's index and reads plus 819 planted duplicates:
              record count, coordinate order, the planted duplicates
              found, and the records equal to the `mem` SAM of the same
              reads, flags aside; reads/s end to end; the chain loop's
              and the seeding kernels' launches and summed kernel time
 12. pe_scale BASELINE config 2's class on the scale phase's index:
              8,192 simulated pairs of 2 x 151 bp (insert N(400, 40), both
              strands, sim_reads' errors, 5% of the pairs with one end
              baited: every 12th base changed, so only mate rescue places
              it) through `mem` in-process and the first 4,096 through
              `pipeline -t min(cpu-1, 8)` (the workers rescue on the
              card): pairs/s and reads/s, the seeding kernels' launches
              and kernel ms, kswv launches, jobs, cells and kernel ms
              (the workers' included),
              the (J, QP, TP) of the `mem` run's kswv launches, each held
              exactly against the plain version on its inputs, and kswv's
              timed case, bound and row-loop SASS on one of them,
              D5's launches and summed ms and the chain split of its
              first batch,
              the share properly paired, placement of confident ends and
              of the bait ends, the BAM's count and order, and the first
              128 pairs' SAM on the card equal to the port's CPU run
 13. mutect_options `mutect` on the 120x fixture tests/golden/mutect_cnn
              ungated (sites equal golden_nogate.vcf) and with
              --deep-model, a seeded TorchScript gate saved by the run
              (regions gated, kept and dropped, the forward's ms, every
              row's keep/drop decision and score equal to the CPU
              forward's on the same rows); then --bqsr-tumor/--bqsr-normal
              on tests/golden/mutect, the card's VCF equal to the port's
              CPU VCF
 14. sharded  the contig-sharded aligner (two shards of
              tests/test_sharded_index.py's 120 kb + 150 kb random
              contigs), 1,024 single-end reads and 1,024 pairs: SAM equal to the joint
              Aligner's on the card (a read the joint ladder leaves
              overflowed, where it differs, equal to the joint Aligner's
              on the batch without the other overflowed reads), reads/s
              of both, P1, P2 and D6 launches; ShardedAligner(lcp=False)
              (the sweep, no LCP tree) SAM equal to the lcp=True one's on
              every read and pair both its ladder and the joint one
              resolve (the lcp=True shards' merged flag marks nearly
              every read: each overflows in the other contig's shard);
              then NCCL at world
              size 1: sharded duplicate marking and coordinate sort of
              1,000,000 records' keys equal to the single-device engine;
              the 2-D (dp, fm) mesh: shard_index + shard_align_fn_2d on
              the single-end batch, packed regs equal to device_align's
 15. engines  the fallback seeding engines on the scale phase's index and
              its first 4,096 reads: collect_seeds on the sweep, the wave
              machine and LCP K1 + sweep K2 (FGDP_K2_SWEEP=1) against the
              LCP engine (ms a batch, overflowed reads, seeds equal on the
              reads neither flags); Aligner(lcp=False) `mem` with its
              ladder on all 8,192 scale reads (reads/s beside the LCP
              aligner's on the same batches, escalated reads, D9 sweep_fwd
              and D10 sweep_bwd launches and kernel ms, each launch held
              exactly against its torch-op loop, P1 and P2 launches and
              kernel ms), SAM equal to the LCP aligner's on the reads both
              ladders resolve, and the LCP aligner's align_batch (each
              batch's first read as id0) equal to scale's stream_mem on
              them; the sweep's seeding split of one primary
              batch (D9, flatten, D10, emit for K1 and K2, K3, merge,
              each ended by a sync; kernels against torch ops), D9's and
              D10's ms, bytes bound and serial bound (probes.chase); the
              FM index's and the LCP tree's bytes on the card a text
              position, and reckoned for a 3.1 Gb reference; the first
              256 reads' sweep SAM card vs CPU;
              exact_search and inexact_search (z = 1) on 4,096 patterns of
              read length, card vs CPU and against RMIndex.lookup_host
              (runs right after scale, whose index and reads it uses)
 16. bigindex the human-scale run's path (python -m
              fgdp_tpu_torch.bigindex_run) at a cut depth, 4 x 8 Mb
              contigs built by four worker processes: the plants on both
              strands at their exact positions, a batch of 4,096 reads
              (reads/s, share at the true position, escalations a shard,
              D9, D10, K3, P1, P2 and D5 launches and ms), every shard's
              primary D9 and D10 launches held exactly against their
              torch-op loops
Each phase starts the port's profiler (PROF) from zero. Then one JSON
line of the kernels, the card line, and the result line.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "golden")
# the card's published HBM rate (NVIDIA H100 SXM data sheet); the
# operation rates are lanes x SMs x the maximum SM clock
# (fgdp_tpu_torch.probes.card), or the probes' measured rates where higher
PEAK_BYTES = 3.35e12
MUTECT_SITES = 300
# the planted sites of mutect_scale's warm pass, run on the card and on
# the CPU: the CPU side is the slowest span of the earlier paths (about
# 3-4 s a site)
WARM_SITES = 5
# the seeding kernels of the LCP engine (K1, K2, K3), the kernels of
# `mem`'s path, of paired-end `mem`, and of `mem` on the sweep engine
SEED_KERNELS = ("smem_lcp", "k2_lcp", "seed_strategy")
MEM_KERNELS = ("chain_loop", "chain_flt", "sw_extend") + SEED_KERNELS
PE_KERNELS = MEM_KERNELS + ("kswv",)
SWEEP_KERNELS = ("chain_loop", "chain_flt", "sw_extend", "seed_strategy",
                 "sweep_fwd", "sweep_bwd")


def log(msg):
    print(msg, flush=True)


@contextlib.contextmanager
def phase_clock(name):
    """Log the wall seconds of one phase; the port's profiler starts
    each phase from zero, so a breakdown the CLI prints is the phase's
    own."""
    from fgdp_tpu_torch.utils.profiling import PROF
    PROF.reset()
    t0 = time.time()
    yield
    log(f"[time] {name}: {time.time() - t0:.1f} s")


# ------------------------------------------------------------------ data

def load_file(rel):
    """A module of the repository loaded from its path (scripts/ and
    tests/ are not packages)."""
    import importlib.util
    name = os.path.splitext(os.path.basename(rel))[0]
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


_GENOMES = {}


def gen_genome(n, seed=0):
    """Repeat-rich synthetic genome from scripts/gen_genome.py (isochore
    background, Alu-like and LINE-like families, microsatellites,
    segmental duplications); made once per run."""
    if (n, seed) not in _GENOMES:
        _GENOMES[n, seed] = load_file("scripts/gen_genome.py").generate(
            n, seed)
    return _GENOMES[n, seed]


def sim_reads(g, n_reads, L, seed=1):
    """Single-end reads from both strands: 1% substitutions, one short
    indel in a tenth of them. Names carry the true leftmost position."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_reads):
        p = int(rng.integers(0, len(g) - L - 8))
        s = read_errors(rng, g[p:p + L + 8].copy(), L)
        rev = rng.random() < 0.5
        if rev:
            s = (3 - s)[::-1]
        out.append((f"r{i}_{p + 1}_{'-' if rev else '+'}", s))
    return out


def read_errors(rng, s, L):
    """sim_reads' error model on the forward sequence s (L + 8 bases):
    one 1-3 base indel in a tenth of the reads, then 1% substitutions;
    returns the first L bases."""
    if rng.random() < 0.1:
        k = int(rng.integers(20, L - 20))
        d = int(rng.integers(1, 4))
        if rng.random() < 0.5:
            s = np.concatenate([s[:k], s[k + d:]])
        else:
            s = np.concatenate([s[:k], rng.integers(0, 4, d)
                                .astype(np.uint8), s[k:]])
    s = s[:L]
    m = rng.random(L) < 0.01
    s[m] = (s[m] + rng.integers(1, 4, int(m.sum()))) % 4
    return s


def bait(s):
    """Every 12th base changed: no exact run reaches the minimum seed
    length (19), so seeding finds nothing and only mate rescue can place
    the read (tests/test_pe_align.py's bait)."""
    s = s.copy()
    s[::12] = (s[::12] + 1) % 4
    return s


def sim_pairs(g, n_pairs, L, seed, mean=400, sd=40, baited=0.05):
    """Pairs of L bp reads from fragments of normal length (mean, sd),
    either end first (both strands), each end with sim_reads' errors; in
    a `baited` share of the pairs one end is baited. Returns
    [(name, r1, r2)]; the name carries the true leftmost positions of r1
    and r2 and which end is baited (0: none, 1 or 2)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_pairs):
        ins = max(int(rng.normal(mean, sd)), L)
        p = int(rng.integers(0, len(g) - ins - 8))
        q = p + ins - L
        left = read_errors(rng, g[p:p + L + 8].copy(), L)
        right = (3 - read_errors(rng, g[q:q + L + 8].copy(), L))[::-1]
        ends, pos = [left, right], [p + 1, q + 1]
        if rng.random() < 0.5:
            ends, pos = ends[::-1], pos[::-1]
        b = 0
        if rng.random() < baited:
            b = int(rng.integers(1, 3))
            ends[b - 1] = bait(ends[b - 1])
        out.append((f"p{i}_{pos[0]}_{pos[1]}_{b}", ends[0], ends[1]))
    return out


def write_fasta(path, name, codes):
    seq = np.frombuffer(b"ACGTN", np.uint8)[codes].tobytes().decode()
    with open(path, "w") as f:
        f.write(f">{name}\n")
        for i in range(0, len(seq), 80):
            f.write(seq[i:i + 80] + "\n")


def write_fastq(path, reads):
    lut = np.frombuffer(b"ACGTN", np.uint8)
    with open(path, "w") as f:
        for name, s in reads:
            f.write(f"@{name}\n{lut[s].tobytes().decode()}\n+\n"
                    f"{'I' * len(s)}\n")


def sw_inputs(seed, J, QP, TP):
    """Banded-SW jobs shaped like the main path's: empty, short and long
    lanes, targets that copy the query with a few errors (long
    extensions) or turn random part-way (z-drop), N bases; lanes sorted
    by query length as extend_chains sorts them."""
    rng = np.random.default_rng(seed)
    kind = rng.random(J)
    qlen = np.where(kind < 0.1, 0, np.where(
        kind < 0.55, rng.integers(1, 21, J),
        np.where(kind < 0.65, rng.integers(21, 100, J),
                 rng.integers(100, QP + 1, J)))).astype(np.int32)
    q = rng.integers(0, 4, (J, QP)).astype(np.int32)
    t = rng.integers(0, 4, (J, TP)).astype(np.int32)
    shift = rng.integers(0, 4, J)
    for j in range(4):
        rows = shift == j
        t[rows, j:j + QP] = q[rows]
    mis = rng.random((J, TP)) < 0.02
    t[mis] = rng.integers(0, 4, int(mis.sum()))
    zd = rng.random(J) < 0.15                       # copy stops: z-drop
    cut = rng.integers(10, QP, J)
    cols = np.arange(TP)[None, :]
    t = np.where(zd[:, None] & (cols >= cut[:, None]),
                 rng.integers(0, 4, (J, TP)), t)
    q[rng.random((J, QP)) < 0.005] = 4
    t[rng.random((J, TP)) < 0.005] = 4
    tlen = np.minimum(qlen + rng.integers(0, 2 * 100 + 1, J), TP)
    tlen[rng.random(J) < 0.03] = 0
    h0 = rng.integers(19, 80, J).astype(np.int32)
    order = np.argsort(qlen, kind="stable")
    return (q[order], qlen[order], t[order], tlen[order].astype(np.int32),
            h0[order])


def chain_inputs(seed, B, P, l_pac):
    """Chain-loop seed columns shaped like expand_seeds' output: per read
    a prefix of valid slots (most reads a few, repeat reads up to P),
    qbeg ascending, diagonal runs with jumps, contained repeats, both
    strands."""
    rng = np.random.default_rng(seed)
    nval = np.minimum(rng.geometric(0.08, B), P)
    nval[rng.random(B) < 0.02] = P
    qbeg = np.sort(rng.integers(0, 140, (B, P)), axis=1).astype(np.int32)
    diag = rng.integers(0, 2 * l_pac - 400, (B, 1))
    jump = rng.integers(0, 2 * l_pac - 400, (B, P))
    rbeg = np.where(rng.random((B, P)) < 0.6, diag + qbeg, jump)
    rbeg = (rbeg + rng.integers(-3, 4, (B, P))).clip(0).astype(np.int32)
    slen = rng.integers(19, 60, (B, P)).astype(np.int32)
    dup = rng.random((B, P)) < 0.2
    qbeg[:, 1:] = np.where(dup[:, 1:], qbeg[:, :-1], qbeg[:, 1:])
    rbeg[:, 1:] = np.where(dup[:, 1:], rbeg[:, :-1], rbeg[:, 1:])
    rid = (rbeg >= l_pac).astype(np.int32)
    valid = (np.arange(P)[None, :] < nval[:, None]) & \
        (rng.random((B, P)) < 0.95)
    ovf = rng.random(B) < 0.01
    return qbeg, rbeg, slen, rid, valid, ovf


def hmm_inputs(seed, NP, R, H, cq, full=False, hopeless=0.0):
    """PairHMM pairs as the batcher sends them: reads copied from their
    haplotype with 2% substitutions, base quals 10-40, ins/del quals 45,
    gap-continuation qual `cq` (>= 8: the scan depth caps at 6). `full`
    gives every pair R rows and H columns (the bench shape), else lengths
    are ragged down to half. `hopeless` is the share of reads with 40%
    mismatches at qual 40, whose f32 result underflows into the f64
    re-run.
    Returns the numpy arguments of compute_log_likelihoods_async."""
    rng = np.random.default_rng(seed)
    hl = np.full(NP, H) if full else rng.integers(H // 2, H + 1, NP)
    rl = np.full(NP, R) if full else rng.integers(R // 2, R + 1, NP)
    rl = np.minimum(rl, hl)
    haps = rng.integers(0, 4, (NP, H)).astype(np.int32)
    off = (rng.random(NP) * (hl - rl + 1)).astype(np.int64)
    cols = np.minimum(off[:, None] + np.arange(R)[None, :], H - 1)
    reads = np.take_along_axis(haps, cols, 1)
    sub = rng.random((NP, R)) < 0.02
    reads = np.where(sub, rng.integers(0, 4, (NP, R)), reads)
    bad = rng.random(NP) < hopeless
    flip = bad[:, None] & (rng.random((NP, R)) < 0.4)
    reads = np.where(flip, (reads + 1) % 4, reads)
    q = rng.integers(10, 41, (NP, R))
    q[bad] = 40
    live = np.arange(R)[None, :] < rl[:, None]
    reads = np.where(live, reads, 0).astype(np.int32)
    q = np.where(live, q, 0).astype(np.int32)
    iq = np.full((NP, R), 45, np.int32)
    return (reads, rl.astype(np.int32), q, iq, iq.copy(),
            np.full((NP, R), cq, np.int32), haps, hl.astype(np.int32))


# ------------------------------------------------------------ measuring

def max_abs_err(a, b):
    import torch
    err = 0
    for x, y in zip(a, b):
        if x.shape != y.shape:
            raise AssertionError(f"shape {tuple(x.shape)} != {tuple(y.shape)}")
        d = (x.to(torch.int64) - y.to(torch.int64)).abs()
        err = max(err, int(d.max()) if d.numel() else 0)
    return err


# ---------------------------------------------------------------- phases

def phase_card():
    """The card line and the operation rates the bounds are counted
    against: SMs x lanes x the maximum SM clock."""
    import torch
    from fgdp_tpu_torch.probes import card
    name, lanes = card()
    # warp instructions issued per second: 4 schedulers per SM, one each
    # per clock
    issue = lanes["sms"] * 4 * lanes["mhz"] * 1e6
    log(f"[card] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)}"
        f" x{torch.cuda.device_count()}; {lanes['sms']} SMs, max SM clock "
        f"{lanes['mhz']} MHz: FP32 {lanes['fp32'] / 1e12:.2f} T/s, INT32 "
        f"{lanes['int32'] / 1e12:.2f} T/s (an FMA counted once), "
        f"{issue / 1e12:.3f} T warp instructions/s")
    return name, dict(fp32=lanes["fp32"], int32=lanes["int32"], issue=issue,
                      mhz=lanes["mhz"])


# kernels that must keep no stack frame, in every function whose name
# holds the pattern: K3's every function, K1's one-lane kernels (R = 1,
# the only ones mem runs: more lanes a thread need more reads than the
# card holds threads), the sweep's D9 and D10
NO_STACK = {"seed_strategy": "", "smem_lcp": "ILi1E", "sweep_fwd": "",
            "sweep_bwd": ""}


def phase_build():
    from fgdp_tpu_torch.ops import kernels
    from fgdp_tpu_torch.probes import sass
    secs = kernels.build()
    log(f"[build] kernels built in {secs:.1f} s (all nvcc in parallel)")
    for name, rec in kernels.build_log.items():
        for ln in rec["log"].splitlines():
            if "registers" in ln or "spill" in ln or "Function prop" in ln:
                log(f"[build] {name}: {ln.strip()}")
    for name, pat in NO_STACK.items():
        # read from the built library, so a library built by an earlier
        # run is checked too
        frames = sass.stack_frames(name)
        log(f"[build] {name}: stack frames (cuobjdump -res-usage) {frames}")
        held = {f: v for f, v in frames.items() if pat in f}
        if not held or max(held.values()) != 0:
            raise AssertionError(f"{name} keeps a stack frame: {held}")
    for name in kernels.KERNELS:
        kernels.load(name)


def bound(nbytes, ops, rate):
    """(bound ms, what bounds it) for bytes over HBM and ops over rate."""
    t_bytes = 1e3 * nbytes / PEAK_BYTES
    t_ops = 1e3 * ops / rate
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def phase_kernels(dev, rates):
    """Each kernel against its plain version at main-path shapes."""
    import torch
    from fgdp_tpu_torch.config import AlignConfig, BatchShapes
    from fgdp_tpu_torch.ops import sw
    from fgdp_tpu_torch.probes import SW_OPS_PER_CELL, cuda_ms, wall_ms

    opt = AlignConfig()
    shp = BatchShapes(batch_reads=4096)
    rows = {}

    # --- banded SW: J = 4096 reads x 6 jobs, QP = 151, TP = 368 ---
    J = shp.batch_reads * 6
    QP, TP = shp.read_len, shp.max_ext_ref
    q, qlen, t, tlen, h0 = (torch.as_tensor(a, device=dev)
                            for a in sw_inputs(11, J, QP, TP))
    p = sw.SWParams(opt.o_del, opt.e_del, opt.o_ins, opt.e_ins, opt.zdrop,
                    opt.pen_clip5, opt.a, opt.b)
    K = -(-(QP + 2) // 32)
    row_instr = sass_row_instructions("sw_extend", K)
    for w in (opt.w, 2 * opt.w):
        cells = torch.zeros(J, dtype=torch.int64, device=dev)
        n_rows = torch.zeros(J, dtype=torch.int64, device=dev)
        got = sw.sw_extend_kernel(q, qlen, t, tlen, h0, w, p, cells=cells,
                                  rows=n_rows)
        plain_ms, want = wall_ms(
            lambda: sw.sw_extend_plain(q, qlen, t, tlen, h0, w, p))
        err = max_abs_err(got, want)
        ms = cuda_ms(lambda: sw.sw_extend_kernel(q, qlen, t, tlen, h0, w,
                                                 p))
        n_cells, warp_rows = int(cells.sum()), int(n_rows.sum())
        nbytes = 4 * (q.numel() + t.numel() + 3 * J + 6 * J)
        b_ms, b_by = bound(nbytes, n_cells * SW_OPS_PER_CELL, rates["int32"])
        log(f"[kernels] sw_extend J={J} QP={QP} TP={TP} w={w}: kernel "
            f"{ms:.3f} ms, plain {plain_ms:.1f} ms, cells {n_cells}, "
            f"bound {b_ms:.4f} ms ({b_by}), equal: {err == 0}")
        # the kernel's own instruction stream: every row a warp runs costs
        # the row loop's SASS instructions whatever its band width
        log(f"[kernels] sw_extend w={w}: {warp_rows} warp rows, "
            f"{n_cells / max(warp_rows, 1):.1f} cells per row of "
            f"{32 * K} lane columns (lane use "
            f"{100 * n_cells / max(32 * K * warp_rows, 1):.1f}%); "
            + (f"row loop {row_instr} SASS instructions = "
               f"{row_instr / K:.1f} per column a lane holds, "
               f"{row_instr * warp_rows / n_cells:.2f} warp instructions "
               f"per cell; issuing them alone takes "
               f"{1e3 * row_instr * warp_rows / rates['issue']:.4f} ms"
               if row_instr else "SASS not read (no cuobjdump)"))
        if err != 0:
            raise AssertionError(f"sw_extend w={w} differs from its plain "
                                 f"version (max abs err {err})")
        if w == opt.w:
            rows["sw_extend"] = dict(max_abs_err=err, ms=ms,
                                     plain_ms=plain_ms, bound_ms=b_ms,
                                     bound_by=b_by)
            kernels_sw_split(q, qlen, t, tlen, h0, w, p, cells, ms)

    rows["chain_loop"] = kernels_chain(dev, rates)
    rows["chain_flt"] = kernels_chain_flt(dev)
    rows["pairhmm"] = kernels_pairhmm(dev, rates)
    kernels_kswv(dev, rates)
    return rows


# P2's cases beyond the register path's lane and chunk edges: the bench
# shape, an escalated one, the ladder's widest and one on the wide path
# (B, P, C), on chain_inputs' main-path-shaped seeds
CHAIN_CASES = (("bench", (4096, 256, 64)), ("escalated", (1024, 1024, 128)),
               ("widest", (1024, 2048, 256)), ("wide", (1024, 1024, 320)))
CHAIN_EDGE_CS = (1, 31, 32, 33, 64, 256)
CHAIN_EDGE_PS = (1, 31, 32, 33, 100)


def kernels_chain(dev, rates):
    """P2 against its plain version, tensor for tensor (table, n, ovf,
    chain_of): at the register path's lane and chunk edges
    (tests/test_torch_cuda.py's chain_edge_seeds) and at CHAIN_CASES.
    Kernel ms from the events the C entry point records around each
    launch; ms per step of the longest read; two bounds: the bytes (and
    operations) one, and the serial one, the longest read's valid steps
    times one step's latency on an idle SM (the slope of a lone read's
    kernel time from 1,024 to 2,048 valid steps). Returns the bench
    shape's row."""
    import torch
    from fgdp_tpu_torch.align import chain
    from fgdp_tpu_torch.config import AlignConfig
    from fgdp_tpu_torch.probes import CHAIN_OPS_PER_SLOT, wall_ms

    opt = AlignConfig()

    def check(cols, C, l_pac):
        args = [torch.as_tensor(a, device=dev) for a in cols]
        run = lambda: chain.chain_loop_kernel(*args, l_pac, C, opt.w,
                                              opt.max_chain_gap)
        p0 = dict(chain.PATH_LAUNCHES)
        got = run()
        path = [p for p in p0 if chain.PATH_LAUNCHES[p] > p0[p]]
        plain_ms, want = wall_ms(lambda: chain.chain_loop_plain(
            *args, l_pac, C, opt.w, opt.max_chain_gap))
        keys = sorted(want)
        err = max_abs_err([got[k] for k in keys], [want[k] for k in keys])
        if err != 0:
            raise AssertionError(f"chain_loop B={len(cols[0])} P="
                                 f"{cols[0].shape[1]} C={C} differs from "
                                 f"its plain version (max abs err {err})")
        return run, path, plain_ms

    edge = load_file("tests/test_torch_cuda.py").chain_edge_seeds
    for C in CHAIN_EDGE_CS:
        for P in CHAIN_EDGE_PS:
            check(edge(7 * C + P, 12, P, 5000), C, 5000)
    log(f"[kernels] chain_loop equal to its plain version at C "
        f"{CHAIN_EDGE_CS} x P {CHAIN_EDGE_PS} (chain_edge_seeds)")

    l_pac = 2_300_000
    for K in (2, 8):
        sass_row_instructions("chain_loop", K)
    row = None
    for label, (B, P, C) in CHAIN_CASES:
        cols = chain_inputs(5 + P, B, P, l_pac)
        run, path, plain_ms = check(cols, C, l_pac)
        ms = timed_ms("chain_loop", run)
        valid = cols[4]
        t_last = np.where(valid.any(1), P - np.argmax(valid[:, ::-1], 1), 0)
        steps = int(t_last.sum())
        longest = int(valid.sum(1).max())
        nbytes = B * P + 4 * 4 * steps + B + \
            4 * (B * C * len(chain.LOOP_FIELDS) + B + B * P) + B
        b_ms, b_by = bound(nbytes, steps * C * CHAIN_OPS_PER_SLOT,
                           rates["int32"])
        step_us = lone_step_us(dev, C, l_pac, opt)
        serial = 1e-3 * longest * step_us
        log(f"[kernels] chain_loop {label} B={B} P={P} C={C}, {path} path: "
            f"kernel {ms:.4f} ms, plain {plain_ms:.1f} ms, seed steps "
            f"{steps}, longest read {longest} valid steps = "
            f"{1e3 * ms / longest:.3f} us per step; bound {b_ms:.5f} ms "
            f"({b_by}); serial bound {serial:.4f} ms ({step_us:.3f} us a "
            f"step on an idle SM = {step_us * rates['mhz']:.0f} clocks at "
            f"{rates['mhz']:.0f} MHz); kernel / serial bound "
            f"{ms / serial:.2f}; equal: True")
        if label == "bench":
            row = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by)
    return row


def flt_dref(dev, is_alt):
    """What chain_flt reads of a DeviceReference: the alt table."""
    import torch
    from types import SimpleNamespace
    return SimpleNamespace(is_alt=torch.as_tensor(is_alt, device=dev),
                           n_contigs=len(is_alt))


def flt_stats(st, weight, opt, C):
    """The batch's filter ranks n_f (max, mean, reads with two or more,
    the read with the most) and the bytes the filter must move: n and
    the six fields of each chain read once, the B x C flags written
    once."""
    import torch
    n = st["n"].clamp(0, C)
    B = n.numel()
    have = torch.arange(C, device=n.device)[None, :] < n[:, None]
    nf = (have & (weight >= opt.min_chain_weight)).sum(1)
    return dict(max=int(nf.max()), mean=float(nf.float().mean()),
                multi=int((nf > 1).sum()), longest=int(nf.argmax()),
                nbytes=4 * B + 24 * int(n.sum()) + 4 * B * C)


def flt_row(tag, st, weight, dref, opt, C, plain_ms=None):
    """D5 on one launch's inputs: kernel ms (mean of 10 launches, the
    events its C entry point records), plain ms (one call, synced,
    unless given), the bytes bound and the serial one (the read with the
    most filter ranks alone: its kernel ms, 20 launches); logged and
    returned as a kernels-line row."""
    from fgdp_tpu_torch.align import chain
    from fgdp_tpu_torch.probes import wall_ms
    ms = timed_ms("chain_flt", lambda: chain.chain_flt_kernel(
        st, weight, dref, opt, C))
    if plain_ms is None:
        plain_ms, _ = wall_ms(lambda: chain.chain_flt_plain(
            st, weight, dref, opt, C))
    nf = flt_stats(st, weight, opt, C)
    nbytes = nf["nbytes"] + dref.n_contigs
    b_ms, b_by = bound(nbytes, 0, 1.0)
    b = nf["longest"]
    one = {f: st[f][b:b + 1].contiguous() for f in chain.FLT_FIELDS}
    w1 = weight[b:b + 1].contiguous()
    serial = timed_ms("chain_flt", lambda: chain.chain_flt_kernel(
        one, w1, dref, opt, C), reps=20)
    log(f"[{tag}] chain_flt B={weight.shape[0]} C={C}: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.1f} ms; n_f max {nf['max']}, mean "
        f"{nf['mean']:.3f}, {nf['multi']} reads with two or more; bound "
        f"{b_ms:.5f} ms ({b_by}, {nbytes} bytes); serial bound "
        f"{serial:.4f} ms (read {b} alone, {max(nf['max'] - 1, 0)} rank "
        f"steps); kernel / serial bound {ms / max(serial, 1e-9):.2f}")
    return dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def kernels_chain_flt(dev):
    """D5 against its plain version, exactly: at the warp's 32-rank
    edges (C 1-384) under three option sets and at the ladder's (B, C)
    (tests/test_torch_cuda.py's flt_tables, CHAIN_FLT_OPTS and
    CHAIN_FLT_LADDER), and on P2's output at the bench shape (B 4,096,
    P 256, C 64 from chain_inputs), whose row it returns; ptxas'
    registers and stack frame."""
    import dataclasses
    import torch
    from fgdp_tpu_torch.align import chain
    from fgdp_tpu_torch.config import AlignConfig
    from fgdp_tpu_torch.ops import kernels
    from fgdp_tpu_torch.probes import wall_ms

    opt = AlignConfig()
    tc = load_file("tests/test_torch_cuda.py")

    def check(tbl, C, o, is_alt):
        st = {f: torch.as_tensor(tbl[f], device=dev)
              for f in chain.FLT_FIELDS}
        weight = torch.as_tensor(tbl["weight"], device=dev)
        dref = flt_dref(dev, is_alt)
        got = chain.chain_flt_kernel(st, weight, dref, o, C)
        plain_ms, want = wall_ms(lambda: chain.chain_flt_plain(
            st, weight, dref, o, C))
        if not torch.equal(got, want):
            raise AssertionError(f"chain_flt B={len(tbl['n'])} C={C} "
                                 f"differs from its plain version")
        return st, weight, dref, plain_ms

    for C in tc.CHAIN_FLT_EDGE_CS:
        for name, kw in sorted(tc.CHAIN_FLT_OPTS.items()):
            check(tc.flt_tables(C, 40, C), C,
                  dataclasses.replace(opt, **kw), tc.alt_table())
    log(f"[kernels] chain_flt equal to its plain version at C "
        f"{tc.CHAIN_FLT_EDGE_CS} x options {sorted(tc.CHAIN_FLT_OPTS)}")
    for B, C in tc.CHAIN_FLT_LADDER:
        st, weight, dref, plain_ms = check(tc.flt_tables(B + C, B, C), C,
                                           opt, tc.alt_table())
        ms = timed_ms("chain_flt", lambda: chain.chain_flt_kernel(
            st, weight, dref, opt, C))
        nf = flt_stats(st, weight, opt, C)
        log(f"[kernels] chain_flt flt_tables B={B} C={C}: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.1f} ms, n_f max {nf['max']} "
            f"mean {nf['mean']:.1f}, bound "
            f"{bound(nf['nbytes'], 0, 1.0)[0]:.5f} ms (bytes); equal: True")
    for ln in kernels.build_log.get("chain_flt", {}).get("log", "") \
            .splitlines():
        if "registers" in ln or "stack" in ln:
            log(f"[kernels] chain_flt ptxas: {ln.strip()}")
    l_pac = 2_300_000
    cols = [torch.as_tensor(a, device=dev)
            for a in chain_inputs(261, 4096, 256, l_pac)]
    st = chain.chain_loop_kernel(*cols, l_pac, 64, opt.w, opt.max_chain_gap)
    weight = chain.chain_weight(st)
    dref = flt_dref(dev, np.zeros(2, bool))
    got = chain.chain_flt_kernel(st, weight, dref, opt, 64)
    plain_ms, want = wall_ms(lambda: chain.chain_flt_plain(
        st, weight, dref, opt, 64))
    if not torch.equal(got, want):
        raise AssertionError("chain_flt differs from its plain version on "
                             "P2's bench output")
    return flt_row("kernels", st, weight, dref, opt, 64, plain_ms)


def lone_step_us(dev, C, l_pac, opt):
    """One step's latency of P2 on an otherwise idle card: the kernel
    time of one read whose 1,024 or 2,048 slots are all valid (events of
    the C entry point), the difference over the 1,024 steps between."""
    import torch
    from fgdp_tpu_torch.align import chain
    ms = []
    for P in (1024, 2048):
        cols = list(chain_inputs(77, 1, P, l_pac))
        cols[4] = np.ones((1, P), bool)
        args = [torch.as_tensor(a, device=dev) for a in cols]
        ms.append(timed_ms("chain_loop", lambda: chain.chain_loop_kernel(
            *args, l_pac, C, opt.w, opt.max_chain_gap), reps=20))
    return 1e3 * (ms[1] - ms[0]) / 1024


def sass_row_instructions(kernel, K):
    """SASS instructions of `kernel`'s row loop (sw_extend or pairhmm; the
    step loop of chain_loop) at K columns or chain slots a lane
    (fgdp_tpu_torch.probes.sass), or None where cuobjdump is missing."""
    from fgdp_tpu_torch.probes import sass
    row_loops = dict(sw_extend=sass.sw_row_loops, kswv=sass.kswv_row_loops,
                     pairhmm=sass.pairhmm_row_loops,
                     chain_loop=sass.chain_step_loops)[kernel]
    try:
        loops = row_loops()
    except RuntimeError as e:
        log(f"[kernels] {e}")
        return None
    if loops.get(K) is None:
        log(f"[kernels] {kernel} K={K}: no row loop found in the SASS")
        return None
    n, ops = loops[K]
    log(f"[kernels] {kernel} K={K} loop: {n} SASS instructions = "
        f"{n / K:.1f} per register a lane holds; "
        + ", ".join(f"{o} {c}" for o, c in ops.most_common(10)))
    return n


def kernels_sw_split(q, qlen, t, tlen, h0, w, p, cells, ms):
    """The SW kernel on each query-length class of the bench jobs alone:
    its share of the jobs, of the DP cells and of the whole batch's
    kernel time (the measurement that says whether short jobs waste the
    warp's lanes)."""
    from fgdp_tpu_torch.ops import sw
    from fgdp_tpu_torch.probes import cuda_ms

    total = int(cells.sum())
    for lo, hi in ((1, 20), (21, 99), (100, q.shape[1])):
        sel = ((qlen >= lo) & (qlen <= hi)).nonzero()[:, 0]
        sub = [a[sel].contiguous() for a in (q, qlen, t, tlen, h0)]
        t_ms = cuda_ms(lambda: sw.sw_extend_kernel(*sub, w, p))
        log(f"[kernels] sw_extend qlen {lo}-{hi} alone: "
            f"{100 * len(sel) / len(qlen):.1f}% of jobs, "
            f"{100 * int(cells[sel].sum()) / total:.1f}% of cells, "
            f"{t_ms:.3f} ms = {100 * t_ms / ms:.1f}% of the batch's time")


def timed_ms(name, fn, reps=10):
    """Mean kernel ms of `fn`'s launches of kernel `name` over `reps`
    calls after a warm-up, from the CUDA events its C entry point records
    right around each launch (host work in the wrapper falls outside)."""
    import torch
    from fgdp_tpu_torch.ops import kernels
    fn()
    kernels.TIMED[name] = []
    try:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        pairs = kernels.TIMED[name]
    finally:
        kernels.TIMED.pop(name, None)
    return sum(s.elapsed_time(e) for s, e in pairs) / len(pairs)


# P3's cases: the bench shape, a batcher bucket without the depth cap, a
# batch that underflows into the f64 re-run, a launch as mutect_scale
# makes them (NP, R, H: its 99 launches average 309 pairs, and 59 of
# them are at its most common bucket, R 64 and H 64) and one above the
# register path's widest H
HMM_SCALE_LAUNCH = (309, 64, 64)
HMM_WIDE_CASE_H = 768


def kernels_pairhmm(dev, rates):
    """P3 against its plain version, bit for bit (log10 and the raw sum),
    at the bench shape (NP 2048, R 151, H 384, capped scan), at one
    batcher bucket (R 160, H 128) with gap-continuation quals below 8 (no
    cap), on a batch where a quarter of the pairs underflow (there the
    whole async path, f64 re-run included, must equal the port's CPU
    run), at a scale launch (HMM_SCALE_LAUNCH, ragged) and on the wide
    path (H HMM_WIDE_CASE_H). Kernel ms from the events the C
    entry point records around each launch."""
    import torch
    from fgdp_tpu_torch.ops import pairhmm
    from fgdp_tpu_torch.probes import (HMM_OPS_PER_CELL, HMM_OPS_PER_DOUBLING,
                                       wall_ms)
    from fgdp_tpu_torch.utils.profiling import HMM_F64, PROF

    row = None
    for label, args in (
            ("bench", hmm_inputs(21, 2048, 151, 384, 10, full=True)),
            ("bucket", hmm_inputs(22, 4096, 160, 128, 5)),
            ("underflow", hmm_inputs(23, 1024, 151, 256, 10,
                                     hopeless=0.25)),
            ("scale-launch", hmm_inputs(24, *HMM_SCALE_LAUNCH, 10)),
            ("wide", hmm_inputs(25, 512, 151, HMM_WIDE_CASE_H, 10))):
        reads, rl, q, iq, dq, cq, haps, hl = args
        cap = pairhmm.doubling_cap(cq)
        pq = pairhmm._PH2PR32[np.clip(q, 0, 127)]
        tr = pairhmm.transitions(iq, dq, cq, np.float32)
        t = [torch.as_tensor(a, device=dev)
             for a in (reads, rl, pq, tr, haps, hl)]
        run = lambda: pairhmm.forward_f32_kernel(*t, n_doubling_cap=cap)
        p0 = dict(pairhmm.PATH_LAUNCHES)
        got = run()
        path = [p for p in p0 if pairhmm.PATH_LAUNCHES[p] > p0[p]]
        plain_ms, want = wall_ms(
            lambda: pairhmm.forward_f32(*t, n_doubling_cap=cap))
        rel = float(((got[1] - want[1]).abs() /
                     want[1].abs().clamp(min=1e-30)).max())
        l10 = float((got[0] - want[0]).abs().max())
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        ms = timed_ms("pairhmm", run)
        NP, R = reads.shape
        H = haps.shape[1]
        K = -(-(H + 1) // 32)
        cells = int(np.dot(rl.astype(np.int64), hl))
        warp_rows = int(rl.sum())
        nd = pairhmm.n_doublings(H, cap)
        nbytes = NP * R * 4 * (1 + 1 + 6) + NP * H * 4 + NP * 3 * 4
        b_ms, b_by = bound(nbytes, cells * (HMM_OPS_PER_CELL +
                                            HMM_OPS_PER_DOUBLING * nd),
                           rates["fp32"])
        log(f"[kernels] pairhmm {label} NP={NP} R={R} H={H} (K={K}) "
            f"doublings={nd}, {path} path: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.1f} ms, cells {cells}, warp rows {warp_rows}, "
            f"{cells / ms / 1e6:.2f} GCUPS, bound {b_ms:.4f} ms ({b_by}), "
            f"max rel err of acc {rel:.3g}, of log10 {l10:.3g}, equal: "
            f"{same}")
        if not same:
            raise AssertionError(f"pairhmm {label} differs from its plain "
                                 f"version (rel {rel}, log10 {l10})")
        if label == "bench":
            row = dict(max_abs_err=l10, ms=ms, plain_ms=plain_ms,
                       bound_ms=b_ms, bound_by=b_by)
            n = sass_row_instructions("pairhmm", K)
            if n:
                ops = HMM_OPS_PER_CELL + HMM_OPS_PER_DOUBLING * nd
                log(f"[kernels] pairhmm bench: {ops} counted fp32 "
                    f"operations a cell = {ops / 32:.2f} warp instructions "
                    f"a cell at 32 lanes; the row loop issues "
                    f"{n * warp_rows / cells:.2f} a cell ({warp_rows} warp "
                    f"rows of {32 * K} lane columns, {cells / warp_rows:.1f}"
                    f" cells each); issuing them alone takes "
                    f"{1e3 * n * warp_rows / rates['issue']:.4f} ms")
        if label == "underflow":
            n0 = PROF.counts[HMM_F64]
            card = pairhmm.compute_log_likelihoods_async(*args, dev)()
            n_f64 = PROF.counts[HMM_F64] - n0
            cpu = pairhmm.compute_log_likelihoods_async(*args, "cpu")()
            raw = got[1].cpu().numpy().astype(np.float64) / 2.0 ** 120
            low = raw < pairhmm.MIN_ACCEPTED
            err = float(np.abs(card - cpu).max())
            log(f"[kernels] pairhmm underflow: {n_f64} pairs re-run in f64 "
                f"on the host, async path vs CPU max abs err of log10 "
                f"{err:.3g} (re-run pairs: "
                f"{float(np.abs(card - cpu)[low].max()):.3g})")
            if n_f64 != low.sum() or n_f64 == 0 or not err <= 1e-5 or \
                    not np.abs(card - cpu)[low].max() <= 1e-9:
                raise AssertionError("pairhmm f64 re-run on the card "
                                     "differs from the CPU run")
    return row


# D6's cases beyond the rescue jobs: the register path's lane edges (QP
# with K = 1, 1, 1, 2, 5, 8 columns a lane), the wide path and a batch of
# mostly empty jobs, on tests/test_torch_cuda.py's kswv_jobs
KSWV_EDGE_QPS = (1, 31, 32, 33, 160, 256)
KSWV_RESCUE_PAIRS = 512


def rescue_jobs(g, n_pairs, opt):
    """Mate-rescue jobs as pe_scale makes them: sim_pairs' pairs on a
    400 kb stretch of the scale genome, the insert-size statistics from
    their true inserts (align/pair.pestat), and for each pair the window
    _matesw_window opens for the FR direction around the forward end,
    with the other end as the query (every pair's mate is searched, as a
    pair whose mate seeding missed is)."""
    from fgdp_tpu_torch.align import pair
    from fgdp_tpu_torch.index.reference import PackedReference

    g = g[:400_000]
    pref = PackedReference.from_contigs(["chr"], [g])
    l_pac = pref.l_pac
    pairs = sim_pairs(g, n_pairs, 151, seed=29, baited=0.0)
    ends = []
    for name, r1, r2 in pairs:
        p1, p2 = (int(x) - 1 for x in name.split("_")[1:3])
        # the forward end is the leftmost; the other end reads reverse
        (fp, fr), (rp, rr) = sorted([(p1, r1), (p2, r2)],
                                    key=lambda e: e[0])
        ends.append((fp, rp, rr))
    reg = lambda rb, rid=0: dict(rid=rid, rb=rb, qb=0, qe=151, score=151,
                                 is_alt=False)
    pes = pair.pestat(opt, l_pac, [([reg(fp)], [reg(2 * l_pac - rp - 151)])
                                   for fp, rp, _ in ends])
    jobs = []
    for fp, _, rr in ends:
        w = pair._matesw_window(opt, pref, pes, reg(fp), rr, 1)
        if w is not None:
            jobs.append((w[0], w[1]))
    return jobs, pes[1]


def kswv_pen():
    from fgdp_tpu_torch.config import AlignConfig
    opt = AlignConfig()
    return opt, dict(a=opt.a, b=opt.b, o_del=opt.o_del, e_del=opt.e_del,
                     o_ins=opt.o_ins, e_ins=opt.e_ins)


def kswv_hold(label, args, got=None):
    """kswv's plain version on the card tensors `args` (q, qlen, t, tlen),
    held exactly against the kernel's outputs `got` (launched here when
    None), all four outputs. Returns (outputs, paths taken, plain ms)."""
    from fgdp_tpu_torch.ops import kswv
    from fgdp_tpu_torch.probes import wall_ms

    _, pen = kswv_pen()
    path = []
    if got is None:
        p0 = dict(kswv.PATH_LAUNCHES)
        got = kswv.kswv_forward_kernel(*args, **pen)
        path = [p for p in p0 if kswv.PATH_LAUNCHES[p] > p0[p]]
    plain_ms, want = wall_ms(lambda: kswv.kswv_forward_plain(*args, **pen))
    err = max_abs_err(got, want)
    if err != 0:
        raise AssertionError(f"kswv {label} differs from its plain version "
                             f"(max abs err {err})")
    return got, path, plain_ms


def kswv_row(tag, args, rates):
    """The kernels line's kswv numbers on one launch's card tensors:
    held exactly against its plain version, kernel ms from the events the
    C entry point records around each launch, the bound for this launch's
    cells and bytes, and its step loop's SASS (the register path's
    wavefront runs min(tlen, TP) + 31 warp steps a job)."""
    from fgdp_tpu_torch.ops import kswv
    from fgdp_tpu_torch.probes import KSWV_OPS_PER_CELL

    opt, pen = kswv_pen()
    got, path, plain_ms = kswv_hold(tag, args)
    ms = timed_ms("kswv", lambda: kswv.kswv_forward_kernel(*args, **pen))
    q, qlen, t, tlen = (x.cpu().numpy() for x in args)
    J, QP = q.shape
    TP = t.shape[1]
    cells = int(np.dot(qlen.astype(np.int64), tlen))
    rows = np.minimum(tlen, TP)
    steps = int((rows + 31 * (rows > 0)).sum())
    nbytes = 4 * (q.size + t.size + 2 * J) + 4 * (2 * J + J * QP + J * TP)
    b_ms, b_by = bound(nbytes, cells * KSWV_OPS_PER_CELL, rates["int32"])
    K = -(-QP // 32)
    hits = int((got[0] >= opt.min_seed_len * opt.a).sum())
    log(f"[{tag}] kswv J={J} QP={QP} TP={TP} (K={K}), "
        f"{int((qlen > 0).sum())} jobs, {path} path: kernel {ms:.4f} ms, "
        f"plain {plain_ms:.1f} ms, cells {cells}, warp steps {steps} "
        f"({int(rows.sum())} rows), {cells / ms / 1e6:.2f} GCUPS, bound "
        f"{b_ms:.5f} ms ({b_by}: {KSWV_OPS_PER_CELL} int32 operations a "
        f"cell), kernel / bound {ms / b_ms:.2f}; {hits} jobs score >= "
        f"{opt.min_seed_len * opt.a}; equal: True")
    n = sass_row_instructions("kswv", K)
    if n:
        log(f"[{tag}] kswv: {KSWV_OPS_PER_CELL} counted int32 operations a "
            f"cell = {KSWV_OPS_PER_CELL / 32:.2f} warp instructions a cell "
            f"at 32 lanes; the step loop issues {n * steps / cells:.2f} a "
            f"cell ({steps} warp steps of {32 * K} lane columns, "
            f"{cells / steps:.1f} cells each); issuing them alone takes "
            f"{1e3 * n * steps / rates['issue']:.4f} ms")
    kswv_sweep(tag, args, pen)
    return dict(max_abs_err=0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None)


def kswv_sweep(tag, args, pen):
    """kswv on the launch's first n jobs, n from one warp an SM to all:
    the clocks a warp step takes as the warps an SM holds grow (flat:
    each step's dependent chain bounds it; growing with the warps: a
    shared pipe or the issue slots do)."""
    import torch
    from fgdp_tpu_torch.ops import kswv
    from fgdp_tpu_torch.probes import card

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    mhz = card()[1]["mhz"]
    J = args[0].shape[0]
    out = []
    for n in sorted({sms, 2 * sms, 4 * sms, 8 * sms, J}):
        if n > J:
            continue
        sub = [a[:n].contiguous() for a in args]
        ms = timed_ms("kswv", lambda: kswv.kswv_forward_kernel(*sub, **pen))
        rows = np.minimum(sub[3].cpu().numpy(), sub[2].shape[1])
        steps = (rows + 31 * (rows > 0)).max()
        out.append(f"{n} jobs ({n / sms:.1f} warps an SM) {ms:.4f} ms = "
                   f"{1e3 * ms * mhz / steps:.0f} clocks a step of the "
                   f"longest job")
    log(f"[{tag}] kswv by jobs in the launch: " + "; ".join(out))


def kernels_kswv(dev, rates):
    """D6 against its plain version, all four outputs exactly equal: on
    rescue jobs made as pe_scale makes them (packed and bucketed as
    ksw_align_local_batch packs them; timed, bounded and its SASS read
    too), at the register path's lane edges, on the wide path and on a
    mostly empty batch. The kernels line's row comes from a launch of
    pe_scale's own `mem` run instead."""
    import torch
    from fgdp_tpu_torch.ops import kswv

    opt, _ = kswv_pen()
    kswv_jobs = load_file("tests/test_torch_cuda.py").kswv_jobs
    card = lambda arrays: [torch.as_tensor(a, device=dev) for a in arrays]

    jobs, fr = rescue_jobs(gen_genome(4_600_000, seed=0),
                           KSWV_RESCUE_PAIRS, opt)
    q, t, qlen, tlen = kswv._pack(jobs)
    log(f"[kswv] rescue jobs: {len(jobs)} of {KSWV_RESCUE_PAIRS} pairs (FR "
        f"window {fr.low}-{fr.high} from the true inserts)")
    kswv_row("kswv", card((q, qlen, t, tlen)), rates)
    for QP in KSWV_EDGE_QPS:
        _, path, _ = kswv_hold(f"QP={QP}", card(kswv_jobs(QP, 256, QP, 512)))
        log(f"[kswv] QP={QP} (K={-(-QP // 32)}), 256 jobs: {path} path, "
            "equal: True")
    _, path, _ = kswv_hold("wide", card(kswv_jobs(400, 256, 400, 512)))
    log(f"[kswv] wide QP=400: {path} path, equal: True")
    if path != ["wide"]:
        raise AssertionError("kswv at QP 400 did not take the wide path")
    got, path, _ = kswv_hold("empty", card(kswv_jobs(3, 1024, 160, 512,
                                                     empty=0.9)))
    log(f"[kswv] mostly empty batch, 1024 jobs (90% empty): {path} path, "
        f"{int((got[1] >= 0).sum())} jobs with a positive best, equal: "
        "True")


def _index_sam(lines):
    out = {}
    for ln in lines:
        if ln.startswith("@") or not ln.strip():
            continue
        f = ln.rstrip("\n").split("\t")
        flag = int(f[1])
        if flag & 0x900:
            continue
        out[(f[0], flag & 0xC0)] = f
    return out


def _compare(ref_lines, our_lines, min_core, min_full, cols=slice(1, 6)):
    """tests/test_golden.py's field compare: CORE fields (FLAG RNAME POS
    MAPQ CIGAR; with `cols` PAIR_COLS, also RNEXT PNEXT TLEN) and the
    NM/MD/AS/XS tags, with the same minimum counts."""
    ref, ours = _index_sam(ref_lines), _index_sam(our_lines)
    if len(ours) != len(ref):
        raise AssertionError(f"{len(ours)} primary records, oracle has "
                             f"{len(ref)}")
    core = full = 0
    for key, rf in ref.items():
        of = ours.get(key)
        if of is None:
            raise AssertionError(f"read {key} missing")
        c = rf[cols] == of[cols]
        tr = {x.split(":")[0]: x for x in rf[11:]}
        to = {x.split(":")[0]: x for x in of[11:]}
        core += c
        full += c and all(tr.get(k) == to.get(k)
                          for k in ("NM", "MD", "AS", "XS"))
    if core < min_core or full < min_full:
        raise AssertionError(f"core {core} < {min_core} or full {full} < "
                             f"{min_full}")
    return core, full


def phase_golden(tmp):
    """The single-end fixtures on CORE fields; the pairs on PAIR_COLS
    (tests/test_golden.py:test_golden_paired_end)."""
    from fgdp_tpu_torch import cli
    for ref, fqs, oracle, mc, mf, cols in (
            ("ref.fa", ["se.fq"], "se.oracle.sam", 150, 150, slice(1, 6)),
            ("rep_ref.fa", ["rep.fq"], "rep.oracle.sam", 80, 79,
             slice(1, 6)),
            ("ref.fa", ["pe1.fq", "pe2.fq"], "pe.oracle.sam", 200, 200,
             slice(1, 10))):
        prefix = os.path.join(tmp, ref + ".idx")
        out = os.path.join(tmp, fqs[0] + ".sam")
        cli.main(["index", os.path.join(GOLDEN, ref), prefix])
        cli.main(["mem", prefix, *(os.path.join(GOLDEN, f) for f in fqs),
                  "-o", out])
        with open(out) as f:
            ours = f.read().splitlines()
        with open(os.path.join(GOLDEN, oracle)) as f:
            core, full = _compare(f.read().splitlines(), ours, mc, mf,
                                  cols)
        log(f"[golden] {' '.join(fqs)}: fields {cols.start}-{cols.stop} "
            f"{core}, with tags {full} (need {mc}/{mf}) ok")


def _load_fastq(path):
    from fgdp_tpu_torch.io.fastq import parse_fastq_records
    from fgdp_tpu_torch.utils import dna
    names, seqs, quals = [], [], []
    for name, _, seq, q in parse_fastq_records(path):
        names.append(name)
        seqs.append(dna.encode(seq).astype(np.int64))
        quals.append(q.decode())
    return names, seqs, quals


class EagerPrograms:
    """While any spy below is entered, every Aligner runs its device
    program op by op (pipeline._GraphRunner's private switch): the spies
    watch each kernel call of the main path, and a replayed CUDA graph
    makes none."""

    depth = 0

    @classmethod
    def enter(cls):
        from fgdp_tpu_torch.pipeline import _GraphRunner
        cls.depth += 1
        _GraphRunner._force_eager = True

    @classmethod
    def exit(cls):
        from fgdp_tpu_torch.pipeline import _GraphRunner
        cls.depth -= 1
        _GraphRunner._force_eager = cls.depth > 0


class EscCounter:
    """Counts kernel launches made inside escalated rungs; `rung` is the
    (flavor, level) of the rung running, None outside one."""

    def __init__(self, aligner, names=MEM_KERNELS):
        from fgdp_tpu_torch.ops import kernels
        self.kernels = kernels
        self.launches = {k: 0 for k in names}
        self.rungs = []
        self.rung = None
        inner = aligner._esc_exec

        def spy(flavor, level, *a):
            before = dict(kernels.LAUNCHES)
            self.rung = (flavor, level)
            try:
                out = inner(flavor, level, *a)
            finally:
                self.rung = None
            for k in self.launches:
                self.launches[k] += kernels.LAUNCHES[k] - before[k]
            self.rungs.append((flavor, level))
            return out

        aligner._esc_exec = spy


class ChainLaunches:
    """P2's launches on a main-path run: the kernel time of each from the
    events its C entry point records around the launch, its (B, P, C)
    and its longest read's valid seed steps (counted on the card, read
    after the run)."""

    def __enter__(self):
        EagerPrograms.enter()
        from fgdp_tpu_torch.align import chain
        from fgdp_tpu_torch.ops import kernels
        self.chain, self.kernels = chain, kernels
        self.inner = inner = chain.chain_loop_kernel
        self.shapes = []

        def spy(qbeg, rbeg, slen, rid, valid, overflow, l_pac, C, *a):
            out = inner(qbeg, rbeg, slen, rid, valid, overflow, l_pac, C,
                        *a)
            steps = valid.sum(1).max() if valid.numel() else valid.sum()
            self.shapes.append((tuple(valid.shape) + (C,), steps))
            return out

        chain.chain_loop_kernel = spy
        kernels.TIMED["chain_loop"] = []
        return self

    def __exit__(self, *exc):
        EagerPrograms.exit()
        self.chain.chain_loop_kernel = self.inner
        self.launch_ms = [s.elapsed_time(e) for s, e in
                          self.kernels.TIMED.pop("chain_loop", [])]
        self.steps = [int(st) for _, st in self.shapes]

    def report(self, tag, wall):
        """Log the launches, their summed kernel ms and share of `wall`
        seconds, and the launches by shape; returns the summed ms."""
        total = sum(self.launch_ms)
        log(f"[{tag}] chain_loop (P2) on the path: {len(self.launch_ms)} "
            f"launches, {total:.3f} ms of kernel time (CUDA events its C "
            f"entry point records around each launch) = "
            f"{100 * total / (1e3 * wall):.4f}% of the wall")
        hist = {}
        for (shape, _), st, ms in zip(self.shapes, self.steps,
                                      self.launch_ms):
            h = hist.setdefault(shape, dict(n=0, ms=0.0, steps=0))
            h["n"] += 1
            h["ms"] += ms
            h["steps"] += st
        for (B, P, C), h in sorted(hist.items()):
            log(f"[{tag}] chain_loop B={B} P={P} C={C}: {h['n']} launches, "
                f"{h['ms']:.3f} ms, longest read's valid steps summed "
                f"{h['steps']} = {1e3 * h['ms'] / max(h['steps'], 1):.3f} "
                f"us per step")
        return total


class FltLaunches:
    """D5's launches on a main-path run: the kernel ms of each from the
    events its C entry point records, its (B, C), and with keep=True its
    card inputs and output and the rung it ran in (the EscCounter's, None
    for a primary batch), to be held against the plain version after the
    run."""

    def __init__(self, esc=None, keep=False):
        self.esc, self.keep = esc, keep

    def __enter__(self):
        EagerPrograms.enter()
        from fgdp_tpu_torch.align import chain
        from fgdp_tpu_torch.ops import kernels
        self.chain, self.kernels = chain, kernels
        self.inner = inner = chain.chain_flt_kernel
        self.shapes, self.seen = [], []

        def spy(st, weight, dref, opt, C):
            out = inner(st, weight, dref, opt, C)
            self.shapes.append(tuple(weight.shape))
            if self.keep:
                rung = self.esc.rung if self.esc is not None else None
                args = ({f: st[f] for f in chain.FLT_FIELDS}, weight, dref,
                        opt, C)
                self.seen.append((rung, args, out))
            return out

        chain.chain_flt_kernel = spy
        kernels.TIMED["chain_flt"] = []
        return self

    def __exit__(self, *exc):
        EagerPrograms.exit()
        self.chain.chain_flt_kernel = self.inner
        self.launch_ms = [s.elapsed_time(e) for s, e in
                          self.kernels.TIMED.pop("chain_flt", [])]

    def report(self, tag, wall):
        """Log the launches, their summed kernel ms and share of `wall`
        seconds, by (B, C); returns the summed ms."""
        total = sum(self.launch_ms)
        log(f"[{tag}] chain_flt (D5) on the path: {len(self.launch_ms)} "
            f"launches, {total:.3f} ms of kernel time (CUDA events its C "
            f"entry point records around each launch) = "
            f"{100 * total / (1e3 * wall):.4f}% of the wall")
        hist = {}
        for shape, ms in zip(self.shapes, self.launch_ms):
            h = hist.setdefault(shape, [0, 0.0])
            h[0] += 1
            h[1] += ms
        for (B, C), (k, ms) in sorted(hist.items()):
            log(f"[{tag}] chain_flt B={B} C={C}: {k} launches, {ms:.3f} ms")
        return total

    def hold(self, tag):
        """Every kept launch's flags exactly equal to the plain version's
        on its inputs; logs the launches held by rung."""
        from collections import Counter
        import torch
        held = Counter()
        for rung, args, got in self.seen:
            if not torch.equal(got, self.chain.chain_flt_plain(*args)):
                raise AssertionError(f"chain_flt launch of rung {rung} "
                                     "differs from its plain version")
            held["primary" if rung is None else
                 f"{rung[0]} level {rung[1]}"] += 1
        log(f"[{tag}] every chain_flt launch equals its plain version on "
            f"its inputs: " + ", ".join(f"{r}: {n}" for r, n in
                                        sorted(held.items())))
        return held


class FirstChainCall:
    """The arguments of the first chain_seeds call of a run (the first
    primary batch's: rungs follow their batch)."""

    def __enter__(self):
        EagerPrograms.enter()
        from fgdp_tpu_torch.align import chain
        self.chain = chain
        self.inner = inner = chain.chain_seeds
        self.args = None

        def spy(*a, **kw):
            if self.args is None:
                self.args = (a, kw)
            return inner(*a, **kw)

        chain.chain_seeds = spy
        return self

    def __exit__(self, *exc):
        EagerPrograms.exit()
        self.chain.chain_seeds = self.inner


def chain_split(args, kernel):
    """chain_seeds on one batch piece by piece, each ended by a sync:
    frac_rep, expand_seeds, P2 (its kernel), the weight and D5 (its
    kernel with kernel=True, else its torch ops): ({piece: ms}, D5's
    arguments, kept)."""
    import torch
    from fgdp_tpu_torch.align import chain

    (dfm, dref, smems, lens, opt), kw = args[0][:5], args[1]
    P, C = kw["max_seedpos"], kw["max_chains"]
    ms = {}

    def lap(piece, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[piece] = 1e3 * (time.perf_counter() - t0)
        return out

    lap("frac_rep", lambda: chain.frac_rep(smems, lens, opt))
    ex = lap("expand_seeds", lambda: chain.expand_seeds(
        dfm, dref, smems, opt, P, jobs_cap=kw.get("jobs_cap", 0)))
    st = lap("P2", lambda: chain.chain_loop(*ex[:6], dref.l_pac, C, opt.w,
                                            opt.max_chain_gap))
    weight = lap("weight", lambda: chain.chain_weight(st))
    flt = chain.chain_flt_kernel if kernel else chain.chain_flt_plain
    kept = lap("D5", lambda: flt(st, weight, dref, opt, C))
    ms["total"] = sum(ms.values())
    return ms, (st, weight, dref, opt, C), kept


def chain_split_report(tag, args):
    """The chain split on the kernel and on D5's torch ops in turns
    (torch ops, kernel, kernel, torch ops; the second of each reported,
    the first in brackets), the two D5s' flags equal; logs the batch's
    n_f. Returns (the torch ops' D5 ms, D5's arguments)."""
    import torch
    sp0, _, _ = chain_split(args, kernel=False)
    sk0, _, _ = chain_split(args, kernel=True)
    sk, fa, got = chain_split(args, kernel=True)
    sp, _, want = chain_split(args, kernel=False)
    if not torch.equal(got, want):
        raise AssertionError("the chain split's D5 flags differ from the "
                             "torch ops'")
    st, weight, dref, opt, C = fa
    nf = flt_stats(st, weight, opt, C)
    B, P = weight.shape[0], args[1]["max_seedpos"]
    log(f"[{tag}] chain split of one primary batch ({B} reads, P {P}, C "
        f"{C}; synced ms, first pass in brackets): D5 kernel "
        + ", ".join(f"{k} {v:.2f} [{sk0[k]:.2f}]" for k, v in sk.items())
        + "; D5 torch ops "
        + ", ".join(f"{k} {v:.2f} [{sp0[k]:.2f}]" for k, v in sp.items())
        + f"; D5 torch ops / kernel {sp['D5'] / max(sk['D5'], 1e-9):.1f}x")
    log(f"[{tag}] the batch's filter ranks n_f: max {nf['max']}, mean "
        f"{nf['mean']:.3f}, {nf['multi']} reads with two or more")
    return sp["D5"], fa


# the seeding kernels' wrappers, by kernel: (module, kernel function,
# plain function) under fgdp_tpu_torch.ops, and the JAX loop each replaces
SEED_FNS = {
    "smem_lcp": ("smem_lcp", "smem_all_lcp_kernel", "smem_all_lcp_plain"),
    "k2_lcp": ("smem_k2lcp", "k2_reseed_lcp_kernel", "k2_reseed_lcp_plain"),
    "seed_strategy": ("smem", "seed_strategy_kernel", "seed_strategy_plain"),
}


def _seed_fn(name, which):
    """The kernel (which=1) or plain (which=2) function of a seeding
    kernel, looked up at call time."""
    import importlib
    mod = importlib.import_module("fgdp_tpu_torch.ops." + SEED_FNS[name][0])
    return getattr(mod, SEED_FNS[name][which])


class SeedLaunches:
    """The seeding kernels' launches on a main-path run: the kernel ms of
    each from the events its C entry point records, and, with keep=True,
    every launch's card inputs and outputs and the rung it ran in (the
    EscCounter's, None for a primary batch), to be held against the plain
    versions after the run; the first primary K1 launch's inputs always
    (the seeding split's batch)."""

    def __init__(self, esc=None, keep=False):
        self.esc, self.keep = esc, keep

    def __enter__(self):
        EagerPrograms.enter()
        import importlib
        from fgdp_tpu_torch.ops import kernels
        self.kernels = kernels
        self.seen, self.primary, self.inner = [], None, {}
        for name, (mod, kfn, _) in SEED_FNS.items():
            m = importlib.import_module("fgdp_tpu_torch.ops." + mod)
            inner = self.inner[name] = (m, getattr(m, kfn))

            def spy(*a, _name=name, _inner=inner[1], **kw):
                out = _inner(*a, **kw)
                rung = self.esc.rung if self.esc is not None else None
                if self.keep:
                    self.seen.append((_name, rung, a, kw, out))
                if _name == "smem_lcp" and rung is None and \
                        self.primary is None:
                    self.primary = a
                return out

            setattr(m, kfn, spy)
            kernels.TIMED[name] = []
        return self

    def __exit__(self, *exc):
        EagerPrograms.exit()
        import torch
        for name, (m, inner) in self.inner.items():
            setattr(m, SEED_FNS[name][1], inner)
        torch.cuda.synchronize()
        self.launch_ms = {name: [s.elapsed_time(e) for s, e in
                                 self.kernels.TIMED.pop(name, [])]
                          for name in SEED_FNS}

    def report(self, tag, wall):
        """Log each kernel's launches and summed kernel ms (and share of
        `wall` seconds); returns {kernel: (launches, ms)}."""
        out = {}
        for name, ms in self.launch_ms.items():
            out[name] = (len(ms), sum(ms))
            log(f"[{tag}] {name} on the path: {len(ms)} launches, "
                f"{sum(ms):.3f} ms of kernel time (CUDA events its C entry "
                f"point records around each launch) = "
                f"{100 * sum(ms) / (1e3 * wall):.4f}% of the wall")
        return out

    def hold(self, tag):
        """Every kept launch's outputs exactly equal to its plain version
        on its inputs; logs the launches held by kernel and rung."""
        from collections import Counter
        held = Counter()
        for name, rung, a, kw, got in self.seen:
            want = _seed_fn(name, 2)(*a, **kw)
            for f in got._fields:
                if not bool((getattr(got, f) == getattr(want, f)).all()):
                    raise AssertionError(
                        f"{name} launch of rung {rung} differs from its "
                        f"plain version in {f}")
            held[name, "primary" if rung is None else
                 f"{rung[0]} level {rung[1]}"] += 1
        log(f"[{tag}] every seeding kernel launch equals its plain version "
            f"on its inputs: " + ", ".join(
                f"{k} {r}: {n}" for (k, r), n in sorted(held.items())))
        return held


def seeding_split(al, codes, lens, active, kernel):
    """The LCP engine's collect_seeds at the aligner's primary caps on one
    batch, piece by piece, each ended by a sync, on the kernels
    (kernel=True) or the torch-op loops: ({piece: ms}, SeedBatch)."""
    import torch
    from fgdp_tpu_torch.align import seeding

    sh, opt = al.shapes, al._dev_opt
    if sh.seed_scale != 1 or sh.k2_scale or sh.k1_emit_cap or \
            sh.k3_emit_cap:
        raise ValueError("the split takes the primary caps")
    B, S = codes.shape[0], sh.max_smems
    which = 1 if kernel else 2
    ms = {}

    def lap(piece, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        ms[piece] = 1e3 * (time.perf_counter() - t0)
        return out

    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    k1 = lap("K1", lambda: _seed_fn("smem_lcp", which)(
        al.dfm, al.lcp_tree, al.lcp_isa, codes, lens, active,
        opt.min_seed_len, S, al.dref.codes16, 24))

    def jobs():
        qidx, k_read, x, mi, on, ovf = seeding.k2_jobs(k1, opt, split_len,
                                                       2 * B)
        pos, d0 = seeding.lcp_job_pos(al.dfm, k1, qidx, x)
        return (k_read, x, mi, pos, d0, on), ovf

    job, k2_ovf = lap("K2 jobs", jobs)
    k2 = lap("K2", lambda: _seed_fn("k2_lcp", which)(
        al.dfm, al.lcp_tree, al.lcp_isa, codes, lens, *job,
        opt.min_seed_len, B, S, into=k1, sj_cap=16, ascent_cap=64,
        max_rounds=48))
    k3 = lap("K3", lambda: _seed_fn("seed_strategy", which)(
        al.dfm, codes, lens, active, opt.max_mem_intv,
        opt.min_seed_len + 1, S))
    out = lap("merge", lambda: seeding.merge_sorted(k2, k3, k2_ovf))
    ms["total"] = sum(ms.values())
    return ms, dict(k1=k1, job=job, k2=k2, k3=k3, out=out)


def seed_work(name, *a, **kw):
    """A seeding kernel's launch with its work counters: (output, [table
    bytes gathered, grid steps, lane steps, longest lane's own steps],
    then for K1 its wave split: ns, then grid steps, of each of
    smem_lcp.WAVE_BUCKETS)."""
    import torch
    from fgdp_tpu_torch.ops import smem_lcp
    n = smem_lcp.WORK_LEN if name == "smem_lcp" else 4
    work = torch.zeros(n, dtype=torch.int64, device=a[0].counts.device)
    out = _seed_fn(name, 1)(*a, **kw, work=work)
    return out, [int(v) for v in work.cpu()]


def seed_rows(al, codes, lens, active):
    """The seeding split, kernels against torch ops on the same batch (in
    turns: plain, kernels, kernels, plain; the second of each kept), the
    split's outputs equal, and the kernels line's rows of smem_lcp, k2_lcp
    and seed_strategy on that batch: kernel ms (mean of 10 launches, CUDA
    events), plain ms (the split's), the bytes bound (table bytes the
    lanes gather, counted by the kernel, plus inputs read and outputs
    written once) and two serial bounds: the lone read's (K1's and K2's
    grid steps times one grid step of K1 on one read alone, K3's longest
    read's steps times a step of K3 on one read alone: both move with the
    kernel under test) and the design-independent one (probes.chase on
    this index's occ rows: K3's most gather steps of a read times the
    dependent gather's latency, K1's and K2's grid steps times the
    latency plus the cheapest grid barrier, cooperative_groups' or the
    kernels' own GridBar in either form, at their launch's grid). Also
    K1's wave split (µs a grid step by wave)."""
    import torch
    from fgdp_tpu_torch.ops import smem_k2lcp, smem_lcp
    from fgdp_tpu_torch.probes import chase
    sp0, _ = seeding_split(al, codes, lens, active, kernel=False)
    sk0, _ = seeding_split(al, codes, lens, active, kernel=True)
    sk, got = seeding_split(al, codes, lens, active, kernel=True)
    sp, want = seeding_split(al, codes, lens, active, kernel=False)
    for f in got["out"]._fields:
        if not torch.equal(getattr(got["out"], f), getattr(want["out"], f)):
            raise AssertionError(f"the split's seeds differ in {f}")
    B = codes.shape[0]
    log(f"[scale] seeding split of one primary batch ({B} reads, synced "
        f"ms; first pass in brackets): kernels "
        + ", ".join(f"{k} {v:.2f} [{sk0[k]:.2f}]" for k, v in sk.items())
        + "; torch ops "
        + ", ".join(f"{k} {v:.1f} [{sp0[k]:.1f}]" for k, v in sp.items())
        + f"; torch ops / kernels {sp['total'] / sk['total']:.1f}x")
    opt = al._dev_opt
    S = al.shapes.max_smems
    k1a = (al.dfm, al.lcp_tree, al.lcp_isa, codes, lens, active,
           opt.min_seed_len, S, al.dref.codes16, 24)
    job = got["job"]
    k2a = (al.dfm, al.lcp_tree, al.lcp_isa, codes, lens, *job,
           opt.min_seed_len, B, S)
    k2kw = dict(into=got["k1"], sj_cap=16, ascent_cap=64, max_rounds=48)
    k3a = (al.dfm, codes, lens, active, opt.max_mem_intv,
           opt.min_seed_len + 1, S)
    # one read alone: the first active one
    r0 = int(torch.nonzero(active)[0])
    one = lambda x: x[r0:r0 + 1]
    lone = {
        "smem_lcp": (al.dfm, al.lcp_tree, al.lcp_isa, one(codes),
                     one(lens), one(active)) + k1a[6:],
        "seed_strategy": (al.dfm, one(codes), one(lens),
                          one(active)) + k3a[4:],
    }
    full = {"smem_lcp": (k1a, {}), "k2_lcp": (k2a, k2kw),
            "seed_strategy": (k3a, {})}
    plain = {"smem_lcp": sp["K1"], "k2_lcp": sp["K2"],
             "seed_strategy": sp["K3"]}
    in_bytes = 4 * codes.numel() + 5 * B
    rows, step_us = {}, {}
    for name, la in lone.items():
        lone_ms = timed_ms(name, lambda: _seed_fn(name, 1)(*la))
        _, lwork = seed_work(name, *la)
        # K1 a grid step (a barrier and a step), K3 a step of one read
        steps = lwork[1] if name == "smem_lcp" else lwork[2]
        step_us[name] = 1e3 * lone_ms / max(steps, 1)
        log(f"[scale] {name} on read {r0} alone: {lone_ms:.4f} ms for "
            f"{steps} {'grid ' if name == 'smem_lcp' else ''}steps = "
            f"{step_us[name]:.3f} us a step (the kernel under test)")
    # the design-independent step: the dependent gather of two of this
    # index's occ rows (probes.chase, one chain alone, warm in L2), and
    # for K1 and K2 one grid barrier at the grid their launch takes
    occ = al.dfm.occ_fused
    cold, lat = chase.latency_us(occ)
    plan = smem_lcp.launch_plan(B, codes.shape[1], occ.device)
    grids = {"smem_lcp": (plan.blocks, plan.threads),
             "k2_lcp": smem_k2lcp.launch_grid(job[0].numel(), occ.device)}
    bars = {k: {sync: chase.barrier_us(occ, *g, sync=sync)
                for sync in chase.BARRIERS} for k, g in grids.items()}
    bar = {k: min(b.values()) for k, b in bars.items()}
    log(f"[scale] gather_chase on the scale index ({occ.shape[0]} rows): "
        f"{lat:.4f} us a hop warm (cold {cold:.4f}); a grid barrier "
        + ", ".join(f"at {grids[k][0]} x {grids[k][1]} ({k}): " + ", ".join(
            f"{sync} {us:.4f} us" for sync, us in bars[k].items())
            for k in grids))
    for name, (a, kw) in full.items():
        out, work = seed_work(name, *a, **kw)
        ms = timed_ms(name, lambda: _seed_fn(name, 1)(*a, **kw))
        serial = 1e-3 * (work[3] * step_us["seed_strategy"]
                         if name == "seed_strategy"
                         else work[1] * step_us["smem_lcp"])
        # the new bound: K3's read with the most gathers (work[1]) times
        # the gather's latency; K1's and K2's grid steps times the
        # latency and a barrier
        if name == "seed_strategy":
            indep = 1e-3 * work[1] * lat
            how = (f"{work[1]} gather steps x {lat:.4f} us; the longest "
                   f"read's {work[3]} steps x the latency "
                   f"{1e-3 * work[3] * lat:.4f} ms")
        else:
            indep = 1e-3 * work[1] * (lat + bar[name])
            cheap = min(bars[name], key=bars[name].get)
            how = (f"{work[1]} grid steps x ({lat:.4f} + {bar[name]:.4f} "
                   f"us, the {cheap} barrier)")
        if name == "smem_lcp":
            nb = len(smem_lcp.WAVE_BUCKETS)
            log(f"[scale] smem_lcp wave split (%globaltimer, thread 0 of "
                f"block 0), us a grid step by wave: " + ", ".join(
                    f"{w} {1e-3 * work[4 + i] / max(work[4 + nb + i], 1):.3f}"
                    f" ({work[4 + nb + i]} steps, "
                    f"{1e-6 * work[4 + i]:.4f} ms)"
                    for i, w in enumerate(smem_lcp.WAVE_BUCKETS))
                + f"; {sum(work[4 + nb:4 + 2 * nb])} grid steps in all")
        rows_out = out.count.numel()
        nbytes = work[0] + in_bytes + 16 * int(out.count.sum()) + \
            5 * rows_out + (24 * job[0].numel() if name == "k2_lcp" else 0)
        b_ms, b_by = bound(nbytes, 0, 1.0)
        log(f"[scale] {name} on the batch: kernel {ms:.4f} ms, plain "
            f"{plain[name]:.1f} ms; {work[0]} table bytes gathered, "
            f"{work[2]} lane steps, {work[1]} "
            f"{'gather steps of one read' if name == 'seed_strategy' else 'grid steps'}"
            f", longest lane's own steps {work[3]}; bound {b_ms:.5f} ms "
            f"({b_by}, {nbytes} bytes); lone-read serial bound {serial:.4f} "
            f"ms (kernel / it {ms / max(serial, 1e-9):.2f}); "
            f"design-independent serial bound {indep:.4f} ms ({how}); "
            f"kernel / it {ms / max(indep, 1e-9):.2f}")
        rows[name] = dict(max_abs_err=0, ms=ms, plain_ms=plain[name],
                          bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return rows


class Unresolved:
    """Reads whose overflow flag is still set after the escalation ladder
    (their alignments are those of the widest caps, cut short), by
    sequence: recorded around every Aligner's ladder once installed."""

    seqs = set()

    @classmethod
    def install(cls):
        from fgdp_tpu_torch.pipeline import Aligner
        inner = Aligner._retry_overflow_inner
        if getattr(inner, "unresolved_spy", False):
            return

        def spy(self, regs_np, seq_codes):
            out = inner(self, regs_np, seq_codes)
            for b in np.flatnonzero(out["overflow"]):
                cls.seqs.add(np.asarray(seq_codes[b], np.int8).tobytes())
            return out

        spy.unresolved_spy = True
        Aligner._retry_overflow_inner = spy

    @classmethod
    def has(cls, seq):
        return np.asarray(seq, np.int8).tobytes() in cls.seqs


def phase_ladder(dev):
    """Tight caps push most reads through every rung of the overflow
    ladder; the card's SAM must equal the port's CPU SAM."""
    from fgdp_tpu_torch.config import BatchShapes
    from fgdp_tpu_torch.index.fmindex import FMIndex
    from fgdp_tpu_torch.index.reference import PackedReference
    from fgdp_tpu_torch.pipeline import Aligner

    shapes = BatchShapes(read_len=100, batch_reads=64, max_smems=1,
                         max_seeds=8, max_chains=2, max_regs=3,
                         transfer_regs=2, pack_cap=1, max_ext_ref=304)
    pref = PackedReference.from_fasta(os.path.join(GOLDEN, "rep_ref.fa"))
    fm = FMIndex.build(pref.codes)
    names, seqs, quals = _load_fastq(os.path.join(GOLDEN, "rep.fq"))
    names, seqs, quals = names[:64], seqs[:64], quals[:64]
    gpu = Aligner(pref, fm, shapes=shapes, device=dev)
    cnt = EscCounter(gpu)
    ours = gpu.align_batch(names, seqs, quals)
    want = Aligner(pref, fm, shapes=shapes, device="cpu").align_batch(
        names, seqs, quals)
    rungs = sorted(set(cnt.rungs))
    log(f"[ladder] {gpu.esc_reads} escalated reads, rungs {rungs}, "
        f"launches in rungs {cnt.launches}, equal to CPU: {ours == want}")
    if ours != want:
        raise AssertionError("escalated reads on the card differ from the "
                             "CPU run")
    if set(rungs) != {("cw", 1), ("cw", 2), ("full", 2), ("k2w", 1)}:
        raise AssertionError(f"ladder reached only {rungs}")
    if min(cnt.launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched in the escalated "
                             f"rungs: {cnt.launches}")


def phase_scale(dev, tmp, genome_bp, n_reads, batch):
    import torch
    from fgdp_tpu_torch import cli
    from fgdp_tpu_torch.ops import kernels
    from fgdp_tpu_torch.pipeline_stream import stream_mem
    from fgdp_tpu_torch.utils.profiling import PROF, WORKER_SAM

    L = 151
    t0 = time.time()
    g = gen_genome(genome_bp, seed=0)
    reads = sim_reads(g, n_reads, L, seed=1)
    fa = os.path.join(tmp, "ecoli_like.fa")
    fq = os.path.join(tmp, "reads.fq")
    write_fasta(fa, "chr", g)
    write_fastq(fq, reads)
    log(f"[scale] data: {genome_bp} bp reference, {n_reads} x {L} bp "
        f"reads, made in {time.time() - t0:.1f} s")
    prefix = os.path.join(tmp, "ecoli_like")
    t0 = time.time()
    cli.main(["index", fa, prefix])
    t_index = time.time() - t0

    Unresolved.install()
    aligner = cli.load_aligner(prefix, batch, opt=None, device=dev)
    aligner.stage_ms = {}
    aligner.esc_stage_ms = {}
    esc = EscCounter(aligner)
    lines = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    fin0 = PROF.acc.get(WORKER_SAM, 0.0)
    kernels.reset_launches()
    kernels.TIMED["sw_extend"] = []
    try:
        with ChainLaunches() as p2, SeedLaunches(esc, keep=True) as sl, \
                FltLaunches(esc, keep=True) as d5, FirstChainCall() as cc:
            t0 = time.time()
            n = stream_mem(aligner, cli.read_batches([fq], batch),
                           lines.append)
            torch.cuda.synchronize()
            wall = time.time() - t0
        sw_ms = sum(s.elapsed_time(e) for s, e in kernels.TIMED["sw_extend"])
    finally:
        kernels.TIMED.pop("sw_extend", None)
    launches = {k: kernels.LAUNCHES[k] for k in MEM_KERNELS}
    peak = torch.cuda.max_memory_allocated()
    n_batches = -(-n // batch)
    fin_ms = 1e3 * (PROF.acc.get(WORKER_SAM, 0.0) - fin0) / n_batches
    stage = {k: round(v / n_batches, 3)
             for k, v in aligner.stage_ms.items()}
    log(f"[scale] index build {t_index:.2f} s")
    log(f"[scale] mem: {n} reads in {wall:.2f} s = {n / wall:.1f} reads/s "
        f"end to end (batch {batch}, stages timed by CUDA events)")
    log(f"[scale] per batch ms: {json.dumps(stage)}; host finalize "
        f"{fin_ms:.1f}; escalated stage ms total "
        f"{json.dumps({k: round(v, 1) for k, v in aligner.esc_stage_ms.items()})}")
    log(f"[scale] escalated reads {aligner.esc_reads} in "
        f"{aligner.esc_calls} rung calls {sorted(set(esc.rungs))}, "
        f"{sum(Unresolved.has(s) for _, s in reads)} still overflowed after "
        f"the last rung; launches {launches}, of which in rungs "
        f"{esc.launches}")
    log(f"[scale] sw_extend (P1) on the mem path: {launches['sw_extend']} "
        f"launches, {sw_ms:.3f} ms of kernel time (CUDA events around each "
        f"launch) = {100 * sw_ms / (1e3 * wall):.3f}% of mem's wall")
    p2.report("scale", wall)
    d5.report("scale", wall)
    sl.report("scale", wall)
    log(f"[scale] peak device memory {peak / 2**30:.2f} GiB")

    # placement accuracy against the simulated truth
    prim = [ln.split("\t") for ln in lines
            if ln and not ln.startswith("@")
            and not int(ln.split("\t")[1]) & 0x900]
    if len(prim) != n_reads or len({f[0] for f in prim}) != n_reads:
        raise AssertionError(f"{len(prim)} primary records for {n_reads} "
                             "reads")
    mapped = [f for f in prim if not int(f[1]) & 4]
    confident = [f for f in mapped if int(f[4]) >= 20]
    right = sum(abs(int(f[3]) - int(f[0].split("_")[1])) <= 10
                for f in confident)
    frac_right = right / max(len(confident), 1)
    log(f"[scale] mapped {len(mapped)}/{n_reads}, MAPQ>=20 "
        f"{len(confident)}, of which at the true position "
        f"{frac_right:.4f}")
    if len(mapped) < 0.9 * n_reads or frac_right < 0.95:
        raise AssertionError("scale run placed too few reads correctly")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched on the main "
                                 "path")
    if aligner.esc_reads and min(esc.launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched in the escalated "
                             f"rungs: {esc.launches}")
    held = sl.hold("scale")
    flavors = {r for _, r in held} - {"primary"}
    if any(held[k, "primary"] <= 0 for k in SEED_KERNELS) or \
            len(flavors) < len(set(esc.rungs)):
        raise AssertionError(f"seeding launches held: {dict(held)}")
    codes, lens, active = sl.primary[3:6]
    rows = seed_rows(aligner, codes, lens, active)
    del sl
    flt_held = d5.hold("scale")
    if flt_held["primary"] <= 0 or len(d5.seen) != len(d5.launch_ms):
        raise AssertionError(f"chain_flt launches held: {dict(flt_held)}")
    plain_ms, fa = chain_split_report("scale", cc.args)
    rows["chain_flt"] = flt_row("scale", *fa, plain_ms=plain_ms)
    widest = max(d5.seen, key=lambda x: x[1][4])
    flt_row(f"scale rung {widest[0]}", *widest[1])
    del d5
    return launches, dict(prefix=prefix, fq=fq, reads=reads, lines=lines,
                          aligner=aligner, seed_rows=rows,
                          genome_bp=genome_bp)


def _sync(dev):
    import torch
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def seed_keys(dfm, sb):
    """A SeedBatch's slots with k normalised: an interval of one suffix
    (s == 1) by its text position, whichever encoding the engine gave it
    (k < -1 is the direct position -k - 2); wider intervals by their SA
    start, which is unique. Invalid slots are zero."""
    import torch
    from fgdp_tpu_torch.ops import fm as fmops

    S = sb.m.shape[1]
    valid = torch.arange(S, device=sb.m.device)[None, :] < sb.count[:, None]
    pos = torch.where(sb.k < -1, -sb.k - 2,
                      fmops.sa_lookup(dfm, sb.k.clamp(min=0)))
    k = torch.where(sb.s == 1, pos, sb.k)
    return torch.stack([torch.where(valid, a, 0)
                        for a in (sb.m, sb.n, sb.s, k)], dim=2)


ENGINES = ("lcp", "sweep", "wave", "lcp_k2_sweep")
N_INEXACT_CPU = 128


def engines_seeds(dev, al, codes, lens):
    """collect_seeds on every engine at the aligner's device_align
    arguments: {engine: (SeedBatch, ms)}, each call synced."""
    import torch
    from fgdp_tpu_torch.align import seeding

    sh = al.shapes
    kw = dict(max_seeds=sh.max_smems, prev_cap=20, scale=sh.seed_scale,
              k1_emit_cap=sh.k1_emit_cap, k3_emit_cap=sh.k3_emit_cap,
              k2_scale=sh.k2_scale)
    tree = dict(lcp_tree=al.lcp_tree, lcp_isa=al.lcp_isa)
    out = {}
    for name in ENGINES:
        extra = {"lcp": tree, "sweep": {}, "wave": dict(use_sweep=False),
                 "lcp_k2_sweep": tree}[name]
        act = torch.ones(codes.shape[0], dtype=torch.bool,
                         device=codes.device)
        old = os.environ.pop("FGDP_K2_SWEEP", None)
        if name == "lcp_k2_sweep":
            os.environ["FGDP_K2_SWEEP"] = "1"
        try:
            _sync(dev)
            t0 = time.time()
            sb = seeding.collect_seeds(al.dfm, al.dref, codes, lens, act,
                                       al._dev_opt, **kw, **extra)
            _sync(dev)
            out[name] = (sb, 1e3 * (time.time() - t0))
        finally:
            os.environ.pop("FGDP_K2_SWEEP", None)
            if old is not None:
                os.environ["FGDP_K2_SWEEP"] = old
    return out


def engines_compare(dfm, seeds):
    """Per engine: reads it flags overflowed, reads both it and the LCP
    engine leave clean, how many of those differ from the LCP engine's
    seeds (count and every slot, k normalised), and how many of these
    carry the sweep's seeds on the read instead. fgdp_tpu's LCP K2 and
    its wave/sweep K2 can find different re-seeds on a read none of them
    flags (ROADMAP queue 3); the sweep must then flag the read."""
    ref = seeds["lcp"][0]
    keys = {name: seed_keys(dfm, sb) for name, (sb, _) in seeds.items()}

    def same_as(name, other):
        sb, ob = seeds[name][0], seeds[other][0]
        if sb.m.shape != ob.m.shape:
            raise AssertionError(f"{name} and {other} seed buffers differ "
                                 "in shape")
        return (sb.count == ob.count) & \
            (keys[name] == keys[other]).all(dim=2).all(dim=1)

    res = {}
    for name, (sb, ms) in seeds.items():
        n = sb.count.shape[0]
        clean = ~(sb.overflow | ref.overflow)
        odd = clean & ~same_as(name, "lcp")
        as_sweep = odd & same_as(name, "sweep")
        res[name] = dict(ms=ms, reads=n, ovf=int(sb.overflow.sum()),
                         clean=int(clean.sum()), differ=int(odd.sum()),
                         as_sweep=int(as_sweep.sum()),
                         bad=int((odd & ~as_sweep).sum()) if name != "sweep"
                         else int(odd.sum()))
    return res


class SweepLaunches:
    """D9's and D10's launches on a main-path run: every launch's card
    inputs and outputs and the rung it ran in (the EscCounter's, None for
    a primary batch), to be held against the torch-op loops after the
    run, and the kernel ms of each from the events its C entry point
    records around the launch. primary_only keeps the primary batches'
    launches only."""

    FNS = {"sweep_fwd": ("fwd_sweep_kernel", "fwd_sweep_plain"),
           "sweep_bwd": ("bwd_entries_kernel", "bwd_entries_plain")}

    def __init__(self, esc, primary_only=False):
        self.esc, self.primary_only = esc, primary_only

    def __enter__(self):
        EagerPrograms.enter()
        from fgdp_tpu_torch.ops import kernels, smem_sweep
        self.kernels, self.mod = kernels, smem_sweep
        self.seen, self.inner = [], {}
        for name, (kfn, _) in self.FNS.items():
            inner = self.inner[name] = getattr(smem_sweep, kfn)

            def spy(*a, _name=name, _inner=inner, **kw):
                out = _inner(*a, **kw)
                if not (self.primary_only and self.esc.rung is not None):
                    self.seen.append((_name, self.esc.rung, a, kw, out))
                return out

            setattr(smem_sweep, kfn, spy)
            kernels.TIMED[name] = []
        return self

    def __exit__(self, *exc):
        EagerPrograms.exit()
        import torch
        for name, (kfn, _) in self.FNS.items():
            setattr(self.mod, kfn, self.inner[name])
        torch.cuda.synchronize()
        self.launch_ms = {name: [s.elapsed_time(e) for s, e in
                                 self.kernels.TIMED.pop(name, [])]
                          for name in self.FNS}

    def hold(self, tag):
        """Every kept launch's outputs exactly equal to its torch-op loop
        on its inputs; logs the launches held by kernel and rung."""
        import torch
        from collections import Counter
        held = Counter()
        for name, rung, a, kw, got in self.seen:
            want = getattr(self.mod, self.FNS[name][1])(*a, **kw)
            pairs = [(got[f], want[f], f) for f in want] \
                if isinstance(want, dict) else zip(got, want,
                                                   ("m", "kf", "sf"))
            for x, y, f in pairs:
                if not torch.equal(x, y):
                    raise AssertionError(
                        f"{name} launch of rung {rung} differs from its "
                        f"torch-op loop in {f}")
            held[name, "primary" if rung is None else
                 f"{rung[0]} level {rung[1]}"] += 1
        log(f"[{tag}] every D9 (sweep_fwd) and D10 (sweep_bwd) launch equals "
            f"its torch-op loop on its inputs: " + ", ".join(
                f"{k} {r}: {n}" for (k, r), n in sorted(held.items())))
        return held


def sweep_split(al, codes, lens, active, kernel):
    """The sweep engine's collect_seeds at the aligner's primary caps
    (pipeline.device_align's: prev_cap 20, K1's E = min(2 L + 16, 192)
    and 44 backward lanes a read, K2's 2 jobs a read with E 22, 16
    backward lanes a job and walk off) on one batch, piece by piece, each
    ended by a sync, on D9, D10 and K3's kernels (kernel=True) or their
    torch-op loops: ({piece: ms}, {piece: output})."""
    import torch
    from fgdp_tpu_torch.align import seeding
    from fgdp_tpu_torch.ops import smem, smem_sweep as sw

    sh, opt = al.shapes, al._dev_opt
    if sh.seed_scale != 1 or sh.k2_scale or sh.k1_emit_cap or \
            sh.k3_emit_cap:
        raise ValueError("the split takes the primary caps")
    B, L = codes.shape
    S, msl, pc = sh.max_smems, opt.min_seed_len, 20
    dfm, c16 = al.dfm, al.dref.codes16
    fwd = sw.fwd_sweep_kernel if kernel else sw.fwd_sweep_plain
    bwd = sw.bwd_entries_kernel if kernel else sw.bwd_entries_plain
    k3fn = _seed_fn("seed_strategy", 1 if kernel else 2)
    ms, out = {}, {}

    def lap(piece, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out[piece] = fn()
        torch.cuda.synchronize()
        ms[piece] = 1e3 * (time.perf_counter() - t0)
        return out[piece]

    rid = torch.arange(B, dtype=torch.int32, device=codes.device)
    ones = torch.ones_like(rid)
    E = min(2 * L + 16, 192)
    fw = lap("K1 D9", lambda: fwd(dfm, codes, lens, rid,
                                   torch.zeros_like(rid), ones, active, pc,
                                   E, c16, restart=True))
    lanes, drop = lap("K1 flatten", lambda: sw.flatten_entries(
        fw, rid, ones, E, B * 44))
    bw = lap("K1 D10", lambda: bwd(dfm, codes, lens, lanes, c16))
    k1 = lap("K1 emit", lambda: (lambda sb: sb._replace(
        overflow=sb.overflow | fw["povf"] | fw["eovf"] | drop))(
        sw.emit_merge(lanes, *bw, msl, B, S)))
    split_len = int(msl * opt.split_factor + 0.499)
    _, k_read, x, mi, on, k2_ovf = lap("K2 jobs", lambda: seeding.k2_jobs(
        k1, opt, split_len, 2 * B))
    fw2 = lap("K2 D9", lambda: fwd(dfm, codes, lens, k_read, x, mi, on, pc,
                                    pc + 2, c16, restart=False, walk=False))
    lanes2, drop2 = lap("K2 flatten", lambda: sw.flatten_entries(
        fw2, k_read, mi, pc + 2, 2 * B * 16))
    bw2 = lap("K2 D10", lambda: bwd(dfm, codes, lens, lanes2, c16))
    k2 = lap("K2 emit", lambda: (lambda sb: sb._replace(
        overflow=sb.overflow | smem.any_by(k_read, fw2["povf"] | fw2["eovf"],
                                           B)
        | smem.any_by(k_read, drop2, B)))(
        sw.emit_merge(lanes2, *bw2, msl, B, S, into=k1)))
    k3 = lap("K3", lambda: k3fn(dfm, codes, lens, active, opt.max_mem_intv,
                                msl + 1, S))
    lap("merge", lambda: seeding.merge_sorted(k2, k3, k2_ovf))
    ms["total"] = sum(ms.values())
    return ms, out


def sweep_rows(al, codes, lens, active, want):
    """The sweep's seeding split on one primary batch, kernels against
    torch ops (in turns: plain, kernels, kernels, plain; the second of
    each kept), its seeds equal to collect_seeds' (`want`) and to the
    torch ops', and the kernels line's rows of D9 and D10 on that batch's
    K1 launches: kernel ms (mean of 10 launches, CUDA events), plain ms
    (the split's), the bytes bound (table bytes the lanes gather, counted
    by the kernel, plus inputs read and outputs written once) and the
    design-independent serial bound (probes.chase on this index's occ
    rows: the busiest lane's dependent gathers times the latency of one,
    a gather of two occ rows); K2's launches logged beside them."""
    import torch
    from fgdp_tpu_torch.ops import smem_sweep as sw
    from fgdp_tpu_torch.probes import chase
    sp0, _ = sweep_split(al, codes, lens, active, kernel=False)
    sk0, _ = sweep_split(al, codes, lens, active, kernel=True)
    sk, got = sweep_split(al, codes, lens, active, kernel=True)
    sp, plain = sweep_split(al, codes, lens, active, kernel=False)
    for f in want._fields:
        if not (torch.equal(getattr(got["merge"], f), getattr(want, f))
                and torch.equal(getattr(plain["merge"], f),
                                getattr(want, f))):
            raise AssertionError(f"the sweep split's seeds differ from "
                                 f"collect_seeds' in {f}")
    B = codes.shape[0]
    log(f"[engines] sweep seeding split of one primary batch ({B} reads, "
        f"synced ms; first pass in brackets): kernels "
        + ", ".join(f"{k} {v:.2f} [{sk0[k]:.2f}]" for k, v in sk.items())
        + "; torch ops "
        + ", ".join(f"{k} {v:.1f} [{sp0[k]:.1f}]" for k, v in sp.items())
        + f"; torch ops / kernels {sp['total'] / sk['total']:.1f}x")
    occ = al.dfm.occ_fused
    cold, lat = chase.latency_us(occ)
    log(f"[engines] gather_chase on the scale index: {lat:.4f} us a hop "
        f"warm (cold {cold:.4f})")
    c16, L = al.dref.codes16, codes.shape[1]
    rid = torch.arange(B, dtype=torch.int32, device=codes.device)
    ones = torch.ones_like(rid)
    E = min(2 * L + 16, 192)
    calls = {
        ("sweep_fwd", "K1"): (sw.fwd_sweep_kernel, (
            al.dfm, codes, lens, rid, torch.zeros_like(rid), ones, active,
            20, E, c16), dict(restart=True)),
        ("sweep_bwd", "K1"): (sw.bwd_entries_kernel, (
            al.dfm, codes, lens, got["K1 flatten"][0], c16), {}),
        ("sweep_fwd", "K2"): (sw.fwd_sweep_kernel, (
            al.dfm, codes, lens, *got["K2 jobs"][1:5], 20, 22, c16),
            dict(restart=False, walk=False)),
        ("sweep_bwd", "K2"): (sw.bwd_entries_kernel, (
            al.dfm, codes, lens, got["K2 flatten"][0], c16), {}),
    }
    in_bytes = 4 * codes.numel() + 4 * B
    rows = {}
    for (name, k), (fn, a, kw) in calls.items():
        work = torch.zeros(4, dtype=torch.int64, device=codes.device)
        fn(*a, **kw, work=work)
        work = [int(v) for v in work.cpu()]
        ms = timed_ms(name, lambda: fn(*a, **kw))
        if name == "sweep_fwd":
            NL, Ek = a[4].numel(), a[8]
            nbytes = work[0] + in_bytes + 13 * NL + 16 * NL * Ek + 6 * NL
        else:
            NL = a[3]["n"].numel()
            nbytes = work[0] + in_bytes + 21 * NL + 12 * NL
        b_ms, b_by = bound(nbytes, 0, 1.0)
        indep = 1e-3 * work[1] * lat
        plain_ms = sp[f"{k} {'D9' if name == 'sweep_fwd' else 'D10'}"]
        log(f"[engines] {name} ({k}, {NL} lanes) on the batch: kernel "
            f"{ms:.4f} ms, plain {plain_ms:.1f} ms; {work[0]} table bytes "
            f"gathered, {work[2]} lane steps, longest lane {work[3]} steps, "
            f"busiest lane {work[1]} dependent gathers; bound {b_ms:.5f} ms "
            f"({b_by}, {nbytes} bytes); design-independent serial bound "
            f"{indep:.4f} ms ({work[1]} gathers x {lat:.4f} us); kernel / "
            f"it {ms / max(indep, 1e-9):.2f}")
        if k == "K1":
            rows[name] = dict(max_abs_err=0, ms=ms, plain_ms=plain_ms,
                              bound_ms=b_ms, bound_by=b_by, library_ms=None)
    return rows


def index_bytes(al, genome_bp):
    """Logs the bytes on the card of the aligner's DeviceFMIndex and of
    its LCP tree and ISA, each a text position, and the same reckoned
    for a 3.1 Gb reference (the same bytes a position)."""
    dfm = al.dfm
    size = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    fm_b = size((dfm.occ_fused, dfm.sa, dfm.counts, dfm.c2))
    lcp_b = size((al.lcp_tree, al.lcp_isa))
    npos = dfm.text_len
    human = 2 * 3_100_000_000 + 1
    log(f"[engines] bytes on the card of the scale index ({genome_bp} bp, "
        f"{npos} text positions, both strands): DeviceFMIndex {fm_b} = "
        f"{fm_b / npos:.3f} B a text position; LCP tree + ISA {lcp_b} = "
        f"{lcp_b / npos:.3f} B a text position. Reckoned for a 3.1 Gb "
        f"reference ({human} text positions, a reckoning, not measured): "
        f"DeviceFMIndex {fm_b / npos * human / 1e9:.1f} GB, LCP tree + ISA "
        f"{lcp_b / npos * human / 1e9:.1f} GB, against the card's 80 GB")


def phase_engines(dev, ctx, batch):
    """The fallback engines on the scale phase's index and its first full
    batch of reads: (a) collect_seeds on the sweep, the wave machine
    and LCP K1 with FGDP_K2_SWEEP=1, each equal
    to the LCP engine's seeds on every read neither flags overflowed
    (the sweep strictly; a read where another engine differs must carry
    the sweep's seeds: fgdp_tpu's K2 engines disagree there);
    (b) Aligner(lcp=False) `mem` with its ladder over every scale read
    (two batches), SAM equal to the LCP aligner's (the scale phase's) for
    every read both ladders resolve, reads/s beside the LCP aligner's on
    the same batches, every D9 and D10 launch (primary batches and every
    rung) held exactly against its torch-op loop on its inputs; the
    sweep's seeding split of the first batch (kernels against torch ops,
    its seeds equal to collect_seeds'), D9's and D10's rows of the
    kernels line, and the bytes on the card of the FM index and of the
    LCP tree and ISA, a text position and reckoned for 3.1 Gb;
    (c) the first 256 reads' sweep SAM on the card equal to the CPU's;
    (d) exact_search and inexact_search (z = 1) on 4,096 patterns of read
    length (exact substrings of both strands and mutated ones), equal to
    the CPU port's (inexact on the first N_INEXACT_CPU: its breadth-first
    search on a repeat-rich genome takes minutes on the CPU) and to
    RMIndex.lookup_host on their RMI chunks."""
    import torch
    from fgdp_tpu_torch import cli
    from fgdp_tpu_torch.config import BatchShapes
    from fgdp_tpu_torch.index.fmindex import FMIndex
    from fgdp_tpu_torch.index.reference import PackedReference
    from fgdp_tpu_torch.index.rmi import RMIndex
    from fgdp_tpu_torch.ops import exact, kernels
    from fgdp_tpu_torch.ops.fm import DeviceFMIndex
    from fgdp_tpu_torch.pipeline import Aligner
    from fgdp_tpu_torch.utils import dna

    lcp_al, prefix = ctx["aligner"], ctx["prefix"]
    names, seqs, quals = next(cli.read_batches([ctx["fq"]], batch))
    B, L = len(seqs), lcp_al.shapes.read_len
    codes = np.full((B, L), 4, np.int32)
    lens = np.zeros(B, np.int32)
    for i, s in enumerate(seqs):
        codes[i, :min(len(s), L)] = s[:L]
        lens[i] = min(len(s), L)
    tc = torch.as_tensor(codes, device=dev)
    tl = torch.as_tensor(lens, device=dev)

    # ---- (a) seeds by engine ----
    seeds = engines_seeds(dev, lcp_al, tc, tl)
    res = engines_compare(lcp_al.dfm, seeds)
    for name, r in res.items():
        log(f"[engines] {name}: {r['ms']:.1f} ms for {r['reads']} reads "
            f"(synced), {r['ovf']} reads flag overflow; of the "
            f"{r['clean']} both it and the LCP engine leave clean, "
            f"{r['differ']} differ from the LCP engine's seeds, "
            f"{r['as_sweep']} of them carrying the sweep's seeds")
    if any(r["bad"] for r in res.values()):
        raise AssertionError("an engine's seeds differ from the LCP "
                             "engine's on reads neither flags")

    # ---- (b) the sweep aligner, ladder included, on every scale read ----
    pref = PackedReference.load(prefix + ".ref")
    fm = FMIndex.load(prefix + ".fmi")
    shapes = BatchShapes(batch_reads=batch)
    sweep = Aligner(pref, fm, shapes=shapes, lcp=False, device=dev)
    batches = list(cli.read_batches([ctx["fq"]], batch))
    n_all = sum(len(b[1]) for b in batches)
    # each batch's first read index, as stream_mem passes it: the read
    # ids break ties between equal hits (hash_64 in finalize)
    id0s = [int(i) for i in np.cumsum([0] + [len(b[1]) for b in batches])]
    kernels.reset_launches()
    kernels.TIMED["sw_extend"] = []
    esc = EscCounter(sweep, SWEEP_KERNELS)
    try:
        with ChainLaunches() as p2, SweepLaunches(esc) as d910:
            _sync(dev)
            t0 = time.time()
            lines = [ln for b, i0 in zip(batches, id0s)
                     for ln in sweep.align_batch(*b, id0=i0)]
            _sync(dev)
            wall = time.time() - t0
        sw_ms = sum(s.elapsed_time(e) for s, e in kernels.TIMED["sw_extend"])
    finally:
        kernels.TIMED.pop("sw_extend", None)
    launches = {k: kernels.LAUNCHES[k] for k in SWEEP_KERNELS}
    # the LCP aligner (the scale phase's) on the same batches, the same way
    stage = lcp_al.stage_ms, lcp_al.esc_stage_ms
    lcp_al.stage_ms = lcp_al.esc_stage_ms = None
    try:
        _sync(dev)
        t0 = time.time()
        lcp_lines = [ln for b, i0 in zip(batches, id0s)
                     for ln in lcp_al.align_batch(*b, id0=i0)]
        _sync(dev)
        lcp_wall = time.time() - t0
    finally:
        lcp_al.stage_ms, lcp_al.esc_stage_ms = stage
    names_all = [n for b in batches for n in b[0]]
    seqs_all = [q for b in batches for q in b[1]]
    ours, theirs = by_qname(lines), by_qname(lcp_lines)
    resolved = [n for n, q in zip(names_all, seqs_all)
                if not Unresolved.has(q)]
    differ = [n for n in resolved if ours.get(n) != theirs.get(n)]
    streamed = by_qname(ctx["lines"])
    unlike = [n for n in resolved if theirs.get(n) != streamed.get(n)]
    log(f"[engines] the LCP aligner's SAM by align_batch (id0 each batch's "
        f"first read) against scale's stream_mem: {len(unlike)} of the "
        f"{len(resolved)} resolved reads differ {unlike[:4]}")
    if unlike:
        raise AssertionError("the LCP aligner's align_batch differs from "
                             "its stream_mem")
    for n in differ[:3]:
        log(f"[engines] differs: {n}: sweep {[ln[:160] for ln in ours.get(n, [])]}"
            f" LCP {[ln[:160] for ln in theirs.get(n, [])]}")
    if differ:
        # the differing reads' seeds by engine, on their batch
        from fgdp_tpu_torch.align import seeding
        i = names_all.index(differ[0]) // batch
        bc = np.full((len(batches[i][1]), L), 4, np.int32)
        bl = np.zeros(len(batches[i][1]), np.int32)
        for r, q in enumerate(batches[i][1]):
            bc[r, :min(len(q), L)] = q[:L]
            bl[r] = min(len(q), L)
        bt, blt = torch.as_tensor(bc, device=dev), torch.as_tensor(
            bl, device=dev)
        act = torch.ones(len(bl), dtype=torch.bool, device=dev)
        kw = dict(max_seeds=lcp_al.shapes.max_smems, prev_cap=20)
        sl = seeding.collect_seeds(lcp_al.dfm, lcp_al.dref, bt, blt, act,
                                   lcp_al._dev_opt, lcp_tree=lcp_al.lcp_tree,
                                   lcp_isa=lcp_al.lcp_isa, **kw)
        ss = seeding.collect_seeds(lcp_al.dfm, lcp_al.dref, bt, blt, act,
                                   lcp_al._dev_opt, **kw)
        kl, ks = seed_keys(lcp_al.dfm, sl), seed_keys(lcp_al.dfm, ss)
        for n in differ[:8]:
            r = names_all.index(n) - i * batch
            log(f"[engines] {n}: primary seeds equal "
                f"{bool((kl[r] == ks[r]).all()) and int(sl.count[r]) == int(ss.count[r])}"
                f", overflow LCP {bool(sl.overflow[r])} sweep "
                f"{bool(ss.overflow[r])}, counts {int(sl.count[r])} "
                f"{int(ss.count[r])}")
    d_ms = {k: (len(v), sum(v)) for k, v in d910.launch_ms.items()}
    log(f"[engines] Aligner(lcp=False) mem: {n_all} reads in {wall:.2f} s = "
        f"{n_all / wall:.1f} reads/s (batch {batch}, ladder included); the "
        f"LCP aligner on the same batches in this call: {lcp_wall:.2f} s = "
        f"{n_all / lcp_wall:.1f} reads/s; sweep / LCP wall "
        f"{wall / lcp_wall:.2f}x; {sweep.esc_reads} escalated reads in "
        f"{sweep.esc_calls} rung calls {sorted(set(esc.rungs))}")
    log(f"[engines] on the sweep aligner's path: sweep_fwd (D9) "
        f"{d_ms['sweep_fwd'][0]} launches, {d_ms['sweep_fwd'][1]:.3f} ms; "
        f"sweep_bwd (D10) {d_ms['sweep_bwd'][0]} launches, "
        f"{d_ms['sweep_bwd'][1]:.3f} ms (CUDA events its C entry point "
        f"records) = {100 * (d_ms['sweep_fwd'][1] + d_ms['sweep_bwd'][1]) / (1e3 * wall):.3f}% "
        f"of the wall; sw_extend (P1) {launches['sw_extend']} launches, "
        f"{sw_ms:.3f} ms; chain_loop (P2) {len(p2.launch_ms)} launches, "
        f"{sum(p2.launch_ms):.3f} ms; launches {launches}, of which in "
        f"rungs {esc.launches}")
    if any(d_ms[k][0] != launches[k] for k in d_ms):
        raise AssertionError(f"D9/D10 launches not all seen: {d_ms}")
    held = d910.hold("engines")
    if any(held[k, "primary"] <= 0 for k in d_ms):
        raise AssertionError(f"D9/D10 launches held: {dict(held)}")
    del d910
    n_same = len(resolved) - len(differ)
    log(f"[engines] SAM equal to the LCP aligner's for {n_same} of the "
        f"{len(resolved)} reads both ladders resolve {differ[:4]}")
    if differ or len(resolved) < 0.75 * n_all:
        raise AssertionError("the sweep aligner's SAM differs from the LCP "
                             "aligner's")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the sweep "
                             f"aligner's path: {launches}")
    rows = sweep_rows(sweep, tc, tl, torch.ones(B, dtype=torch.bool,
                                                device=dev),
                      seeds["sweep"][0])
    index_bytes(lcp_al, ctx["genome_bp"])

    # ---- (c) card against CPU ----
    t0 = time.time()
    card = sweep.align_batch(names[:256], seqs[:256], quals[:256])
    cpu = Aligner(pref, fm, shapes=shapes, lcp=False,
                  device="cpu").align_batch(names[:256], seqs[:256],
                                            quals[:256])
    log(f"[engines] first 256 reads' sweep SAM on the card equal to the "
        f"CPU's: {card == cpu} ({len(card)} lines, "
        f"{time.time() - t0:.1f} s)")
    if card != cpu:
        raise AssertionError("the sweep aligner's SAM on the card differs "
                             "from the CPU run")

    # ---- (d) exact and inexact search ----
    rmi = RMIndex.load(prefix + ".rmi")
    x = np.concatenate([pref.codes, dna.revcomp(pref.codes)]) \
        .astype(np.int32)
    rng = np.random.default_rng(2)
    NP = 4096
    at = rng.integers(0, len(x) - L, NP)
    pats = np.stack([x[p:p + L] for p in at])
    mut = np.arange(NP) % 2 == 1
    col = rng.integers(0, L, NP)
    pats[mut, col[mut]] = (pats[mut, col[mut]] + 1 + rng.integers(
        0, 3, int(mut.sum()))) % 4
    plens = np.full(NP, L, np.int32)
    out = {}
    for side, d in (("card", dev), ("cpu", torch.device("cpu"))):
        dfm = lcp_al.dfm if side == "card" else \
            DeviceFMIndex.from_host(fm, device="cpu")
        drmi = exact.DeviceRMI.from_host(rmi, device=d)
        t = lambda a: torch.as_tensor(a, device=d)
        _sync(d)
        t0 = time.time()
        k, s = exact.exact_search(dfm, drmi, t(pats), t(plens))
        _sync(d)
        t1 = time.time()
        n_in = NP if side == "card" else N_INEXACT_CPU
        inx = exact.inexact_search(dfm, t(pats[:n_in]), t(plens[:n_in]),
                                   z=1, max_out=64)
        _sync(d)
        t2 = time.time()
        qk, _ = exact.pack_patterns(t(pats), t(np.full(NP, L - rmi.k,
                                                      np.int32)), rmi.k)
        ck, cs = exact.rmi_interval(drmi, qk)
        out[side] = dict(k=k.cpu(), s=s.cpu(), inx=[a.cpu() for a in inx],
                         ck=ck.cpu(), cs=cs.cpu(), qk=qk.cpu(),
                         ms=(1e3 * (t1 - t0), 1e3 * (t2 - t1)))
    c, h = out["card"], out["cpu"]
    same_exact = c["k"].equal(h["k"]) and c["s"].equal(h["s"])
    same_inx = all(a[:N_INEXACT_CPU].equal(b)
                   for a, b in zip(c["inx"], h["inx"]))
    # lookup_host's rule (two searchsorted calls on the sorted keys) over
    # every chunk at once, and lookup_host itself on the first 64 (one
    # call casts the 9.2 M keys to int64)
    qk = c["qk"].numpy()
    lo = np.searchsorted(rmi.keys, qk, side="left")
    cnt = np.searchsorted(rmi.keys, qk, side="right") - lo
    hit = cnt > 0
    same_host = np.array_equal(c["cs"].numpy(), cnt) and \
        np.array_equal(c["ck"].numpy()[hit], lo[hit]) and all(
            rmi.lookup_host(int(q)) == (lo[i], cnt[i])
            for i, q in enumerate(qk[:64]))
    kk, ss = c["k"].numpy(), c["s"].numpy()
    found = sum(bool(np.any(fm.sa[kk[i]:kk[i] + ss[i]] == at[i]))
                for i in np.flatnonzero(~mut))
    cnt, ovf = c["inx"][2].numpy(), c["inx"][3].numpy()
    log(f"[engines] exact_search of {NP} patterns of {L} bp: "
        f"{c['ms'][0]:.1f} ms on the card ({h['ms'][0]:.1f} on the CPU), "
        f"equal to the CPU's: {same_exact}; {found} of {int((~mut).sum())} "
        f"exact substrings found at their position, "
        f"{int((ss[mut] > 0).sum())} of {int(mut.sum())} mutated ones "
        f"still occur; RMI chunks equal to RMIndex.lookup_host: "
        f"{same_host}")
    log(f"[engines] inexact_search z=1: {c['ms'][1]:.1f} ms for {NP} "
        f"patterns on the card ({h['ms'][1]:.1f} ms for {N_INEXACT_CPU} on "
        f"the CPU), those equal to the CPU's: {same_inx}; "
        f"{int((cnt > 0).sum())} patterns with hits, {int(ovf.sum())} "
        f"overflowed")
    if not (same_exact and same_inx and same_host
            and found == int((~mut).sum())):
        raise AssertionError("exact or inexact search on the card is wrong")
    return launches, rows


def phase_mutect_golden(tmp):
    """`mutect` on the card on the golden fixture; its VCF held against
    the reference binary's golden.vcf by tests/test_golden_vcf.py's
    checks (sites, FILTERs, ECNT/MBQ/MMQ exact, DP and counts +-2, LODs
    within max(0.25, 1%), AF +-0.01)."""
    from fgdp_tpu_torch import cli
    from fgdp_tpu_torch.ops import kernels

    rules = load_file("tests/test_golden_vcf.py")
    fix = os.path.join(GOLDEN, "mutect")
    out = os.path.join(tmp, "mutect_golden.vcf")
    kernels.reset_launches()
    t0 = time.time()
    cli.main(["mutect", "-R", os.path.join(fix, "ref.fa"),
              "-I", os.path.join(fix, "tumor.bam"),
              "-N", os.path.join(fix, "normal.bam"), "-O", out])
    wall = time.time() - t0
    launches = kernels.LAUNCHES["pairhmm"]
    vcfs = (rules.parse_vcf(out),
            rules.parse_vcf(os.path.join(fix, "golden.vcf")))
    for check in (rules.test_sample_columns,
                  rules.test_site_and_filter_concordance,
                  rules.test_info_concordance,
                  rules.test_genotype_concordance):
        check(vcfs)
    log(f"[mutect_golden] {len(vcfs[0][1])} calls = golden.vcf's "
        f"{len(vcfs[1][1])} by test_golden_vcf.py's rules, in {wall:.1f} s;"
        f" pairhmm launches {launches}")
    if launches <= 0:
        raise AssertionError("mutect on the card never launched pairhmm")


def _same_calls(a, b, tol=0.01):
    """Same sites, alleles and FILTERs; LODs within `tol`."""
    if [(c.pos, c.ref, c.alt, c.filters) for c in a] != \
            [(c.pos, c.ref, c.alt, c.filters) for c in b]:
        return False
    for x, y in zip(a, b):
        for u, v in ((x.tlod, y.tlod), (x.nlod, y.nlod),
                     (x.n_artifact_lod, y.n_artifact_lod)):
            if (u is None) != (v is None) or \
                    (u is not None and abs(u - v) > tol):
                return False
    return True


def mutect_launch_histogram(shapes, launch_ms):
    """P3's launches on the mutect path by (R bucket, H bucket): their
    count, pairs (NP) and DP cells, and their summed kernel ms."""
    hist = {}
    for (NP, R, H, cells), ms in zip(shapes, launch_ms):
        h = hist.setdefault((R, H), dict(n=0, nps=[], cells=0, ms=0.0))
        h["n"] += 1
        h["nps"].append(NP)
        h["cells"] += cells
        h["ms"] += ms
    for (R, H), h in sorted(hist.items(), key=lambda kv: -kv[1]["n"]):
        log(f"[mutect_scale] pairhmm R={R} H={H} (K={-(-(H + 1) // 32)}): "
            f"{h['n']} launches, NP {min(h['nps'])}-{max(h['nps'])} "
            f"(median {int(np.median(h['nps']))}), {sum(h['nps'])} pairs, "
            f"{h['cells']} cells, {h['ms']:.3f} ms")


def phase_mutect_scale(dev, genome_bp):
    """scripts/mutect_campaign.py's run on the card: somatic SNVs planted
    on a 1,500 bp grid of the scale genome (seed 17), 30x tumor at VAF
    0.35 and 20x normal, 151 bp; Mutect2Engine.call_windows over the
    contig with a region pool, after one warm pass over the first
    WARM_SITES sites. That warm pass's calls must equal the port's CPU run
    of the same span."""
    import torch
    from fgdp_tpu_torch.call.engine import (Mutect2Engine, _ReadIndex,
                                            apply_filter_mutect_calls)
    from fgdp_tpu_torch.ops import kernels, pairhmm
    from fgdp_tpu_torch.utils.profiling import HMM_F64, HMM_WAIT, PROF

    ref = np.asarray(gen_genome(genome_bp, seed=0), np.uint8)
    n = len(ref)
    camp = load_file("scripts/mutect_campaign.py")
    rng = np.random.default_rng(17)
    pos = np.sort(rng.choice(np.arange(2000, n - 2000, 1500),
                             MUTECT_SITES, replace=False))
    sites = [(int(p), (int(ref[p]) + int(rng.integers(1, 4))) % 4)
             for p in pos]
    t0 = time.time()
    tumor = camp.sim_reads(rng, ref, sites, 30, vaf=0.35)
    normal = camp.sim_reads(rng, ref, sites, 20, vaf=0.0)
    ti, ni = _ReadIndex(tumor), _ReadIndex(normal)
    log(f"[mutect_scale] data: {n} bp genome, {len(sites)} planted SNVs, "
        f"tumor {len(tumor)} + normal {len(normal)} reads of 151 bp, made "
        f"in {time.time() - t0:.1f} s")
    workers = min((os.cpu_count() or 2) - 1, 8)
    warm_end = (int(pos[WARM_SITES - 1]) + int(pos[WARM_SITES])) // 2

    def windows(end, size):
        for rs in range(0, end, size):
            yield rs, min(rs + size, end), ti, ni

    def call(device, end):
        eng = Mutect2Engine(ref, "chr", region_workers=workers,
                            device=device)
        return eng, eng.call_windows(windows(end, eng.cfg.region_size))

    eng, warm = call(dev, warm_end)
    warm_sites = eng.callable_sites
    shapes = []
    inner = pairhmm.forward_f32_kernel

    def spy(reads, rlens, pq, trans, haps, hlens, **kw):
        cells = int((rlens.to(torch.int64) * hlens.to(torch.int64)).sum())
        shapes.append((reads.shape[0], reads.shape[1], haps.shape[1],
                       cells))
        return inner(reads, rlens, pq, trans, haps, hlens, **kw)

    try:
        bat = eng._hmm_batcher
        b0 = (bat.launches, bat.pairs, bat.cells)
        p0 = {k: PROF.acc[k] for k in (HMM_WAIT, HMM_F64)}
        f0 = PROF.counts[HMM_F64]
        pairhmm.forward_f32_kernel = spy
        kernels.reset_launches()
        kernels.TIMED["pairhmm"] = []
        torch.cuda.synchronize()
        t0 = time.time()
        calls = eng.call_windows(windows(n, eng.cfg.region_size))
        torch.cuda.synchronize()
        wall = time.time() - t0
        launches = kernels.LAUNCHES["pairhmm"]
        launch_ms = [s.elapsed_time(e)
                     for s, e in kernels.TIMED.pop("pairhmm")]
        kernel_ms = sum(launch_ms)
        regions = eng.n_regions
    finally:
        pairhmm.forward_f32_kernel = inner
        kernels.TIMED.pop("pairhmm", None)
        eng.close()
    mutect_launch_histogram(shapes, launch_ms)
    b_launch, pairs, cells = (x - y for x, y in zip(
        (bat.launches, bat.pairs, bat.cells), b0))
    wait = {k: PROF.acc[k] - p0[k] for k in p0}
    hit = sum(any(abs(c.pos - p) <= 1 for c in calls) for p, _ in sites)
    apply_filter_mutect_calls(calls,
                              callable_sites=max(eng.callable_sites, 1))
    n_pass = sum(not c.filters for c in calls)
    log(f"[mutect_scale] {regions} active regions in {wall:.2f} s = "
        f"{regions / wall:.2f} regions/s end to end ({workers} region "
        f"workers); {len(calls)} calls ({n_pass} PASS), planted sites "
        f"called (any FILTER, +-1 bp) {hit}/{len(sites)}")
    log(f"[mutect_scale] pairhmm launches {launches} (batcher flushes "
        f"{b_launch}), pairs {pairs}, DP cells {cells}, kernel total "
        f"{kernel_ms:.3f} ms (CUDA events the C entry point records around "
        f"each launch) = {cells / max(kernel_ms, 1e-9) / 1e6:.1f} "
        f"GCUPS; waiting in collect() {wait[HMM_WAIT]:.2f} s "
        f"({100 * wait[HMM_WAIT] / wall:.1f}% of wall), f64 re-run "
        f"{PROF.counts[HMM_F64] - f0} pairs in {wait[HMM_F64]:.2f} s "
        f"({100 * wait[HMM_F64] / wall:.1f}%)")

    # the first WARM_SITES sites' span on the CPU: the same calls
    t0 = time.time()
    cpu_eng, cpu_warm = call("cpu", warm_end)
    cpu_eng.close()
    for cs, n_sites in ((warm, warm_sites),
                        (cpu_warm, cpu_eng.callable_sites)):
        apply_filter_mutect_calls(cs, callable_sites=max(n_sites, 1))
    same = _same_calls(warm, cpu_warm)
    log(f"[mutect_scale] first {WARM_SITES} sites: {len(warm)} calls on the "
        f"card, "
        f"{len(cpu_warm)} on the CPU ({time.time() - t0:.1f} s), same "
        f"sites, FILTERs and LODs within 0.01: {same}")
    if not same:
        raise AssertionError("the card's calls over the first sites "
                             "differ from the CPU run")
    if hit < 0.9 * len(sites):
        raise AssertionError(f"only {hit} of {len(sites)} planted sites "
                             "called")
    if launches <= 0:
        raise AssertionError("pairhmm never launched on the mutect path")
    return launches


def phase_probes(dev, lanes):
    """S1, S2 and the dependent-gather probe: each kernel against its
    plain version, then the probes' own sweeps (and the chase's lone
    chain, cold and warm) with the launch counts set to 0 just before
    them.
    Returns the kernel rows and the rates the bounds divide by."""
    from fgdp_tpu_torch.ops import kernels
    from fgdp_tpu_torch.probes import chase, cuda_ms, gather, wall_ms
    from fgdp_tpu_torch.probes import vpu_ceiling as vc

    err = vc.check(dev)
    log(f"[probes] vpu_ceiling kernel vs plain at {vc.ROWS}x{vc.LANES * vc.G}"
        f" over {vc.CHECK_STEPS} steps, chains {vc.CHAINS}: int32 exact, "
        f"fp32 max relative error {err:.3g} (tolerance {vc.FP32_RTOL})")
    tbl = gather.table(dev)
    gather.check(tbl)
    log(f"[probes] gather_rows kernel equals tbl[idx] on the "
        f"{gather.NBLOCKS}x{gather.W} int32 table at N {gather.NS} and D "
        f"{gather.KERNEL_DEPTHS}, and over a whole chain")
    occ = chase.table(dev)
    chase.check(occ)
    log(f"[probes] gather_chase kernel equals the plain chase on a random "
        f"{chase.NBLOCKS}x{chase.ROW} occ-shaped table, alone and under "
        f"each grid barrier ({', '.join(chase.BARRIERS)}) a hop")

    kernels.reset_launches()
    vrows, best = vc.measure(dev, log=log)
    grows = gather.measure(tbl, log=log)
    cold, warm = chase.latency_us(occ)
    log(f"[probes] gather_chase: one chain alone, {chase.HOPS} hops of two "
        f"96-byte rows: cold {cold:.4f} us a hop, warm (L2) {warm:.4f} us "
        f"a hop")
    launches = {k: kernels.LAUNCHES[k] for k in ("vpu_ceiling",
                                                 "gather_rows",
                                                 "gather_chase")}
    rates = dict(lanes)
    for kind in ("fp32", "int32"):
        rates[kind] = max(lanes[kind], best[kind])
        log(f"[probes] best {kind} issue rate {best[kind] / 1e12:.3f} T/s ="
            f" {100 * best[kind] / lanes[kind]:.1f}% of lanes x SMs x max "
            f"clock ({lanes[kind] / 1e12:.3f} T/s); bounds divide by "
            f"{rates[kind] / 1e12:.3f} T/s")

    # S1's row: the fastest FP32 chain count, bound by its FLOPs (an FMA
    # is two) over twice the FMA issue rate
    top = max((r for r in vrows if r["kind"] == "fp32"),
              key=lambda r: r["rate"])
    xf = vc.inputs(dev)[0]
    plain_ms, _ = wall_ms(lambda: vc.vpu_ceiling_plain(
        xf, vc.STEPS, top["n_chains"]))
    b_ms, b_by = bound(2 * xf.numel() * 4, top["work"] / 2, rates["fp32"])
    log(f"[probes] vpu_ceiling row: fp32 chains={top['n_chains']}, kernel "
        f"{top['ms']:.4f} ms, plain {plain_ms:.1f} ms, bound {b_ms:.4f} ms "
        f"({b_by}); launches in the sweeps {launches}")
    rows = dict(vpu_ceiling=dict(max_abs_err=err, ms=top["ms"],
                                 plain_ms=plain_ms, bound_ms=b_ms,
                                 bound_by=b_by, library_ms=None))

    # S2's row: one launch that fills the card, N = 262,144 at D = 16
    n, d = gather.NS[-1], 16
    idx = gather.indices(dev, n, seed=9)
    ms = cuda_ms(lambda: gather.gather_rows_kernel(tbl, idx, d, False))
    plain = cuda_ms(lambda: gather.gather_rows_plain(tbl, idx))
    lib = cuda_ms(lambda: torch_index_select(tbl, idx))
    b_ms, b_by = bound(gather.row_bytes(n), 0, rates["int32"])
    log(f"[probes] gather_rows row: N={n} D={d}: kernel {ms:.4f} ms "
        f"({gather.row_bytes(n) / ms / 1e6:.1f} GB/s), plain tbl[idx] "
        f"{plain:.4f} ms, torch.index_select {lib:.4f} ms, bound "
        f"{b_ms:.4f} ms ({b_by})")
    rows["gather_rows"] = dict(max_abs_err=0, ms=ms, plain_ms=plain,
                               bound_ms=b_ms, bound_by=b_by, library_ms=lib)

    # the chase probe's row: one warm chain alone of HOPS hops; its bytes
    # (two rows a hop) are its bound, its latency what it measures
    ms = 1e-3 * warm * chase.HOPS
    plain, _ = wall_ms(lambda: chase.chase_plain(occ, 1, chase.HOPS, 12345))
    b_ms, b_by = bound(chase.HOPS * 2 * 96, 0, rates["int32"])
    log(f"[probes] gather_chase row: 1 chain x {chase.HOPS} hops: kernel "
        f"{ms:.4f} ms, plain {plain:.1f} ms, bound {b_ms:.6f} ms ({b_by}); "
        f"the hops are serial, so the kernel is its latency")
    rows["gather_chase"] = dict(
        max_abs_err=0, ms=ms, plain_ms=plain, bound_ms=b_ms, bound_by=b_by,
        library_ms=None,
        bound_note="a latency probe: one dependent chain, so its time is "
                   "the latency it measures and the bytes bound says "
                   "nothing of it")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"probe kernel {k} never launched")
    return rows, launches, rates


def torch_index_select(tbl, idx):
    """The library yardstick of S2 (the port never calls it)."""
    import torch
    return torch.index_select(tbl, 0, idx)


CHR20_LEN = 64_444_167
SD_PHASES = ("SD_DUPSCAN", "SD_SORT", "SD_ENCODE", "SD_BGZF", "SD_BAI")


def make_sormadup_sam(path, n_records, seed=3):
    """A SAM out of coordinate order (record groups shuffled, mates
    adjacent as an aligner writes them) in BASELINE config 3's class on
    one chr20-length contig: 151 bp FR pairs (0x63/0x93, a tenth of the
    first mates soft-clipped by 5, some at the contig's start: negative
    5' positions), 10% of the pairs planted duplicates of another pair's
    positions with new names and qualities, 8% unpaired singles, 2%
    unmapped. A third of the names carry no tile:x:y. Returns the counts."""
    rng = np.random.default_rng(seed)
    L = 151
    n_unmapped = n_records // 50
    n_singles = 2 * n_records // 25
    n_pairs = (n_records - n_unmapped - n_singles) // 2
    n_records = 2 * n_pairs + n_singles + n_unmapped
    n_dup = n_pairs // 10
    n_orig = n_pairs - n_dup
    pos1 = rng.integers(1, CHR20_LEN - 1000, n_orig)
    pos1[:50] = rng.integers(1, 4, 50)
    ins = rng.integers(200, 600, n_orig)
    clip = rng.random(n_orig) < 0.1
    src = rng.integers(0, n_orig, n_dup)
    pos1 = np.concatenate([pos1, pos1[src]])
    ins = np.concatenate([ins, ins[src]])
    clip = np.concatenate([clip, clip[src]])
    pos2 = pos1 + ins - L
    seqs = ["".join(rng.choice(list("ACGT"), L)) for _ in range(64)]
    quals = ["".join(chr(33 + q) for q in rng.integers(2, 41, L))
             for _ in range(512)]
    tiles = rng.integers(1, 2000, n_records)
    xy = rng.integers(1, 30000, (n_records, 2))
    plain_name = rng.random(n_records) < 1 / 3
    sq = rng.integers(0, 64, n_records)
    ql = rng.integers(0, 512, n_records)

    def name(i):
        if plain_name[i]:
            return f"r{i}"
        return f"A00:1:FC:1:{tiles[i]}:{xy[i, 0]}:{xy[i, 1]}"

    lines = []
    for p in range(n_pairs):
        nm, a, b = name(p), int(pos1[p]), int(pos2[p])
        tlen = b + L - a
        cig = "5S146M" if clip[p] else "151M"
        lines.append(f"{nm}\t99\tchr20\t{a}\t60\t{cig}\t=\t{b}\t{tlen}\t"
                     f"{seqs[sq[p]]}\t{quals[ql[p]]}\n"
                     f"{nm}\t147\tchr20\t{b}\t60\t151M\t=\t{a}\t{-tlen}\t"
                     f"{seqs[sq[p] - 1]}\t{quals[ql[p] - 1]}\n")
    spos = rng.integers(1, CHR20_LEN - L, n_singles)
    for i in range(n_singles):
        k = n_pairs + i
        lines.append(f"{name(k)}\t{16 if k % 2 else 0}\tchr20\t{spos[i]}\t60"
                     f"\t151M\t*\t0\t0\t{seqs[sq[k]]}\t{quals[ql[k]]}\n")
    for i in range(n_unmapped):
        k = n_pairs + n_singles + i
        lines.append(f"{name(k)}\t4\t*\t0\t0\t*\t*\t0\t0\t{seqs[sq[k]]}\t"
                     f"{quals[ql[k]]}\n")
    order = rng.permutation(len(lines))
    with open(path, "w") as f:
        f.write(f"@HD\tVN:1.6\tSO:unsorted\n@SQ\tSN:chr20\tLN:{CHR20_LEN}\n"
                "@PG\tID:chip_smoke\tPN:chip_smoke\n")
        for c in range(0, len(order), 100_000):
            f.writelines(lines[i] for i in order[c:c + 100_000])
    return dict(records=n_records, pairs=n_pairs, planted=n_dup,
                singles=n_singles, unmapped=n_unmapped)


def phase_sormadup_scale(tmp, n_records):
    """`sormadup` of config 3's class on the card, then on the CPU: the
    same BAM and BAI bytes; records/s and the SD_* phase times."""
    import torch
    from fgdp_tpu_torch import cli
    from fgdp_tpu_torch.utils.profiling import PROF

    sam = os.path.join(tmp, "sd.sam")
    t0 = time.time()
    counts = make_sormadup_sam(sam, n_records)
    log(f"[sormadup_scale] data: {json.dumps(counts)} on a {CHR20_LEN} bp "
        f"contig, {os.path.getsize(sam) / 2**20:.0f} MiB of SAM, made in "
        f"{time.time() - t0:.1f} s")
    out = {}
    for d in ("cuda", "cpu"):
        bam = os.path.join(tmp, f"sd_{d}.bam")
        p0 = {k: PROF.acc.get(k, 0.0) for k in SD_PHASES}
        torch.cuda.synchronize()
        t0 = time.time()
        n, ndup = cli.main(["sormadup", sam, bam, "--device", d])
        wall = time.time() - t0
        sd = {k: round(PROF.acc.get(k, 0.0) - p0[k], 3) for k in SD_PHASES}
        log(f"[sormadup_scale] {d}: {n} records, {ndup} duplicate pairs in "
            f"{wall:.2f} s = {n / wall:.0f} records/s end to end; phase s "
            f"{json.dumps(sd)}")
        with open(bam, "rb") as f, open(bam + ".bai", "rb") as g:
            out[d] = (f.read(), g.read(), n, ndup)
    same = out["cuda"] == out["cpu"]
    log(f"[sormadup_scale] card BAM and BAI equal to the CPU run's: {same} "
        f"({len(out['cuda'][0])} + {len(out['cuda'][1])} bytes)")
    if not same:
        raise AssertionError("sormadup on the card differs from the CPU")
    n, ndup = out["cuda"][2:]
    if n != counts["records"] or not counts["planted"] <= ndup \
            <= 1.1 * counts["planted"]:
        raise AssertionError(f"{n} records, {ndup} duplicate pairs for "
                             f"{counts}")


def phase_pipeline_scale(dev, tmp, ctx, batch, n_dups):
    """FASTQ -> sorted, duplicate-marked BAM on the card through
    `pipeline -t min(cpu-1, 8)`: the scale phase's reads plus `n_dups`
    planted duplicates (renamed copies of reads, new qualities) appended
    at the end, so every read keeps the id it had in the scale phase's
    `mem` run."""
    from fgdp_tpu_torch import cli
    from fgdp_tpu_torch.io import bam as bamio
    from fgdp_tpu_torch.ops import kernels
    from fgdp_tpu_torch.sortdup import driver
    from fgdp_tpu_torch.utils.profiling import PROF

    rng = np.random.default_rng(23)
    reads = ctx["reads"]
    src = np.sort(rng.choice(len(reads), n_dups, replace=False))
    dups = [(f"d{k}_" + reads[i][0].split("_", 1)[1], reads[i][1])
            for k, i in enumerate(src)]
    fq = os.path.join(tmp, "reads_dups.fq")
    lut = np.frombuffer(b"ACGTN", np.uint8)
    with open(fq, "w") as f:
        for name, s in reads:
            f.write(f"@{name}\n{lut[s].tobytes().decode()}\n+\n"
                    f"{'I' * len(s)}\n")
        for name, s in dups:
            q = "".join(chr(33 + v) for v in rng.integers(20, 41, len(s)))
            f.write(f"@{name}\n{lut[s].tobytes().decode()}\n+\n{q}\n")
    workers = min((os.cpu_count() or 2) - 1, 8)
    out = os.path.join(tmp, "pipeline.bam")
    kernels.reset_launches()
    p0 = {k: PROF.acc.get(k, 0.0) for k in ("POOL_WAIT", "SORT_FINISH")}
    with ChainLaunches() as p2, SeedLaunches() as sl:
        t0 = time.time()
        n, nrec, ndup = cli.main(["pipeline", ctx["prefix"], fq, "-O", out,
                                  "-t", str(workers), "-b", str(batch)])
        wall = time.time() - t0
    launches = {k: kernels.LAUNCHES[k] for k in MEM_KERNELS}
    waits = {k: round(PROF.acc.get(k, 0.0) - p0[k], 2) for k in p0}
    log(f"[pipeline_scale] {n} reads -> {nrec} records, {ndup} duplicates "
        f"in {wall:.2f} s = {n / wall:.1f} reads/s end to end ({workers} "
        f"finalize workers, batch {batch}); launches {launches}; s "
        f"{json.dumps(waits)}")
    p2.report("pipeline_scale", wall)
    sl.report("pipeline_scale", wall)

    # the mem SAM of the same reads: the scale phase's lines, and the
    # planted copies aligned with the ids they have in the stream
    names = [d[0] for d in dups]
    seqs = [d[1].astype(np.int64) for d in dups]
    with open(fq) as f:
        quals = f.read().splitlines()[4 * len(reads) + 3::4]
    mem = ctx["lines"] + ctx["aligner"].align_batch(names, seqs, quals,
                                                    id0=len(reads))
    ref_bam = os.path.join(tmp, "mem_sorted.bam")
    driver.sort_markdup(ctx["aligner"].sam_header() + mem, ref_bam,
                        device=dev)
    _, _, _, got = bamio.read_bam(out)
    _, _, _, want = bamio.read_bam(ref_bam)
    keys = [(r["rid"] if r["rid"] >= 0 else 1 << 30, r["pos"]) for r in got]

    def by_name(recs):
        out = {}
        for r in recs:
            out.setdefault(r["qname"], []).append(
                tuple(sorted({**r, "flag": r["flag"] & ~0x400}.items())))
        return {q: sorted(v) for q, v in out.items()}

    g, w = by_name(got), by_name(want)
    diff = sorted(q for q in set(g) | set(w) if g.get(q) != w.get(q))
    # a read still overflowed after the last rung keeps the widest caps'
    # cut-short alignment, which depends on the reads it shared that
    # rung's batch with: the stream defers escalated reads into other
    # batches than `mem` runs them in (the JAX package's design)
    cut = {q for q, s in reads + dups if Unresolved.has(s)}
    other = [q for q in diff if q not in cut]
    for q in (other or diff)[:3]:
        a, b = (dict(x[0]) if x else {} for x in (g.get(q), w.get(q)))
        log(f"[pipeline_scale] differs: {q}: " + "; ".join(
            f"{k} {a.get(k)!r} vs {b.get(k)!r}" for k in sorted(set(a) |
                                                              set(b))
            if a.get(k) != b.get(k)))
    # planted pairs whose two reads the mem SAM places alike (same
    # contig, position, strand and CIGAR): exactly one of them is marked
    prim = {r["qname"]: r for r in got if not r["flag"] & 0x904}
    pairs = [(reads[i][0], names[k]) for k, i in enumerate(src)]
    alike = [(a, b) for a, b in pairs if a in prim and b in prim and all(
        prim[a][k] == prim[b][k] for k in ("rid", "pos", "cigar")) and
        (prim[a]["flag"] ^ prim[b]["flag"]) & 0x10 == 0]
    dup = {q: bool(r["flag"] & 0x400) for q, r in prim.items()}
    one = sum(dup[a] != dup[b] for a, b in alike)
    planted = set(sum(map(list, pairs), []))
    natural = sum(v for q, v in dup.items() if q not in planted)
    log(f"[pipeline_scale] {len(got)} records in coordinate order: "
        f"{keys == sorted(keys)}; reads whose records differ from the mem "
        f"SAM of the same reads (flags aside): {len(diff)}, all but "
        f"{len(other)} among the {len(cut)} reads still overflowed after "
        f"the last rung; planted pairs "
        f"placed alike {len(alike)}/{n_dups}, with exactly one of the two "
        f"marked {one}; duplicates outside the planted pairs {natural}")
    if len(got) != nrec or nrec != len(mem) or n != len(reads) + n_dups:
        raise AssertionError(f"{len(got)} records in the BAM, {nrec} "
                             f"written, {len(mem)} in the mem SAM")
    if keys != sorted(keys) or other:
        raise AssertionError("pipeline BAM out of order or unlike mem")
    if one < 0.98 * len(alike) or len(alike) < 0.8 * n_dups or \
            natural > 0.01 * len(reads):
        raise AssertionError(f"duplicates: {one} of {len(alike)} planted "
                             f"pairs marked, {natural} others")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched in pipeline")


def write_pair_fastqs(tmp, pairs):
    """r1.fq and r2.fq of sim_pairs' pairs (both ends under the pair's
    name, quality I)."""
    lut = np.frombuffer(b"ACGTN", np.uint8)
    paths = [os.path.join(tmp, f"pe_r{k}.fq") for k in (1, 2)]
    with open(paths[0], "w") as f1, open(paths[1], "w") as f2:
        for name, r1, r2 in pairs:
            for f, r in ((f1, r1), (f2, r2)):
                f.write(f"@{name}\n{lut[r].tobytes().decode()}\n+\n"
                        f"{'I' * len(r)}\n")
    return paths


def pe_placement(lines, n_pairs):
    """Primary records of a PE SAM: (properly paired share, confident
    ends at their true position share, bait ends at their true position
    share and count). An end is at its true position within 10 bp."""
    prim = [ln.split("\t") for ln in lines
            if ln and not ln.startswith("@")
            and not int(ln.split("\t")[1]) & 0x900]
    if len(prim) != 2 * n_pairs:
        raise AssertionError(f"{len(prim)} primary records for {n_pairs} "
                             "pairs")
    proper = conf = right = bait_n = bait_right = 0
    for f in prim:
        flag = int(f[1])
        _, p1, p2, b = f[0].split("_")
        end = 1 if flag & 0x40 else 2
        truth = int(p1 if end == 1 else p2)
        here = not flag & 4 and abs(int(f[3]) - truth) <= 10
        proper += bool(flag & 2)
        if not flag & 4 and int(f[4]) >= 20:
            conf += 1
            right += here
        if int(b) == end:
            bait_n += 1
            bait_right += here
    return (proper / len(prim), right / max(conf, 1), conf,
            bait_right / max(bait_n, 1), bait_n)


def phase_pe_scale(dev, rates, tmp, ctx, n_pairs, batch):
    """BASELINE config 2's class (paired-end 150 bp reads, one card) on
    the scale phase's 4.6 Mb index: sim_pairs' pairs (seed 31) through
    `mem` in-process, then `pipeline -t min(cpu-1, 8)` on the first
    PE_PIPELINE_PAIRS of them, whose workers rescue mates on the card;
    then the first PE_CPU_PAIRS pairs on the card and on the CPU. Returns the in-process run's launches and kswv's row of the
    kernels line, timed on one of that run's launches."""
    import torch
    from fgdp_tpu_torch import cli
    from fgdp_tpu_torch.io import bam as bamio
    from fgdp_tpu_torch.ops import kernels, kswv
    from fgdp_tpu_torch.pipeline_stream import POOL_KSWV, stream_mem
    from fgdp_tpu_torch.utils.profiling import PROF, WORKER_SAM

    t0 = time.time()
    pairs = sim_pairs(gen_genome(4_600_000, seed=0), n_pairs, 151, seed=31)
    fqs = write_pair_fastqs(tmp, pairs)
    log(f"[pe_scale] data: {n_pairs} pairs of 2 x 151 bp, insert "
        f"N(400, 40), {sum(p[0][-1] != '0' for p in pairs)} pairs with a "
        f"baited end, made in {time.time() - t0:.1f} s")

    aligner = ctx["aligner"]
    aligner.stage_ms = {}
    aligner.esc_stage_ms = {}
    esc0 = aligner.esc_reads
    fin0 = PROF.acc.get(WORKER_SAM, 0.0)
    lines = []
    w0 = dict(kswv.WORK)
    # every kswv launch of the run: its card inputs and outputs, held
    # against the plain version after the run
    seen = []
    real = kswv.kswv_forward_kernel

    def spy(*args, **kw):
        out = real(*args, **kw)
        seen.append((args, out))
        return out

    kernels.reset_launches()
    kernels.TIMED["kswv"] = []
    kswv.kswv_forward_kernel = spy
    try:
        with SeedLaunches() as sl, FltLaunches() as d5, \
                FirstChainCall() as cc:
            torch.cuda.synchronize()
            t0 = time.time()
            n = stream_mem(aligner, cli.read_batches(fqs, batch),
                           lines.append, paired=True)
            torch.cuda.synchronize()
            wall = time.time() - t0
        k_ms = sum(a.elapsed_time(b) for a, b in kernels.TIMED["kswv"])
    finally:
        kswv.kswv_forward_kernel = real
        kernels.TIMED.pop("kswv", None)
    launches = {k: kernels.LAUNCHES[k] for k in PE_KERNELS}
    jobs, cells = (kswv.WORK[k] - w0[k] for k in ("jobs", "cells"))
    proper, right, conf, bait_right, bait_n = pe_placement(lines, n_pairs)
    log(f"[pe_scale] mem: {n_pairs} pairs ({n} reads) in {wall:.2f} s = "
        f"{n_pairs / wall:.1f} pairs/s, {n / wall:.1f} reads/s end to end "
        f"(batch {batch} reads); launches {launches}")
    n_batches = -(-n // batch)
    log(f"[pe_scale] per batch ms: "
        f"{json.dumps({k: round(v / n_batches, 3) for k, v in aligner.stage_ms.items()})}"
        f"; host finalize (rescue and pairing included) "
        f"{1e3 * (PROF.acc.get(WORKER_SAM, 0.0) - fin0) / n_batches:.1f}; "
        f"escalated stage ms total "
        f"{json.dumps({k: round(v, 1) for k, v in aligner.esc_stage_ms.items()})}"
        f"; escalated reads {aligner.esc_reads - esc0}")
    log(f"[pe_scale] kswv (D6) on the mem path: {launches['kswv']} "
        f"launches, {jobs} jobs, {cells} cells, {k_ms:.3f} ms of kernel "
        f"time (CUDA events its C entry point records around each launch)"
        f" = {100 * k_ms / (1e3 * wall):.4f}% of the wall")
    sl.report("pe_scale", wall)
    d5.report("pe_scale", wall)
    chain_split_report("pe_scale", cc.args)
    row = pe_kswv_launches(seen, rates)
    del seen
    log(f"[pe_scale] properly paired {proper:.4f}; MAPQ>=20 ends {conf}, "
        f"of which at the true position {right:.4f}; bait ends at their "
        f"true position {bait_right:.4f} of {bait_n}")
    if right < 0.95:
        raise AssertionError("pe_scale placed too few confident ends "
                             "correctly")
    for k, v in launches.items():
        if v <= 0:
            raise AssertionError(f"kernel {k} never launched on the "
                                 "paired-end mem path")

    # `pipeline -t` PE on the first PE_PIPELINE_PAIRS pairs
    workers = min((os.cpu_count() or 2) - 1, 8)
    n_pipe = min(PE_PIPELINE_PAIRS, n_pairs)
    sub = os.path.join(tmp, "pe_pipeline")
    os.makedirs(sub, exist_ok=True)
    fqs = write_pair_fastqs(sub, pairs[:n_pipe])
    out = os.path.join(tmp, "pe_pipeline.bam")
    p0 = dict(POOL_KSWV)
    w_acc = {k: PROF.acc.get(k, 0.0) for k in ("POOL_WAIT", "SORT_FINISH")}
    kernels.reset_launches()
    # the pool's workers record events around their launches
    kernels.TIMED["kswv"] = []
    try:
        t0 = time.time()
        n, nrec, ndup = cli.main(["pipeline", ctx["prefix"], *fqs, "-O",
                                  out, "-t", str(workers), "-b", str(batch)])
        wall = time.time() - t0
    finally:
        kernels.TIMED.pop("kswv", None)
    pool = {k: POOL_KSWV[k] - p0[k] for k in POOL_KSWV}
    waits = {k: round(PROF.acc.get(k, 0.0) - w_acc[k], 2) for k in w_acc}
    log(f"[pe_scale] pipeline: {n_pipe} pairs -> {nrec} records, {ndup} "
        f"duplicates in {wall:.2f} s = {n_pipe / wall:.1f} pairs/s, "
        f"{n / wall:.1f} reads/s end to end ({workers} finalize workers on "
        f"the card); aligner launches "
        f"{ {k: kernels.LAUNCHES[k] for k in MEM_KERNELS} }; s "
        f"{json.dumps(waits)}")
    log(f"[pe_scale] kswv in the workers: {pool['launches']} launches, "
        f"{pool['jobs']} jobs, {pool['cells']} cells, {pool['ms']:.3f} ms "
        "of kernel time (events each worker's launches record)")
    _, _, _, got = bamio.read_bam(out)
    keys = [(r["rid"] if r["rid"] >= 0 else 1 << 30, r["pos"]) for r in got]
    piped = {p[0] for p in pairs[:n_pipe]}
    n_sam = sum(1 for ln in lines if ln and not ln.startswith("@")
                and ln.split("\t", 1)[0] in piped)
    log(f"[pe_scale] BAM: {len(got)} records (mem SAM {n_sam}), in "
        f"coordinate order: {keys == sorted(keys)}")
    if len(got) != nrec or nrec != n_sam or keys != sorted(keys):
        raise AssertionError("pe_scale BAM unlike the mem run or out of "
                             "order")
    if pool["launches"] <= 0:
        raise AssertionError("kswv never launched in the pipeline's "
                             "workers")

    # the first PE_CPU_PAIRS pairs, one batch, on the card and on the CPU
    names = [x for p in pairs[:PE_CPU_PAIRS] for x in (p[0], p[0])]
    seqs = [x.astype(np.int64) for p in pairs[:PE_CPU_PAIRS]
            for x in p[1:]]
    quals = ["I" * 151] * len(seqs)
    t0 = time.time()
    card = aligner.align_pairs(names, seqs, quals)
    cpu_al = cli.load_aligner(ctx["prefix"], batch, device="cpu")
    cpu = cpu_al.align_pairs(names, seqs, quals)
    log(f"[pe_scale] first {PE_CPU_PAIRS} pairs: card SAM equal to the "
        f"CPU's: {card == cpu} ({len(card)} lines, "
        f"{time.time() - t0:.1f} s)")
    if card != cpu:
        raise AssertionError(f"the card's SAM of the first {PE_CPU_PAIRS} "
                             "pairs differs from the CPU run")
    return launches, row


def pe_kswv_launches(seen, rates):
    """pe_scale `mem`'s kswv launches, each (inputs, outputs) on the card:
    their (J, QP, TP), every launch's outputs held exactly against the
    plain version on its inputs, and the kernels line's row from the
    most common shape (the launch with the most cells among them)."""
    from collections import Counter

    shape = lambda a: (a[0].shape[0], a[0].shape[1], a[2].shape[1])
    cells = lambda a: int((a[1].long() * a[3].long()).sum())
    hist = Counter(shape(a) for a, _ in seen)
    log(f"[pe_scale] kswv launches by (J, QP, TP): "
        + ", ".join(f"{k}: {v}" for k, v in sorted(hist.items())))
    for i, (args, got) in enumerate(seen):
        kswv_hold(f"pe_scale launch {i}", args, got)
    log(f"[pe_scale] every kswv launch of the mem run equals the plain "
        f"version on its inputs ({len(seen)} launches, all four outputs)")
    top = max(hist.values())
    args = max((a for a, _ in seen if hist[shape(a)] == top), key=cells)
    return kswv_row("pe_scale", args, rates)


def bqsr_report():
    """tests/test_bqsr.py's REPORT, read from the file's source (the test
    module imports the JAX package)."""
    import ast
    with open(os.path.join(ROOT, "tests", "test_bqsr.py")) as f:
        tree = ast.parse(f.read())
    for node in tree.body:
        if isinstance(node, ast.Assign) and \
                getattr(node.targets[0], "id", None) == "REPORT":
            return ast.literal_eval(node.value)
    raise AssertionError("tests/test_bqsr.py has no REPORT")


def vcf_sites(path):
    """(CHROM, POS, REF, ALT) of a VCF's records, as
    tests/test_cnn_gate.py's A/B compares them."""
    with open(path) as f:
        return {tuple(ln.split("\t")[:2] + ln.split("\t")[3:5])
                for ln in f if ln.strip() and not ln.startswith("#")}


def vcf_max_diff(path_a, path_b):
    """The records' largest number difference (relative above 1), or
    None when the records differ in anything but numbers."""
    import re
    num = r"-?\d+(?:\.\d+)?(?:e-?\d+)?"
    rec = lambda p: [ln for ln in open(p).read().splitlines()
                     if not ln.startswith("##")]
    a, b = rec(path_a), rec(path_b)
    if len(a) != len(b) or any(re.sub(num, "#", x) != re.sub(num, "#", y)
                               for x, y in zip(a, b)):
        return None
    return max((abs(float(u) - float(v)) / max(1.0, abs(float(u)))
                for x, y in zip(a, b)
                for u, v in zip(re.findall(num, x), re.findall(num, y))),
               default=0.0)


# the gate's scores on the card against the CPU forward of the same rows:
# float32's step just below 1.0 is 6e-8, so summation order moves a score
# by a few of them; a reduced-precision forward keeps 10 (TF32) or 7
# (bfloat16) mantissa bits, steps of 1e-3 or more
GATE_SCORE_TOL = 1e-6


def phase_mutect_options(dev, tmp):
    """`mutect`'s options on the card: ungated on the 120x fixture
    tests/golden/mutect_cnn (sites equal golden_nogate.vcf); with
    --deep-model, a seeded TorchScript gate saved here (every forward's
    rows held against the CPU forward of the same rows: the same
    keep/drop decision and a score within GATE_SCORE_TOL, row for row);
    and with --bqsr-tumor/--bqsr-normal on tests/golden/mutect, the
    card's VCF equal to the port's CPU VCF (numbers within 1e-3)."""
    import torch
    from fgdp_tpu_torch import cli
    from fgdp_tpu_torch.call import cnn_filter
    from fgdp_tpu_torch.ops import kernels

    helpers = load_file("tests/test_torch_cuda.py")
    fix = os.path.join(GOLDEN, "mutect_cnn")
    base = ["mutect", "-R", os.path.join(fix, "ref.fa"),
            "-I", os.path.join(fix, "tumor.bam"),
            "-N", os.path.join(fix, "normal.bam")]
    nogate = os.path.join(tmp, "mo_nogate.vcf")
    kernels.reset_launches()
    t0 = time.time()
    cli.main(base + ["-O", nogate])
    wall = time.time() - t0
    want = vcf_sites(os.path.join(fix, "golden_nogate.vcf"))
    got = vcf_sites(nogate)
    log(f"[mutect_options] ungated mutect_cnn: {len(got)} sites in "
        f"{wall:.2f} s, pairhmm launches {kernels.LAUNCHES['pairhmm']}; "
        f"sites equal golden_nogate.vcf's {len(want)}: {got == want}")
    if got != want:
        raise AssertionError(f"ungated sites differ from golden_nogate.vcf:"
                             f" {sorted(got ^ want)}")

    model = helpers.gate_model(os.path.join(tmp, "gate.pt"), 2, scale=400.0)
    seen = []
    inner = cnn_filter.CnnFilter.scores

    def spy(self, inputs):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        out = inner(self, inputs)
        ev[1].record()
        ev[1].synchronize()
        seen.append((inputs, out, ev[0].elapsed_time(ev[1])))
        return out

    gated = os.path.join(tmp, "mo_gate.vcf")
    cnn_filter.CnnFilter.scores = spy
    try:
        kernels.reset_launches()
        t0 = time.time()
        cli.main(base + ["-O", gated, "--deep-model", model])
        wall = time.time() - t0
    finally:
        cnn_filter.CnnFilter.scores = inner
    p3 = kernels.LAUNCHES["pairhmm"]
    cpu = cnn_filter.CnnFilter(model, device="cpu")
    rows = sum(len(x) for x, _, _ in seen)
    kept = sum(bool(cnn_filter.passes(s).any()) for _, s, _ in seen)
    differ, far, err = 0, 0, 0.0
    for i, (x, card_s, _) in enumerate(seen):
        cpu_s = cpu.scores(x)
        err = max(err, float(np.abs(card_s - cpu_s).max()))
        off = np.abs(card_s - cpu_s) > GATE_SCORE_TOL
        for r in np.flatnonzero(off | (cnn_filter.passes(card_s)
                                       != cnn_filter.passes(cpu_s))):
            differ += int(cnn_filter.passes(card_s[r])
                          != cnn_filter.passes(cpu_s[r]))
            far += int(off[r])
            log(f"[mutect_options] gated region {i} row {r}: card "
                f"{card_s[r]!r}, CPU {cpu_s[r]!r} (threshold "
                f"{cnn_filter.THRESHOLD!r})")
    ms = [m for _, _, m in seen]
    g_sites = vcf_sites(gated)
    log(f"[mutect_options] --deep-model: {len(seen)} regions gated "
        f"({rows} rows), {kept} kept, {len(seen) - kept} dropped; "
        f"{len(g_sites)} sites in {wall:.2f} s, pairhmm launches {p3}; "
        f"forward (rows to the card, forward, scores back; CUDA events) "
        f"{sum(ms):.3f} ms over {len(ms)} calls, "
        f"{np.median(ms) if ms else 0:.3f} ms median; card decisions equal "
        f"the CPU forward's on every row: {differ == 0}; scores within "
        f"{GATE_SCORE_TOL:g} of the CPU's: {far == 0} (largest difference "
        f"{err!r})")
    if differ or far:
        raise AssertionError(f"{differ} gate rows decided differently on "
                             f"the card and the CPU, {far} scored more than "
                             f"{GATE_SCORE_TOL:g} apart")
    if not (seen and 0 < kept < len(seen) and g_sites < got and p3 > 0):
        raise AssertionError("the gate did not keep some regions and drop "
                             "others on mutect_cnn")

    mt = os.path.join(GOLDEN, "mutect")
    report = bqsr_report()
    flags = []
    for rg in ("tumor", "normal"):
        path = os.path.join(tmp, f"{rg}.recal")
        with open(path, "w") as f:
            f.write(helpers.recal_report(report, rg))
        flags += [f"--bqsr-{rg}", path]
    base = ["mutect", "-R", os.path.join(mt, "ref.fa"),
            "-I", os.path.join(mt, "tumor.bam"),
            "-N", os.path.join(mt, "normal.bam")] + flags
    out = {}
    for d in ("cuda", "cpu"):
        out[d] = os.path.join(tmp, f"mo_bqsr_{d}.vcf")
        kernels.reset_launches()
        t0 = time.time()
        cli.main(base + ["-O", out[d], "--device", d])
        log(f"[mutect_options] --bqsr-tumor/--bqsr-normal on {d}: "
            f"{len(vcf_sites(out[d]))} sites in {time.time() - t0:.2f} s, "
            f"pairhmm launches {kernels.LAUNCHES['pairhmm']}")
        if d == "cuda":
            p3 = kernels.LAUNCHES["pairhmm"]
    diff = vcf_max_diff(out["cuda"], out["cpu"])
    with open(out["cuda"]) as f:
        recal = "MBQ=37" not in f.read()
    log(f"[mutect_options] BQSR card VCF equal to the CPU's, numbers "
        f"within 1e-3: {diff is not None and diff <= 1e-3} (largest "
        f"difference {diff}); no site keeps quality 37: {recal}")
    if diff is None or diff > 1e-3 or not recal or p3 <= 0:
        raise AssertionError("BQSR mutect on the card differs from the CPU")


def by_qname(lines):
    """SAM records grouped by QNAME (a read's or a pair's lines)."""
    out = {}
    for ln in lines:
        out.setdefault(ln.split("\t", 1)[0], []).append(ln)
    return out


def two_contig_pairs(pref, n_pairs, L):
    """sim_pairs' pairs from each of the reference's two contigs in
    turn (n_pairs / 2 each, seeds 41 and 43), interleaved [r1_0, r2_0,
    ...] under unique names."""
    names, seqs = [], []
    for cid, seed in ((0, 41), (1, 43)):
        lo, hi = int(pref.offsets[cid]), int(pref.offsets[cid + 1])
        for name, r1, r2 in sim_pairs(pref.codes[lo:hi], n_pairs // 2, L,
                                      seed=seed):
            names += [f"c{cid}{name}"] * 2
            seqs += [np.asarray(r1, np.int64), np.asarray(r2, np.int64)]
    return names, seqs


def sortdup_keys(rng, nd, ns, ref_len):
    """Duplicate-marking keys as tests/test_sortdup_sharded.py's _mk_args
    makes them (every 7th double and single copies its neighbour's key,
    some singles land on double ends), as int64 tensors' numpy."""
    def dup_some(a):
        a = a.copy()
        a[1::7] = a[0::7][:len(a[1::7])]
        return a
    p5a = dup_some(rng.integers(0, ref_len // 2, nd))
    p5b = dup_some(p5a + rng.integers(50, 500, nd))
    orient = dup_some(rng.integers(0, 4, nd))
    s_p5 = dup_some(rng.integers(0, ref_len // 2, ns))
    s_rev = np.where(np.arange(ns) % 2 == 0, 3, 0)
    k = ns // 64
    s_p5[:k] = p5a[:k]
    s_rev[:k] = np.where(orient[:k] >= 2, 3, 0)
    i32 = lambda n, hi: rng.integers(0, hi, n).astype(np.int32)
    return dict(dbl_p5a=p5a, dbl_orient=orient.astype(np.int32),
                dbl_p5b=p5b, dbl_score=i32(nd, 1000),
                dbl_tile=i32(nd, 100), dbl_x=i32(nd, 10000),
                dbl_y=i32(nd, 10000), dbl_valid=rng.random(nd) < 0.99,
                sgl_p5=s_p5, sgl_rev=s_rev.astype(np.int32),
                sgl_score=i32(ns, 1000), sgl_tile=i32(ns, 100),
                sgl_x=i32(ns, 10000), sgl_y=i32(ns, 10000),
                sgl_valid=rng.random(ns) < 0.99)


def phase_sharded(dev, tmp, n_reads, n_pairs):
    """The contig-sharded aligner on the card:
    tests/test_sharded_index.py's two random contigs (120 kb + 150 kb,
    seed 7) in two shards; n_reads single-end reads and n_pairs pairs
    (sim_pairs', 5% with a baited end), SAM equal to the joint Aligner's
    on the card for every read (pair) the joint run's ladder resolves.
    The records of a read the joint ladder leaves overflowed depend on
    the reads that share its escalation buckets, which the shards fill
    differently (ROADMAP queue 3): each that differs is held against the
    joint Aligner on the batch without the other overflowed reads.
    Reads/s of both, P1, P2 and D6 launches of the sharded runs.
    ShardedAligner(lcp=False) (the sweep, no LCP tree a shard): SAM equal
    to the lcp=True aligner's on every read (pair) that both its ladder
    and the joint one resolve. Then NCCL at world size 1: sharded duplicate marking and coordinate sort
    of 1,000,000 records' keys equal to the single-device engine on the
    card, and the 2-D (dp, fm) mesh: shard_index + shard_align_fn_2d on
    the SE batch, packed regs equal to the unsharded device_align's."""
    import functools
    import socket

    import torch
    import torch.distributed as dist
    from fgdp_tpu_torch.config import BatchShapes
    from fgdp_tpu_torch.index.fmindex import FMIndex
    from fgdp_tpu_torch.ops import kernels
    from fgdp_tpu_torch.parallel import distributed as D
    from fgdp_tpu_torch.parallel import mesh as M
    from fgdp_tpu_torch.parallel import sortdup_sharded as shd
    from fgdp_tpu_torch.parallel.sharded_index import ShardedAligner
    from fgdp_tpu_torch.pipeline import (Aligner, device_align_packed,
                                         unpack_regs)
    from fgdp_tpu_torch.sortdup import engine

    helpers = load_file("tests/test_torch_cuda.py")
    L = 151
    pref, make = helpers.two_contigs(120_000, 150_000, L)
    names, seqs = make(n_reads)
    pnames, pseqs = two_contig_pairs(pref, n_pairs, L)
    shapes = BatchShapes(batch_reads=max(n_reads, 2 * n_pairs))
    t0 = time.time()
    sharded = ShardedAligner(pref, 2, shapes=shapes, device=dev)
    joint = Aligner(pref, FMIndex.build(pref.codes), shapes=shapes,
                    device=dev)
    log(f"[sharded] {pref.l_pac} bp in {len(sharded.shards)} shards "
        f"{sharded.groups}; shard and joint indexes in "
        f"{time.time() - t0:.1f} s; batch {shapes.batch_reads}")
    out, rate, left = {}, {}, []
    inner = joint._device_regs

    def spy(seq_codes):
        regs = inner(seq_codes)
        left.append(regs["overflow"])
        return regs

    joint._device_regs = spy

    def left_of(al):
        """Record the merged overflow flags of a sharded aligner's runs."""
        flags, inner_al = [], al._device_regs

        def spy_al(seq_codes):
            regs = inner_al(seq_codes)
            flags.append(regs["overflow"])
            return regs

        al._device_regs = spy_al
        return flags

    sh_left = left_of(sharded)
    for name, al in (("sharded", sharded), ("joint", joint)):
        kernels.reset_launches()
        for mode, fn, args in (("SE", al.align_batch, (names, seqs)),
                               ("PE", al.align_pairs, (pnames, pseqs))):
            torch.cuda.synchronize()
            t0 = time.time()
            out[name, mode] = fn(*args)
            torch.cuda.synchronize()
            rate[name, mode] = len(args[1]) / (time.time() - t0)
        launches = {k: kernels.LAUNCHES[k] for k in PE_KERNELS}
        esc = sum(sh.esc_reads for sh in sharded.shards) \
            if name == "sharded" else joint.esc_reads
        log(f"[sharded] {name}: SE {rate[name, 'SE']:.1f} reads/s, PE "
            f"{rate[name, 'PE']:.1f} reads/s ({len(seqs)} reads, "
            f"{len(pseqs) // 2} pairs); escalated reads {esc}; launches "
            f"{launches}")
        if name == "sharded":
            sh_launches = launches
    cut = {"SE": {names[i] for i in np.flatnonzero(left[0])},
           "PE": {pnames[i] for i in np.flatnonzero(left[1])}}
    bad = 0
    for m, fn, nm, sq in (("SE", joint.align_batch, names, seqs),
                          ("PE", joint.align_pairs, pnames, pseqs)):
        a, b = (by_qname(out[k, m]) for k in ("sharded", "joint"))
        differ = {q for q in a.keys() | b.keys() if a.get(q) != b.get(q)}
        odd = differ & cut[m]
        unit = "reads" if m == "SE" else "pairs"
        log(f"[sharded] {m} SAM equal to the joint Aligner's: "
            f"{out['sharded', m] == out['joint', m]}; for the "
            f"{len(a.keys() - cut[m])} {unit} the joint ladder resolves: "
            f"{not differ - cut[m]}; of the {len(cut[m])} it leaves "
            f"overflowed, {len(odd)} differ {sorted(odd)[:4]}")
        bad += len(differ - cut[m])
        if not odd:
            continue
        # witness for those: the joint aligner on the batch without the
        # other overflowed reads, whose ladder buckets they no longer share
        keep = [i for i, q in enumerate(nm) if q not in cut[m] - odd]
        w = by_qname(fn([nm[i] for i in keep], [sq[i] for i in keep]))
        sided = {q for q in odd if w.get(q) == a.get(q)}
        bad += len(odd - sided)
        log(f"[sharded] witness: the joint Aligner on the {m} batch without "
            f"the {len(cut[m] - odd)} other {unit} its ladder leaves "
            f"overflowed ({len(keep)} reads) gives {len(sided)} of the "
            f"{len(odd)} differing {unit} the sharded records "
            f"{sorted(sided)[:4]}; the rest of that batch equal to the "
            f"joint run's: {all(w[q] == b[q] for q in w.keys() - odd)}")
    placed = sum(ln.split("\t")[2] != "*" for ln in out["sharded", "SE"]
                 if not int(ln.split("\t")[1]) & 0x900)
    log(f"[sharded] {placed}/{len(seqs)} SE reads placed")
    if bad or placed < 0.95 * len(seqs):
        raise AssertionError("the sharded aligner's SAM differs from the "
                             "joint aligner's")
    if min(sh_launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the sharded "
                             f"path: {sh_launches}")

    # ---- the sweep's shards (lcp=False: no LCP tree a shard) ----
    t0 = time.time()
    sweep = ShardedAligner(pref, 2, lcp=False, shapes=shapes, device=dev)
    if any(sh.lcp_tree is not None for sh in sweep.shards):
        raise AssertionError("ShardedAligner(lcp=False) built an LCP tree")
    sw_left = left_of(sweep)
    kernels.reset_launches()
    sw_out = {"SE": sweep.align_batch(names, seqs),
              "PE": sweep.align_pairs(pnames, pseqs)}
    torch.cuda.synchronize()
    sw_launches = {k: kernels.LAUNCHES[k] for k in SWEEP_KERNELS}
    log(f"[sharded] ShardedAligner(lcp=False): SE and PE in "
        f"{time.time() - t0:.1f} s with its shards' indexes; escalated "
        f"reads {sum(sh.esc_reads for sh in sweep.shards)}; launches "
        f"{sw_launches}")
    # lcp=True's merged flag is set on nearly every read (each overflows
    # in the other contig's shard and runs its whole ladder there), so
    # the joint ladder's flags (which lcp=True's SAM equals on the reads
    # they clear, above) stand in for its ladder
    bad = 0
    for i, (m, nm) in enumerate((("SE", names), ("PE", pnames))):
        either = left[i] | sw_left[i]
        both_ok = set(nm) - {q for q, f in zip(nm, either) if f}
        a, b = by_qname(sw_out[m]), by_qname(out["sharded", m])
        differ = {q for q in both_ok if a.get(q) != b.get(q)}
        unit = "reads" if m == "SE" else "pairs"
        log(f"[sharded] {m}: ShardedAligner(lcp=False) SAM equal to "
            f"lcp=True's for {len(both_ok) - len(differ)} of the "
            f"{len(both_ok)} {unit} both ladders resolve "
            f"{sorted(differ)[:4]}; the sweep's ladder leaves "
            f"{int(sw_left[i].sum())} reads overflowed, lcp=True's "
            f"{int(sh_left[i].sum())} (its merged flag), the joint's "
            f"{int(left[i].sum())}; all equal: "
            f"{sw_out[m] == out['sharded', m]}")
        bad += len(differ) + (len(both_ok) < 0.5 * len(set(nm)))
    if bad or min(sw_launches.values()) <= 0:
        raise AssertionError("ShardedAligner(lcp=False) differs from "
                             "ShardedAligner(lcp=True), or a kernel never "
                             f"launched on its path: {sw_launches}")

    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    backend = D.backend_for(dev)
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        mesh = D.global_mesh({"sp": 1}, device=dev)
        # the communicator is set up at the first collective: outside
        # the timed calls
        t0 = time.time()
        dist.all_reduce(torch.zeros(1, device=dev))
        torch.cuda.synchronize()
        t_init = time.time() - t0
        rng = np.random.default_rng(53)
        ref_len = CHR20_LEN
        keys = sortdup_keys(rng, 400_000, 200_000, ref_len)
        t = {k: torch.as_tensor(v, device=dev) for k, v in keys.items()}
        n_rec = 2 * 400_000 + 200_000
        torch.cuda.synchronize()
        t0 = time.time()
        dd, ds, ovf = shd.sharded_mark_duplicates(
            mesh, dict(t, ref_len=ref_len), 2 * ref_len)
        torch.cuda.synchronize()
        t_sh = time.time() - t0
        t0 = time.time()
        wd, ws = engine.mark_duplicates(**t, ref_len=ref_len)
        torch.cuda.synchronize()
        t_one = time.time() - t0
        dup_same = bool(dd.equal(wd) and ds.equal(ws)) and not ovf
        uc = torch.as_tensor(rng.integers(0, 2 * ref_len, 1_000_000),
                             device=dev)
        uc[1::9] = uc[0::9][:len(uc[1::9])]
        valid = torch.as_tensor(rng.random(1_000_000) < 0.99, device=dev)
        torch.cuda.synchronize()
        t0 = time.time()
        order, sovf = shd.sharded_coordinate_sort(mesh, uc, valid,
                                                  2 * ref_len)
        torch.cuda.synchronize()
        s_sh = time.time() - t0
        t0 = time.time()
        want = engine.coordinate_sort_order(uc, valid)[:int(valid.sum())]
        torch.cuda.synchronize()
        s_one = time.time() - t0
        sort_same = bool(order.equal(want)) and not sovf

        # the index-sharding half of mesh.py: a (dp 1, fm 1) mesh, the
        # joint index's FM tables sharded over fm, one batch of the SE
        # reads through shard_align_fn_2d against device_align
        mesh2 = M.make_mesh_2d(fm_ways=2, device=dev)
        sh_dfm = M.shard_index(mesh2, joint.dfm)
        fn = functools.partial(device_align_packed, opt=joint._dev_opt,
                               shapes=joint.shapes, lcp_tree=joint.lcp_tree,
                               lcp_isa=joint.lcp_isa)
        codes = np.full((len(seqs), L), 4, np.int32)
        for i, s in enumerate(seqs):
            codes[i, :len(s)] = s[:L]
        lens = np.array([min(len(s), L) for s in seqs], np.int32)
        active = np.ones(len(seqs), bool)
        torch.cuda.synchronize()
        t0 = time.time()
        got = M.gathered_regs(M.shard_align_fn_2d(fn, mesh2)(
            sh_dfm, joint.dref, codes, lens, active))
        torch.cuda.synchronize()
        m_sh = time.time() - t0
        t0 = time.time()
        whole = unpack_regs(fn(joint.dfm, joint.dref, *(
            torch.as_tensor(a, device=dev) for a in (codes, lens, active)))
            .cpu().numpy())
        m_one = time.time() - t0
        mesh_same = got.keys() == whole.keys() and all(
            np.array_equal(got[k], whole[k]) for k in whole)
    finally:
        dist.destroy_process_group()
    log(f"[sharded] {backend} world size 1: the first collective (the "
        f"communicator's set-up) {1e3 * t_init:.1f} ms")
    log(f"[sharded] {backend} world size 1: duplicate marking of {n_rec} "
        f"records' keys {1e3 * t_sh:.1f} ms sharded, {1e3 * t_one:.1f} ms "
        f"single-device; {int(wd.sum())} + {int(ws.sum())} duplicates, "
        f"flags equal: {dup_same}; coordinate sort of 1000000 records "
        f"{1e3 * s_sh:.1f} ms sharded, {1e3 * s_one:.1f} ms single-device, "
        f"order equal: {sort_same}")
    log(f"[sharded] {backend} world size 1, 2-D mesh {tuple(mesh2.shape)} "
        f"(dp, fm): shard_align_fn_2d on the fm-sharded index, "
        f"{len(seqs)} reads in {m_sh:.2f} s, device_align unsharded "
        f"{m_one:.2f} s; packed regs equal: {mesh_same} "
        f"({int(whole['overflow'].sum())} reads overflowed, "
        f"{int(whole['valid'].sum())} regs)")
    if not (dup_same and sort_same) or backend != "nccl":
        raise AssertionError("sharded sort + duplicate marking over NCCL "
                             "differs from the single-device engine")
    if not mesh_same:
        raise AssertionError("the 2-D mesh's packed regs differ from the "
                             "unsharded device_align's")
    return sh_launches


class ShardRungs:
    """The rung running in any shard of a ShardedAligner (EscCounter's
    `rung` across its shards); attach(al) installs the counters."""

    def __init__(self):
        self.shards, self.escs = [], []

    def attach(self, al):
        self.shards = list(al.shards)
        self.escs = [EscCounter(sh, SWEEP_KERNELS) for sh in al.shards]

    @property
    def rung(self):
        return next((e.rung for e in self.escs if e.rung is not None),
                    None)


def phase_bigindex(dev):
    """The human-scale run's path, `python -m fgdp_tpu_torch.bigindex_run`
    (bigindex_run.run), at a cut depth: BIG_CONTIGS contigs of BIG_BP
    (4 x 8 Mb, 64 M text positions) built by BIG_PROCS workers,
    where the module's default is 10 x 128 Mb, whose builds alone take
    minutes of SA-IS; only the depth is cut. Its checks: the 32 forward
    plants of the last contig and the 32 reverse-complement plants of
    the first at their exact contig, position and strand, and one batch
    of 4,096 reads over every contig (reads/s, the share at the true
    position, escalations a shard, D9, D10, K3, P1, P2 and D5 launches
    and ms). Every shard's primary D9 and D10 launches (the plants' batch
    and the timed one) are held exactly against their torch-op loops on
    their inputs. At this depth no merged rb passes 2^31: that is held
    on the CPU (tests/test_torch_bigindex.py) and by the full run."""
    from collections import Counter

    from fgdp_tpu_torch import bigindex_run
    from fgdp_tpu_torch.ops import kernels

    rungs = ShardRungs()
    kernels.reset_launches()
    with SweepLaunches(rungs, primary_only=True) as d910:
        out = bigindex_run.run(BIG_CONTIGS, BIG_BP, BIG_PROCS, dev,
                               small=True, batch=BIG_BATCH,
                               on_aligner=rungs.attach, log=log)
    path = ("sweep_fwd", "sweep_bwd", "seed_strategy", "sw_extend",
            "chain_loop", "chain_flt")
    launches = {k: kernels.LAUNCHES[k] for k in path}
    log(f"[bigindex] launches on the path (plants and timed batch): "
        f"{launches}")
    if min(launches.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the bigindex "
                             f"path: {launches}")
    d910.hold("bigindex")
    shard_of = {id(sh.dfm): i for i, sh in enumerate(rungs.shards)}
    per = Counter((shard_of[id(a[0])], name)
                  for name, _, a, _, _ in d910.seen)
    log(f"[bigindex] primary D9/D10 launches held a shard: "
        + ", ".join(f"c{i} D9 {per[i, 'sweep_fwd']} D10 "
                    f"{per[i, 'sweep_bwd']}" for i in range(BIG_CONTIGS)))
    if any(per[i, k] <= 0 for i in range(BIG_CONTIGS)
           for k in ("sweep_fwd", "sweep_bwd")):
        raise AssertionError("a shard's primary D9/D10 launches were not "
                             "held")
    if out["share"] < 0.95:
        raise AssertionError(f"the bigindex batch placed {out['share']} "
                             "of its reads")
    return launches


PHASES = ("probes", "kernels", "golden", "ladder", "scale", "engines",
          "mutect_golden", "mutect_scale", "sormadup_scale",
          "pipeline_scale", "pe_scale", "mutect_options", "sharded",
          "bigindex")
# the earlier paths' depth, set so that the whole run with the engines
# phase stays well inside its time limit on a slow host: scale's 8,192 reads are two
# batches (BASELINE config 1 aligns "~10K" reads; the engines phase reads
# the first) and pipeline_scale plants a duplicate for a tenth of them;
# pe_scale's `mem` aligns 8,192 pairs (four batches, every kswv launch
# held against the plain version), its `pipeline -t` the first 4,096 and
# its card-vs-CPU check the first 128. mutect_scale's 300 sites' spacing
# sets the span of its card-vs-CPU check (WARM_SITES). The sharded
# phase's shards escalate every read of the other contig, so its sets
# are 1,024 single-end reads and 1,024 pairs
SCALE_READS = 8_192
PE_PAIRS = 8_192
PE_PIPELINE_PAIRS = 4_096
PE_CPU_PAIRS = 128
PIPELINE_DUPS = 819
SORMADUP_RECORDS = 1_000_000
SHARDED_READS = 1_024
SHARDED_PAIRS = 1_024
# the bigindex phase: the human-scale run's path at 4 x 8 Mb, four
# workers, and its full batch of 4,096 reads
BIG_CONTIGS = 4
BIG_BP = 8_000_000
BIG_PROCS = 4
BIG_BATCH = 4_096


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of "
                         f"{','.join(PHASES)} (card and build always run);"
                         " a partial run prints no result line")
    args = ap.parse_args(argv)
    phases = set(args.phases.split(","))
    if not phases <= set(PHASES):
        ap.error(f"unknown phase in {args.phases}")
    if not os.path.isdir(os.path.join(ROOT, "fgdp_tpu_torch")):
        print("chip_smoke: the fgdp_tpu_torch package is not beside this "
              "script", file=sys.stderr)
        return 2
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    dev = torch.device("cuda")
    t_start = time.time()
    card, rates = phase_card()
    with phase_clock("build"):
        phase_build()
    rows, launches = {}, {}
    if "probes" in phases:
        with phase_clock("probes"):
            prows, plaunch, rates = phase_probes(dev, rates)
        rows.update(prows)
        launches.update(plaunch)
    if "kernels" in phases:
        with phase_clock("kernels"):
            rows.update(phase_kernels(dev, rates))
    with tempfile.TemporaryDirectory(prefix="fgdp_smoke_") as tmp:
        if "golden" in phases:
            with phase_clock("golden"):
                phase_golden(tmp)
        if "ladder" in phases:
            with phase_clock("ladder"):
                phase_ladder(dev)
        if phases & {"scale", "engines", "pipeline_scale", "pe_scale"}:
            with phase_clock("scale"):
                mem_launches, ctx = phase_scale(
                    dev, tmp, genome_bp=4_600_000, n_reads=SCALE_READS,
                    batch=4096)
            launches.update(mem_launches)
            rows.update(ctx["seed_rows"])
        if "engines" in phases:
            with phase_clock("engines"):
                eng_launches, eng_rows = phase_engines(dev, ctx, 4096)
            launches.update({k: eng_launches[k] for k in eng_rows})
            rows.update(eng_rows)
        if "mutect_golden" in phases:
            with phase_clock("mutect_golden"):
                phase_mutect_golden(tmp)
        if "mutect_scale" in phases:
            with phase_clock("mutect_scale"):
                launches["pairhmm"] = phase_mutect_scale(dev, 4_600_000)
        if "sormadup_scale" in phases:
            with phase_clock("sormadup_scale"):
                phase_sormadup_scale(tmp, SORMADUP_RECORDS)
        if "pipeline_scale" in phases:
            with phase_clock("pipeline_scale"):
                phase_pipeline_scale(dev, tmp, ctx, 4096, PIPELINE_DUPS)
        if "pe_scale" in phases:
            with phase_clock("pe_scale"):
                pe_launches, rows["kswv"] = phase_pe_scale(
                    dev, rates, tmp, ctx, PE_PAIRS, 4096)
            launches["kswv"] = pe_launches["kswv"]
        if "mutect_options" in phases:
            with phase_clock("mutect_options"):
                phase_mutect_options(dev, tmp)
        if "sharded" in phases:
            with phase_clock("sharded"):
                phase_sharded(dev, tmp, SHARDED_READS, SHARDED_PAIRS)
        if "bigindex" in phases:
            with phase_clock("bigindex"):
                phase_bigindex(dev)
    if phases != set(PHASES):
        log(f"[done] phases {sorted(phases)} passed in "
            f"{time.time() - t_start:.1f} s (partial run: no result)")
        print(card)
        return 0
    meta = {
        "sw_extend": ("cuda", "fgdp_tpu_torch/csrc/sw_extend.cu",
                      "fgdp_tpu/ops/sw_pallas.py:34"),
        "chain_loop": ("cuda", "fgdp_tpu_torch/csrc/chain_loop.cu",
                       "fgdp_tpu/ops/chain_pallas.py:40"),
        "chain_flt": ("cuda", "fgdp_tpu_torch/csrc/chain_flt.cu",
                      "fgdp_tpu/align/chain.py:342 _chain_flt (D5, "
                      "lax.while_loop :416)"),
        "pairhmm": ("cuda", "fgdp_tpu_torch/csrc/pairhmm.cu",
                    "fgdp_tpu/ops/pairhmm_pallas.py:34"),
        "kswv": ("cuda", "fgdp_tpu_torch/csrc/kswv.cu",
                 "fgdp_tpu/ops/kswv.py:40 (D6, lax.fori_loop)"),
        "smem_lcp": ("cuda", "fgdp_tpu_torch/csrc/smem_lcp.cu",
                     "fgdp_tpu/ops/smem_lcp.py:50 smem_all_lcp (D2, its "
                     "lax.while_loop waves :254-279)"),
        "k2_lcp": ("cuda", "fgdp_tpu_torch/csrc/k2_lcp.cu",
                   "fgdp_tpu/ops/smem_k2lcp.py:105 k2_reseed_lcp (D3, "
                   "lax.while_loop)"),
        "seed_strategy": ("cuda", "fgdp_tpu_torch/csrc/seed_strategy.cu",
                          "fgdp_tpu/ops/smem.py:872 seed_strategy (D4, "
                          "lax.while_loop)"),
        "sweep_fwd": ("cuda", "fgdp_tpu_torch/csrc/sweep_fwd.cu",
                      "fgdp_tpu/ops/smem_sweep.py:129 fwd_sweep (D9, its "
                      "lax.while_loop :300)"),
        "sweep_bwd": ("cuda", "fgdp_tpu_torch/csrc/sweep_bwd.cu",
                      "fgdp_tpu/ops/smem_sweep.py:359 bwd_entries (D10, its "
                      "lax.while_loops :414, :421, :450, :455)"),
        "vpu_ceiling": ("cuda", "fgdp_tpu_torch/csrc/vpu_ceiling.cu",
                        "scripts/bench_vpu_ceiling.py:44"),
        "gather_rows": ("cuda", "fgdp_tpu_torch/csrc/gather_rows.cu",
                        "scripts/bench_gather_pallas.py:26"),
        "gather_chase": ("cuda", "fgdp_tpu_torch/csrc/gather_chase.cu",
                         "none: a probe of the card (the seeding kernels' "
                         "serial bounds), no TPU counterpart"),
    }
    out = []
    for name, (route, src, repl) in meta.items():
        r = rows[name]
        out.append(dict(name=name, route=route, source=src, replaces=repl,
                        launches=launches[name],
                        max_abs_err=r["max_abs_err"], ms=r["ms"],
                        plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                        bound_by=r["bound_by"],
                        library_ms=r.get("library_ms")))
        if "bound_note" in r:
            out[-1]["bound_note"] = r["bound_note"]
    log(f"[done] all phases passed in {time.time() - t_start:.1f} s")
    print(json.dumps({"kernels": out}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
