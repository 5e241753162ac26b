"""The CUDA kernels, the aligner, the sort and the caller on the card
(marked `cuda`: these skip where there is no card). Each kernel must
equal its plain PyTorch version on the same CUDA inputs (exactly, but
for the FP32 issue probe's fused multiply-adds), the aligner on the card
must write the same SAM lines as on the CPU, `sormadup` the same BAM and
BAI bytes, and the caller the same calls.

This file imports neither jax nor fgdp_tpu, so it runs on a machine
that has only the port's dependencies; tests/conftest.py sets up JAX, so
run it there without the conftest:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

It also holds the seeded inputs that test_torch_sw.py,
test_torch_chain.py, test_torch_chain_flt.py, test_torch_kswv.py,
test_torch_pairhmm.py and test_torch_sortdup.py share with it."""

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fgdp_tpu_torch.align import chain
from fgdp_tpu_torch.config import AlignConfig, BatchShapes
from fgdp_tpu_torch.ops import kernels, kswv, pairhmm, sw

HERE = os.path.join(os.path.dirname(__file__), "golden")
OPT = AlignConfig()


def sw_pairs(seed, n, qmax, tmax, mut=0.05, n_frac=0.0):
    """Extension-shaped pairs: target an error-laden copy of the query
    most of the time; some empty lanes; optional N bases."""
    rng = np.random.default_rng(seed)
    qs = np.zeros((n, qmax), np.int32)
    ts = np.zeros((n, tmax), np.int32)
    qlen = np.zeros(n, np.int32)
    tlen = np.zeros(n, np.int32)
    for i in range(n):
        ql = int(rng.integers(1, qmax + 1))
        tl = int(rng.integers(1, tmax + 1))
        q = rng.integers(0, 4, ql)
        t = rng.integers(0, 4, tl)
        if rng.random() < 0.7:
            tl = min(tmax, ql + int(rng.integers(0, 20)))
            t = np.concatenate([q, rng.integers(0, 4, max(0, tl - ql))])[:tl]
            m = rng.random(tl) < mut
            t = np.where(m, rng.integers(0, 4, tl), t)
        if n_frac:
            q = np.where(rng.random(ql) < n_frac, 4, q)
            t = np.where(rng.random(tl) < n_frac, 4, t)
        qs[i, :ql] = q
        ts[i, :tl] = t
        qlen[i] = ql
        tlen[i] = tl
    qlen[::9] = 0                        # empty lanes: the skip path
    tlen[4::11] = 0
    h0 = rng.integers(1, 80, n).astype(np.int32)
    return qs, qlen, ts, tlen, h0


# the cases of tests/test_sw.py: parity, narrow bands, N bases, z-drop
SW_CASES = {
    "parity": dict(args=(1, 64, 96, 128), w=100, bonus=OPT.pen_clip5),
    "narrow3": dict(args=(2, 48, 64, 80, 0.15), w=3, bonus=OPT.pen_clip3),
    "narrow10": dict(args=(3, 48, 64, 80, 0.15), w=10, bonus=OPT.pen_clip3),
    "n_bases": dict(args=(4, 48, 64, 96, 0.05, 0.05), w=100,
                    bonus=OPT.pen_clip5),
    "zdrop": dict(args=(5, 48, 90, 120, 0.35), w=100, bonus=OPT.pen_clip5),
}


# query lengths at the kernel's lane boundaries (a warp's lanes hold K
# band columns each, K = ceil((QP + 2) / 32)), at the ladder's, the main
# path's and the widest query width the kernel takes
SW_EDGE_QLENS = (0, 1, 31, 32, 33, 63, 64)
SW_EDGE_QPS = (100, 151, 254)
SW_EDGE_WS = (3, 10, 100, 200)


def sw_edge_jobs(seed, QP, TP=368, copies=3):
    """`copies` jobs of each query length in SW_EDGE_QLENS and QP: targets
    copy the query with 3% substitutions (so bands run to the query's
    end) and go on at random, a few N bases, target lengths up to 220
    past the query."""
    rng = np.random.default_rng(seed)
    qlen = np.repeat(np.array(SW_EDGE_QLENS + (QP,), np.int32), copies)
    n = len(qlen)
    qs = rng.integers(0, 4, (n, QP)).astype(np.int32)
    ts = rng.integers(0, 4, (n, TP)).astype(np.int32)
    ts[:, :QP] = np.where(rng.random((n, QP)) < 0.03,
                          rng.integers(0, 4, (n, QP)), qs)
    qs[rng.random((n, QP)) < 0.01] = 4
    tlen = np.minimum(qlen + rng.integers(0, 221, n), TP).astype(np.int32)
    h0 = rng.integers(1, 80, n).astype(np.int32)
    return qs, qlen, ts, tlen, h0


def sw_retry_jobs(seed, keep=(30, 77, 199)):
    """A band-retry call of 200 jobs: all but those in `keep` (query
    lengths 1, 33 and 151) have qlen = tlen = 0."""
    qs, qlen, ts, tlen, h0 = sw_edge_jobs(seed, 151, copies=25)
    live = np.zeros(len(qlen), bool)
    live[list(keep)] = True
    return (qs, np.where(live, qlen, 0).astype(np.int32), ts,
            np.where(live, tlen, 0).astype(np.int32), h0)


def sw_params(mod, end_bonus):
    """`mod.SWParams` (the port's or the JAX package's) at the default
    scoring."""
    return mod.SWParams(o_del=OPT.o_del, e_del=OPT.e_del, o_ins=OPT.o_ins,
                        e_ins=OPT.e_ins, zdrop=OPT.zdrop,
                        end_bonus=end_bonus, mat_max=OPT.a)


def synth_seeds(seed, B, P, l_pac):
    """Random seed columns shaped like expand_seeds output: qbeg
    ascending, diagonal runs with jumps, repeats that get contained,
    both strands, two contigs, invalid slots."""
    rng = np.random.default_rng(seed)
    qbeg = np.sort(rng.integers(0, 130, (B, P)), axis=1).astype(np.int32)
    diag = rng.integers(0, 2 * l_pac - 300, (B, 1))
    jump = rng.integers(0, 2 * l_pac - 300, (B, P))
    rbeg = np.where(rng.random((B, P)) < 0.7, diag + qbeg, jump)
    rbeg = (rbeg + rng.integers(-3, 4, (B, P))).clip(0).astype(np.int32)
    slen = rng.integers(19, 45, (B, P)).astype(np.int32)
    dup = rng.random((B, P)) < 0.2
    qbeg[:, 1:] = np.where(dup[:, 1:], qbeg[:, :-1], qbeg[:, 1:])
    rbeg[:, 1:] = np.where(dup[:, 1:], rbeg[:, :-1], rbeg[:, 1:])
    rid = (rbeg >= l_pac).astype(np.int32)
    valid = rng.random((B, P)) < 0.8
    valid[rng.random(B) < 0.1] = False          # reads with no seeds
    ovf = rng.random(B) < 0.1
    return qbeg, rbeg, slen, rid, valid, ovf


def chain_edge_seeds(seed, B, P, l_pac):
    """synth_seeds' reads plus rows at the chain kernel's edges: no valid
    slot; every slot valid; a run of invalid slots across the 32-slot
    boundaries; a run of new chains at one pos (alternating contigs, so
    none grows another: the latest must win every tie) and rbegs that
    step down below the chain just opened; falling rbegs on both sides
    of l_pac, every seed a new chain, that fill every chain slot."""
    qbeg, rbeg, slen, rid, valid, ovf = synth_seeds(seed, B, P, l_pac)
    rng = np.random.default_rng(seed + 1000)
    t = np.arange(P)
    valid[0] = False
    valid[1] = True
    if B > 2:
        valid[2] = (t < 20) | (t >= 70)
    if B > 3:
        # per 4 slots: a chain at 1000, two more at 1000 on the other
        # contig and back (each the latest of the ties), then rb 900
        # below them; the block moves up by 2000 every 16 slots
        qbeg[3] = t % 130
        rbeg[3] = np.array([1000, 1000, 1000, 900])[t % 4] + 2000 * (t // 16)
        rid[3] = np.array([0, 1, 0, 0])[t % 4]
        slen[3] = 25
        valid[3] = True
    if B > 4:
        qbeg[4] = np.sort(rng.integers(0, 130, P))
        # rbeg falling: no chain is ever eligible, each seed opens one
        rbeg[4] = np.linspace(2 * l_pac - 300, 0, P).astype(np.int32)
        rid[4] = (rbeg[4] >= l_pac).astype(np.int32)
        valid[4] = True
    return qbeg, rbeg, slen, rid, valid, ovf


# the chain filter's tables: a few contigs, the second one alt
N_CONTIGS = 3


def flt_tables(seed, B, C, n_contigs=N_CONTIGS, spans=None, weights=None):
    """Chain tables as chain_loop leaves them, plus the weight: n
    int32[B], the rest int32[B, C]. Rows 0-3 are the edges: no chain
    (n_f 0), all C chains under min_chain_weight 30 (n_f 0 there), one
    chain at or above it (n_f 1), all C chains at 40 or more (n_f C).
    Query spans start in [0, 40) and weights and pos come from a few
    values each, so overlaps, equal weights and equal pos are common;
    `spans` / `weights` replace the span lengths' and weights' value
    sets. crid runs over [-1, n_contigs + 1] (the filter clamps it)."""
    rng = np.random.default_rng(seed)
    spans = np.asarray(spans if spans is not None else [12, 25, 40, 60, 90])
    weights = np.asarray(weights if weights is not None
                         else [20, 30, 31, 45, 60, 61, 90])
    n = rng.integers(0, C + 1, B)
    fq = rng.integers(0, 40, (B, C))
    ln = rng.choice(spans, (B, C))
    ll = rng.integers(15, 30, (B, C))
    ll = np.minimum(ll, ln)
    lq = fq + ln - ll
    pos = rng.choice([100, 250, 400, 4000, 9000], (B, C)) + \
        rng.integers(0, 3, (B, C))
    w = rng.choice(weights, (B, C))
    crid = rng.integers(-1, n_contigs + 2, (B, C))
    crid[rng.random((B, C)) < 0.7] = 0
    if B > 3:
        n[0] = 0
        n[1] = C
        w[1] = rng.integers(0, 30, C)
        n[2] = max(C // 2, 1)
        w[2, :n[2]] = rng.integers(0, 30, n[2])
        w[2, rng.integers(0, n[2])] = 30
        n[3] = C
        w[3] = rng.choice(weights[weights >= 40], C)
    # slots past n: garbage no version may read
    junk = np.arange(C)[None, :] >= n[:, None]
    for a, lo, hi in ((fq, -50, 50), (lq, -50, 50), (ll, 0, 9),
                      (pos, -5, 5), (w, 0, 2**30 - 1), (crid, -9, 9)):
        a[junk] = rng.integers(lo, hi, int(junk.sum()))
    tbl = dict(n=n, pos=pos, crid=crid, fq=fq, lq=lq, ll=ll, weight=w)
    return {k: np.ascontiguousarray(v, np.int32) for k, v in tbl.items()}


def alt_table(n_contigs=N_CONTIGS):
    alt = np.zeros(n_contigs, bool)
    alt[1] = True
    return alt


def hmm_cases(seed, n, R, H, cq=10, n_frac=0.0, hopeless=0.0):
    """PairHMM pairs: reads copied from their haplotype with 8%
    substitutions at ragged read and haplotype lengths, base quals 5-40,
    ins/del quals 20-45, gap-continuation qual `cq` (>= 8 lets the scan
    depth cap at 6). `n_frac` puts N bases in reads and haplotypes;
    `hopeless` is the share of long all-mismatch reads at qual 40, whose
    f32 result underflows into the f64 re-run. Returns the arguments of
    compute_log_likelihoods_async."""
    rng = np.random.default_rng(seed)
    reads = np.zeros((n, R), np.int32)
    haps = np.zeros((n, H), np.int32)
    rlens = np.zeros(n, np.int32)
    hlens = np.zeros(n, np.int32)
    q = np.zeros((n, R), np.int32)
    iq = np.full((n, R), 45, np.int32)
    dq = np.full((n, R), 45, np.int32)
    c = np.full((n, R), cq, np.int32)
    for k in range(n):
        hl = int(rng.integers(max(H // 4, 2), H + 1))
        hap = rng.integers(0, 4, hl)
        if rng.random() < hopeless:
            rl = min(R, hl)
            read = (hap[:rl] + 1) % 4
            q[k, :rl] = 40
        else:
            rl = int(rng.integers(max(R // 4, 1), R + 1))
            off = int(rng.integers(0, max(hl - rl, 0) + 1))
            read = hap[off:off + rl].copy()
            rl = len(read)
            m = rng.random(rl) < 0.08
            read = np.where(m, rng.integers(0, 4, rl), read)
            q[k, :rl] = rng.integers(5, 41, rl)
            iq[k, :rl] = rng.integers(20, 46, rl)
            dq[k, :rl] = rng.integers(20, 46, rl)
        if n_frac:
            read = np.where(rng.random(rl) < n_frac, 4, read)
            hap = np.where(rng.random(hl) < n_frac, 4, hap)
        reads[k, :rl] = read
        haps[k, :hl] = hap
        rlens[k], hlens[k] = rl, hl
    return reads, rlens, q, iq, dq, c, haps, hlens


def hmm_f32_inputs(reads, rlens, q, iq, dq, c, haps, hlens):
    """(reads, rlens, pq, trans, haps, hlens, cap) of the f32 pass, as
    compute_log_likelihoods_async makes them."""
    pq = pairhmm._PH2PR32[np.clip(q, 0, 127)]
    tr = pairhmm.transitions(iq, dq, c, np.float32)
    return reads, rlens, pq, tr, haps, hlens, pairhmm.doubling_cap(c)


# small shapes of the kernel's regimes: capped scan, no cap (cq < 8),
# N bases, one pair per warp at a production bucket (R 160, H 128)
HMM_CASES = {
    "cap": dict(args=(1, 40, 48, 80)),
    "no_cap": dict(args=(2, 30, 40, 130, 3)),
    "n_bases": dict(args=(3, 30, 36, 70, 10, 0.05)),
    "bucket": dict(args=(4, 24, 160, 128, 10)),
}



# the register path's lane and register boundaries (hlen + 1 = 1, 2, 31,
# 32, 33, 64, 65; lane l of a warp holds columns 32 r + l), at launch
# widths H up to the widest the register path takes (639: hlen + 1 =
# 32 x 20); cq 10 caps the scan at 6 doublings, cq 5 leaves it uncapped,
# so that k = 64, 128, ... are register moves
HMM_EDGE_HLENS = (0, 1, 30, 31, 32, 63, 64)
HMM_EDGE_HS = (0, 1, 31, 32, 63, 64, 200, 639)
HMM_WIDE_H = 700


def hmm_edge_pairs(seed, H, R=40, cq=10, copies=2, n_frac=0.03):
    """`copies` pairs of each haplotype length in HMM_EDGE_HLENS up to H
    and of H itself, read lengths cycling through 0, 1, R and random;
    reads copied from their haplotype with 8% substitutions, base quals
    5-40, ins/del quals 20-45, N bases at `n_frac` in reads and
    haplotypes. Returns the arguments of compute_log_likelihoods_async."""
    rng = np.random.default_rng(seed)
    hlens = np.repeat([h for h in HMM_EDGE_HLENS if h < H] + [H],
                      copies).astype(np.int32)
    n = len(hlens)
    rlens = np.array([(0, 1, R, int(rng.integers(2, R + 1)))[k % 4]
                      for k in range(n)], np.int32)
    haps = rng.integers(0, 4, (n, H)).astype(np.int32)
    reads = rng.integers(0, 4, (n, R)).astype(np.int32)
    for k in range(n):
        if hlens[k]:
            off = int(rng.integers(0, hlens[k]))
            cols = (off + np.arange(R)) % hlens[k]
            reads[k] = np.where(rng.random(R) < 0.08, reads[k],
                                haps[k, cols])
    haps = np.where(rng.random((n, H)) < n_frac, 4, haps).astype(np.int32)
    reads = np.where(rng.random((n, R)) < n_frac, 4, reads).astype(np.int32)
    q = rng.integers(5, 41, (n, R)).astype(np.int32)
    iq = rng.integers(20, 46, (n, R)).astype(np.int32)
    dq = rng.integers(20, 46, (n, R)).astype(np.int32)
    c = np.full((n, R), cq, np.int32)
    return reads, rlens, q, iq, dq, c, haps, hlens


def kswv_jobs(seed, n, QP, TP, empty=0.05):
    """Mate-rescue-like local-SW jobs as ops/kswv.kswv_forward takes them
    (q [n, QP], qlen, t [n, TP], tlen; codes past the lengths are 4, as
    the job packing leaves them): two thirds of the queries a copy of a
    target slice with 8% substitutions, a 1-5 base deletion in half and
    junk at the head in a fifth (tests/test_kswv.py's generator), the
    rest random; an N base in a tenth of the queries and 1% of the target
    bases. A quarter of the queries are QP long, the rest 1 to QP; targets
    1 to TP. `empty` of the jobs have qlen = tlen = 0, as the padding of
    the job bucket."""
    rng = np.random.default_rng(seed)
    q = np.full((n, QP), 4, np.int32)
    t = rng.integers(0, 4, (n, TP)).astype(np.int32)
    t[rng.random((n, TP)) < 0.01] = 4
    qlen = np.where(rng.random(n) < 0.25, QP,
                    rng.integers(1, QP + 1, n)).astype(np.int32)
    tlen = rng.integers(1, TP + 1, n).astype(np.int32)
    for i in range(n):
        lq, lt = int(qlen[i]), int(tlen[i])
        qi = rng.integers(0, 4, lq)
        if i % 3 != 2 and lt > 1:
            span = min(lq, lt - 1)
            off = int(rng.integers(0, lt - span))
            c = t[i, off:off + span].copy()
            m = rng.random(span) < 0.08
            c[m] = rng.integers(0, 4, int(m.sum()))
            if span > 30 and rng.random() < 0.5:
                cut = int(rng.integers(5, span - 20))
                c = np.concatenate([c[:cut], c[cut + int(rng.integers(1, 6)):]])
            if rng.random() < 0.2:
                c[:3] = rng.integers(0, 4, min(3, len(c)))
            qi[:len(c)] = c
        if rng.random() < 0.1:
            qi[int(rng.integers(0, lq))] = 4
        q[i, :lq] = qi
        t[i, lt:] = 4
    gone = rng.random(n) < empty
    qlen[gone] = 0
    tlen[gone] = 0
    return q, qlen, t, tlen


# kswv's register path: K = ceil(QP / 32) columns a lane, each QP at or
# around a lane edge
KSWV_EDGE_QPS = (1, 31, 32, 33, 63, 64, 160, 255, 256)
KSWV_WIDE_QPS = (257, 400)
# the CLI's defaults, o = e = 1 with b = 1, uneven penalties, a large
# e_ins, and the widest scores the register path takes in a signed byte
KSWV_PENALTIES = {"default": dict(a=1, b=4, o_del=6, e_del=1, o_ins=6,
                                  e_ins=1),
                  "pacbio": dict(a=1, b=1, o_del=1, e_del=1, o_ins=1,
                                 e_ins=1),
                  "uneven": dict(a=2, b=3, o_del=5, e_del=2, o_ins=3,
                                 e_ins=1),
                  "large_e_ins": dict(a=1, b=4, o_del=6, e_del=1, o_ins=6,
                                      e_ins=1000),
                  "byte_edge": dict(a=127, b=128, o_del=6, e_del=1,
                                    o_ins=6, e_ins=1)}
# target lengths at the wavefront's edges (a row is decided 31 steps
# after lane 0 computes it)
KSWV_WAVE_TLENS = (0, 1, 31, 32, 33)


def kswv_wave_jobs(seed, QP, n=24):
    """Jobs at the edges of kswv's wavefront (csrc/kswv.cuh), TP = 2 QP +
    40: targets of 0, 1, 31, 32, 33 and TP - 1 rows (jobs 0-5); two jobs
    all padding (qlen = tlen = 0, jobs 6-7) and one with a query and no
    target (8); a job whose best is its last row, decided in the drain
    (9: an exact copy of the query ends there); a job whose row maxima
    tie (10: two exact copies, te the first's last row); the rest
    kswv_jobs'. Returns (q, qlen, t, tlen) and the rows jobs 9 and 10
    must report as te."""
    TP = 2 * QP + 40
    q, qlen, t, tlen = kswv_jobs(seed, n, QP, TP, empty=0.0)
    rng = np.random.default_rng(seed + 7)
    for i, tl in enumerate(KSWV_WAVE_TLENS + (TP - 1,)):
        tlen[i] = tl
        t[i, tl:] = 4
    for i in (6, 7):
        q[i], t[i], qlen[i], tlen[i] = 4, 4, 0, 0
    t[8], tlen[8] = 4, 0
    for i in (9, 10):
        q[i] = rng.integers(0, 4, QP)
        t[i] = rng.integers(0, 4, TP)
        qlen[i] = QP
    T9 = TP - 3
    tlen[9] = T9
    t[9, T9 - QP:T9] = q[9]
    t[9, T9:] = 4
    tlen[10] = TP
    t[10, 5:5 + QP] = q[10]
    t[10, QP + 25:2 * QP + 25] = q[10]
    return (q, qlen, t, tlen), (T9 - 1, 4 + QP)


def recal_report(report: str, rg: str) -> str:
    """A GATK recal table: tests/test_bqsr.py's REPORT (passed in as
    `report`) for read group `rg`, with rows for the
    golden fixture's quality 37 (its quals are 20, 30 and 37) so every
    covariate table takes part."""
    text = report.replace("rg1", rg)
    q1 = f"{rg}        20            M          22.0000           500000"
    extra1 = f"\n{rg}        37            M          33.0000  800000  900.00"
    i = text.index(q1)
    j = text.index("\n", i)
    text = text[:j] + extra1 + text[j:]
    cyc = f"{rg}        30            2               Cycle"
    extra2 = "".join(
        f"\n{rg}  37  {v}  {name}  M  30.0000  {obs}  {err}"
        for v, name, obs, err in (("AC", "Context", 100000, "400.00"),
                                  ("GT", "Context", 90000, "800.00"),
                                  ("TT", "Context", 50000, "30.00"),
                                  ("1", "Cycle", 100000, "350.00"),
                                  ("7", "Cycle", 100000, "120.00"),
                                  ("-3", "Cycle", 80000, "900.00"),
                                  ("151", "Cycle", 60000, "700.00")))
    i = text.index(cyc)
    j = text.index("\n", i)
    text = text[:j] + extra2 + text[j:]
    # the dimension lines carry the row counts
    return (text.replace("#:GATKTable:6:2:%s:%d:%s:%.4f:%d:%.2f:;",
                         "#:GATKTable:6:3:%s:%d:%s:%.4f:%d:%.2f:;")
            .replace("#:GATKTable:8:2:", "#:GATKTable:8:9:"))


def two_contigs(n1, n2, L, seed=7):
    """tests/test_sharded_index.py's reference and reads, at `n1` + `n2`
    bp: two uniform random contigs and a maker of `n` reads of `L` bp
    from both in turn, 1% substitutions, half reverse-complemented.
    Returns (PackedReference, reads(n) -> (names, seqs))."""
    from fgdp_tpu_torch.index.reference import PackedReference

    rng = np.random.default_rng(seed)
    c1 = rng.integers(0, 4, n1).astype(np.uint8)
    c2 = rng.integers(0, 4, n2).astype(np.uint8)
    pref = PackedReference.from_contigs(["chrA", "chrB"], [c1, c2])

    def reads(n):
        names, seqs = [], []
        for i in range(n):
            src, m = (c1, n1) if i % 2 == 0 else (c2, n2)
            p = int(rng.integers(0, m - L))
            c = src[p:p + L].astype(np.int64)
            mut = rng.random(L) < 0.01
            c = np.where(mut, rng.integers(0, 4, L), c)
            if rng.random() < 0.5:
                c = 3 - c[::-1]
            names.append(f"r{i}")
            seqs.append(c)
        return names, seqs

    return pref, reads


class _GateModel(torch.nn.Module):
    """Stand-in for the reference's CNN gate (trans.pt): [N, 31, 30]
    pileup features -> [N, 2] softmax."""

    def __init__(self, seed: int, scale: float, width: int):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.w1 = torch.nn.Parameter(
            torch.randn(30, width, generator=g) / 30 ** 0.5)
        self.b1 = torch.nn.Parameter(0.1 * torch.randn(width, generator=g))
        self.w2 = torch.nn.Parameter(
            scale * torch.randn(width, 2, generator=g) / width ** 0.5)

    def forward(self, x):
        h = torch.tanh(x @ self.w1 + self.b1).mean(dim=1)
        return torch.softmax(h @ self.w2, dim=1)


def gate_model(path, seed, scale=40.0, width=16):
    """Save a seeded TorchScript gate model to `path` (returned). Its
    weights are scaled so the softmax's first column reaches exactly 1.0
    in float32 on some inputs and stays below it on others."""
    torch.jit.script(_GateModel(seed, scale, width)).save(str(path))
    return str(path)


HEADER = ["@HD\tVN:1.6\tSO:unsorted",
          "@SQ\tSN:chr1\tLN:10000",
          "@SQ\tSN:chr2\tLN:5000"]


def _rec(qname, flag, rname, pos, cigar="100M", mapq=60, rnext="*",
         pnext=0, tlen=0, seq=None, qual=None, tags=()):
    seq = seq or "A" * 100
    qual = qual or "I" * 100
    return "\t".join([qname, str(flag), rname, str(pos), str(mapq), cigar,
                      rnext, str(pnext), str(tlen), seq, qual, *tags])


def random_sam(seed, n_pairs=200, n_singles=60):
    """Pairs and singles clustered on few positions (runs of duplicates).
    A third of the names carry no tile:x:y and a third of the reads
    share one quality string, so whole runs tie on every key; some reads
    start at chr1:1-3 behind a soft clip (negative 5' positions); a few
    pairs carry a secondary record between the mates."""
    rng = np.random.default_rng(seed)
    flat = "I" * 100
    groups = []
    hot = [int(rng.integers(1, 9000)) for _ in range(max(n_pairs // 8, 3))]
    hot[:3] = [1, 2, 3]

    def name(prefix, i):
        if rng.random() < 1 / 3:
            return f"{prefix}{i}"                   # tile = x = y = 0
        t, x, y = (int(rng.integers(1, 100)), int(rng.integers(1, 30000)),
                   int(rng.integers(1, 30000)))
        return f"{prefix}1:{i}:FC:1:{t}:{x}:{y}"

    def qual():
        if rng.random() < 1 / 3:
            return flat
        return "".join(chr(33 + int(rng.integers(2, 41))) for _ in range(100))

    for i in range(n_pairs):
        pos1 = hot[int(rng.integers(0, len(hot)))] + int(rng.integers(0, 2))
        pos2 = pos1 + int(rng.choice([120, 180, 250]))
        q, ql = name("M", i), qual()
        cig1 = "100M" if rng.random() < 0.6 else "5S95M"
        cig2 = "100M" if rng.random() < 0.7 else "90M10S"
        mates = [_rec(q, 0x63, "chr1", pos1, cig1, rnext="=", pnext=pos2,
                      tlen=pos2 - pos1 + 100, qual=ql,
                      tags=("NM:i:0", "AS:i:95")),
                 _rec(q, 0x93, "chr1", pos2, cig2, rnext="=", pnext=pos1,
                      tlen=-(pos2 - pos1 + 100), qual=ql)]
        if rng.random() < 0.05:            # a secondary inside the group
            mates.insert(1, _rec(q, 0x163, "chr2", 40, rnext="chr1",
                                 pnext=pos2))
        groups.append(mates)
    for i in range(n_singles):
        pos = hot[int(rng.integers(0, len(hot)))]
        flag = 0 if rng.random() < 0.5 else 0x10
        on_chr2 = rng.random() < 0.3
        cig = "100M" if rng.random() < 0.7 else "3S97M"
        groups.append([_rec(name("S", i), flag,
                            "chr2" if on_chr2 else "chr1",
                            min(pos, 4800) if on_chr2 else pos, cig,
                            qual=qual())])
    groups += [[_rec("U1:0:FC:1:9:9:9", 0x4, "*", 0, "*")],
               [_rec("M1:0:FC:1:9:9:9", 0x100, "chr1", 100)],
               [_rec("M1:7:FC:1:9:9:9", 0x900, "chr1", 200)]]
    # out of coordinate order, mates adjacent as an aligner writes them
    # (pairing takes consecutive records of one QNAME)
    return [ln for i in rng.permutation(len(groups)) for ln in groups[i]]


def gen_genome(n, seed=0):
    """scripts/gen_genome.py's repeat-rich genome of n bp (uint8 codes)."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location(
        "gen_genome", os.path.join(root, "scripts", "gen_genome.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.generate(n, seed)


def seed_index(g):
    """The port's host index of genome g: (PackedReference, FMIndex,
    LcpTree) as `index` builds them."""
    from fgdp_tpu_torch.index.fmindex import FMIndex
    from fgdp_tpu_torch.index.lcptree import LcpTree
    from fgdp_tpu_torch.index.reference import PackedReference
    from fgdp_tpu_torch.utils import dna

    pref = PackedReference.from_contigs(["chr"], [g])
    fm = FMIndex.build(pref.codes)
    x = np.concatenate([pref.codes, dna.revcomp(pref.codes)]) \
        .astype(np.uint8)
    return pref, fm, LcpTree.build(x, fm.sa)


def seed_tables(index, device):
    """(DeviceFMIndex, DeviceReference, tree, isa) of seed_index's index
    on `device`."""
    from fgdp_tpu_torch.index.reference import DeviceReference
    from fgdp_tpu_torch.ops.fm import DeviceFMIndex

    pref, fm, lt = index
    return (DeviceFMIndex.from_host(fm, device=device),
            DeviceReference(pref, device=device),
            torch.as_tensor(lt.tree, device=device),
            torch.as_tensor(lt.isa, device=device))


def seed_reads(g, B, L, seed):
    """B reads of at most L bases for the seeding kernels, from a numpy
    seed: copies of g (either strand, 1% substitutions, a 1-3 base indel
    in a tenth), lengths L/2 to L with the tail padded with 4; every 7th
    with a run of N, every 11th shorter than min_seed_len (19), every
    13th of random bases, every 17th inactive. Returns codes int32[B, L],
    lens int32[B], active bool[B]."""
    rng = np.random.default_rng(seed)
    codes = np.full((B, L), 4, np.int32)
    lens = np.zeros(B, np.int32)
    for i in range(B):
        n = int(rng.integers(L // 2, L + 1))
        if i % 11 == 5:
            n = int(rng.integers(1, 19))
        p = int(rng.integers(0, len(g) - n - 8))
        s = g[p:p + n + 8].astype(np.int32)
        if rng.random() < 0.1:
            k, d = int(rng.integers(1, max(n - 1, 2))), int(rng.integers(1, 4))
            s = np.concatenate([s[:k], s[k + d:]])
        s = s[:n].copy()
        mut = rng.random(n) < 0.01
        s[mut] = (s[mut] + rng.integers(1, 4, int(mut.sum()))) % 4
        if rng.random() < 0.5:
            s = (3 - s)[::-1]
        if i % 13 == 6:
            s = rng.integers(0, 4, n).astype(np.int32)
        if i % 7 == 3:
            a = int(rng.integers(0, n))
            s[a:a + int(rng.integers(1, 4))] = 4
        codes[i, :n] = s
        lens[i] = n
    active = np.arange(B) % 17 != 9
    return codes, lens, active


def k3_edge_reads(g, L=64):
    """Reads at K3's edges (B 8, L 64): an N at the anchor (position 0)
    and one inside the extension; length 0; an inactive copy; a read whose
    seeds outnumber a small max_seeds; copies of the genome; and, in a
    batch of its own (k3_cap_reads), reads longer than L, which hit the
    step cap 2 L L."""
    rng = np.random.default_rng(21)
    codes = np.full((8, L), 4, np.int32)
    lens = np.full(8, L, np.int32)
    for i in range(8):
        p = int(rng.integers(0, len(g) - L))
        codes[i] = g[p:p + L]
    codes[0, 0] = 4                 # N at the first anchor
    codes[0, 30] = 4                # and inside an extension
    codes[1, 21] = 4
    lens[2] = 0                     # empty read
    active = np.ones(8, bool)
    active[3] = False
    return codes, lens, active


def k3_cap_reads(g, L=6):
    """Reads longer than the batch's L (codes past L read as N): their
    anchors step one a step past L, so they run into the step cap 2 L L
    (72 steps) before x reaches len (a read of 30 bases stops short)."""
    rng = np.random.default_rng(22)
    codes = np.stack([g[p:p + L] for p in rng.integers(0, len(g) - L, 4)])
    lens = np.array([300, 120, L, 30], np.int32)
    return codes.astype(np.int32), lens, np.ones(4, bool)


def seed_k1_inputs(tables, codes, lens, active):
    """The K1 kernel's arguments but the caps, as collect_seeds gives
    them (msl 19)."""
    dfm, dref, tree, isa = tables
    dev = tree.device
    return (dfm, tree, isa, torch.as_tensor(codes, device=dev),
            torch.as_tensor(lens, device=dev),
            torch.as_tensor(active, device=dev), OPT.min_seed_len)


def seed_k2_jobs(tables, codes, lens, k1, k2_per_read=2):
    """K2's job arrays from K1 seeds, as collect_seeds makes them:
    (k_read, job_x, job_mi, job_pos, job_d0, k_on)."""
    from fgdp_tpu_torch.align import seeding

    dfm = tables[0]
    split_len = int(OPT.min_seed_len * OPT.split_factor + 0.499)
    qidx, k_read, job_x, job_mi, k_on, _ = seeding.k2_jobs(
        k1, OPT, split_len, codes.shape[0] * k2_per_read)
    job_pos, job_d0 = seeding.lcp_job_pos(dfm, k1, qidx, job_x)
    return k_read, job_x, job_mi, job_pos, job_d0, k_on


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SW_CASES))
def test_sw_kernel_equals_plain(dev, case):
    c = SW_CASES[case]
    args = [torch.as_tensor(a, device=dev) for a in sw_pairs(*c["args"])]
    p = sw_params(sw, c["bonus"])
    n0 = kernels.LAUNCHES["sw_extend"]
    got = sw.sw_extend(*args, c["w"], p)
    assert kernels.LAUNCHES["sw_extend"] == n0 + 1
    want = sw.sw_extend_plain(*args, c["w"], p)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _sw_on_card_equals_plain(dev, jobs, w):
    args = [torch.as_tensor(a, device=dev) for a in jobs]
    p = sw_params(sw, OPT.pen_clip5)
    n0 = kernels.LAUNCHES["sw_extend"]
    cells = torch.zeros(len(jobs[1]), dtype=torch.int64, device=dev)
    got = sw.sw_extend_kernel(*args, w, p, cells=cells)
    assert kernels.LAUNCHES["sw_extend"] == n0 + 1
    want = sw.sw_extend_plain(*args, w, p)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return cells


@pytest.mark.cuda
@pytest.mark.parametrize("w", SW_EDGE_WS)
@pytest.mark.parametrize("QP", SW_EDGE_QPS)
def test_sw_kernel_at_lane_boundaries(dev, QP, w):
    cells = _sw_on_card_equals_plain(dev, sw_edge_jobs(QP + w, QP), w)
    assert int(cells.sum()) > 0


@pytest.mark.cuda
def test_sw_kernel_on_a_mostly_empty_batch(dev):
    jobs = sw_retry_jobs(12)
    cells = _sw_on_card_equals_plain(dev, jobs, 2 * OPT.w)
    empty = torch.as_tensor(jobs[1] == 0, device=dev)
    assert int(cells[empty].abs().sum()) == 0 and int(cells.sum()) > 0


@pytest.mark.cuda
def test_sw_kernel_times_each_launch_when_asked(dev):
    kernels.TIMED["sw_extend"] = []
    try:
        _sw_on_card_equals_plain(dev, sw_edge_jobs(14, 151), OPT.w)
        pairs = kernels.TIMED["sw_extend"]
    finally:
        kernels.TIMED.pop("sw_extend", None)
    torch.cuda.synchronize()
    assert len(pairs) == 1 and pairs[0][0].elapsed_time(pairs[0][1]) > 0


@pytest.mark.cuda
def test_sw_kernel_refuses_query_wider_than_built(dev):
    jobs = sw_edge_jobs(13, sw.MAX_QP + 1, copies=1)
    args = [torch.as_tensor(a, device=dev) for a in jobs]
    n0 = kernels.LAUNCHES["sw_extend"]
    with pytest.raises(ValueError, match="widest"):
        sw.sw_extend(*args, OPT.w, sw_params(sw, OPT.pen_clip5))
    assert kernels.LAUNCHES["sw_extend"] == n0


@pytest.mark.cuda
def test_sw_kernel_refuses_qlen_above_query_width(dev):
    args = [torch.as_tensor(a, device=dev) for a in sw_pairs(6, 8, 16, 32)]
    args[1][3] = 17                      # qlen above QP = 16
    n0 = kernels.LAUNCHES["sw_extend"]
    with pytest.raises(ValueError, match="query width"):
        sw.sw_extend_kernel(*args, 100, sw_params(sw, OPT.pen_clip5))
    assert kernels.LAUNCHES["sw_extend"] == n0


# the largest escalated shape (P = 2048, C = 256) included
@pytest.mark.cuda
@pytest.mark.parametrize("seed,B,P,C", [(7, 20, 48, 8), (8, 300, 512, 3),
                                        (9, 64, 2048, 256)])
def test_chain_kernel_equals_plain(dev, seed, B, P, C):
    cols = [torch.as_tensor(a, device=dev)
            for a in synth_seeds(seed, B, P, 5000)]
    got = chain.chain_loop(*cols, 5000, C, OPT.w, OPT.max_chain_gap)
    want = chain.chain_loop_plain(*cols, 5000, C, OPT.w, OPT.max_chain_gap)
    for k in want:
        assert torch.equal(got[k], want[k]), k


def _chain_on_card_equals_plain(dev, cols, C, path, l_pac=5000):
    """The kernel on the seed columns `cols` equals the plain loop,
    tensor for tensor, through the kernel path `path`."""
    t = [torch.as_tensor(a, device=dev) for a in cols]
    n0 = kernels.LAUNCHES["chain_loop"]
    p0 = dict(chain.PATH_LAUNCHES)
    got = chain.chain_loop(*t, l_pac, C, OPT.w, OPT.max_chain_gap)
    assert kernels.LAUNCHES["chain_loop"] == n0 + 1
    assert chain.PATH_LAUNCHES[path] == p0[path] + 1
    want = chain.chain_loop_plain(*t, l_pac, C, OPT.w, OPT.max_chain_gap)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    return got


# the register path's lane and chunk boundaries (test_torch_chain.py
# holds the host twin at the same shapes)
CHAIN_EDGE_CS = (1, 31, 32, 33, 64, 256)
CHAIN_EDGE_PS = (1, 31, 32, 33, 100)


@pytest.mark.cuda
@pytest.mark.parametrize("P", CHAIN_EDGE_PS)
@pytest.mark.parametrize("C", CHAIN_EDGE_CS)
def test_chain_kernel_at_lane_boundaries(dev, C, P):
    _chain_on_card_equals_plain(dev, chain_edge_seeds(7 * C + P, 12, P,
                                                      5000), C, "registers")


# the bench shape, an escalated one, the ladder's widest (P 2,048, C 256)
# and the wide path (C 320)
@pytest.mark.cuda
@pytest.mark.parametrize("B,P,C,path", [(4096, 256, 64, "registers"),
                                        (1024, 1024, 128, "registers"),
                                        (256, 2048, 256, "registers"),
                                        (64, 400, 320, "wide")])
def test_chain_kernel_at_main_shapes(dev, B, P, C, path):
    got = _chain_on_card_equals_plain(
        dev, chain_edge_seeds(B + P + C, B, P, 5000), C, path)
    assert bool(got["ovf"].any()) and int(got["n"].max()) == min(C, P)


@pytest.mark.cuda
def test_chain_kernel_picks_path_by_shape(dev):
    """The same seeds at C = 256 take the register path, at C = 257 the
    wide one, with the same results (no read opens 256 chains): the
    launch width alone decides."""
    cols = chain_edge_seeds(31, 40, 200, 5000)
    lim = kernels.load("chain_loop").fgdp_chain_reg_max_c()
    assert lim == max(CHAIN_EDGE_CS)
    a = _chain_on_card_equals_plain(dev, cols, lim, "registers")
    b = _chain_on_card_equals_plain(dev, cols, lim + 1, "wide")
    for k in a:
        want = a[k]
        got = b[k][:, :lim] if k in chain.LOOP_FIELDS else b[k]
        assert torch.equal(got, want), k


@pytest.mark.cuda
def test_chain_kernel_times_each_launch_when_asked(dev):
    kernels.TIMED["chain_loop"] = []
    try:
        _chain_on_card_equals_plain(dev, chain_edge_seeds(5, 64, 256, 5000),
                                    64, "registers")
        pairs = kernels.TIMED["chain_loop"]
    finally:
        kernels.TIMED.pop("chain_loop", None)
    torch.cuda.synchronize()
    assert len(pairs) == 1 and pairs[0][0].elapsed_time(pairs[0][1]) > 0


def _flt_on_card_equals_plain(dev, tbl, C, opt, is_alt=None):
    """The chain filter kernel on the table `tbl` equals the plain
    version, exactly, in one launch."""
    is_alt = alt_table() if is_alt is None else is_alt
    st = {f: torch.as_tensor(tbl[f], device=dev) for f in chain.FLT_FIELDS}
    weight = torch.as_tensor(tbl["weight"], device=dev)
    dref = SimpleNamespace(is_alt=torch.as_tensor(is_alt, device=dev),
                           n_contigs=len(is_alt))
    n0 = kernels.LAUNCHES["chain_flt"]
    got = chain.chain_flt(st, weight, dref, opt, C)
    assert kernels.LAUNCHES["chain_flt"] == n0 + 1
    want = chain.chain_flt_plain(st, weight, dref, opt, C)
    assert torch.equal(got, want)
    return got


# chain counts at the warp's 32-rank passes, the ladder's widest (256)
# and repeat_rich's (384); options as tests/test_torch_chain_flt.py's
CHAIN_FLT_EDGE_CS = (1, 31, 32, 33, 64, 256, 384)
CHAIN_FLT_OPTS = {
    "mcw30": dict(min_chain_weight=30),
    "mce2": dict(max_chain_extend=2, min_chain_weight=31,
                 max_chain_gap=50),
    "f32": dict(mask_level=0.3, drop_ratio=0.6, min_seed_len=5),
}


@pytest.mark.cuda
@pytest.mark.parametrize("opts", sorted(CHAIN_FLT_OPTS))
@pytest.mark.parametrize("C", CHAIN_FLT_EDGE_CS)
def test_chain_flt_kernel_at_edges(dev, C, opts):
    opt = dataclasses.replace(OPT, **CHAIN_FLT_OPTS[opts])
    _flt_on_card_equals_plain(dev, flt_tables(C, 40, C), C, opt)


# (B, C) of the ladder's launches: the primary batch and the widest
# bucket of each level, with the default BatchShapes and repeat_rich's
CHAIN_FLT_LADDER = ((4096, 64), (2048, 128), (512, 256), (4096, 96),
                    (2048, 192), (512, 384))


@pytest.mark.cuda
@pytest.mark.parametrize("B,C", CHAIN_FLT_LADDER)
def test_chain_flt_kernel_at_ladder_shapes(dev, B, C):
    got = _flt_on_card_equals_plain(dev, flt_tables(B + C, B, C), C, OPT)
    assert {0, 1, 2, 3} <= set(got.unique().tolist())


@pytest.mark.cuda
def test_chain_flt_kernel_on_chain_loop_output(dev):
    """P2's own table at the bench shape, as chain_seeds hands it on."""
    cols = [torch.as_tensor(a, device=dev)
            for a in synth_seeds(21, 4096, 256, 5000)]
    st = chain.chain_loop(*cols, 5000, 64, OPT.w, OPT.max_chain_gap)
    tbl = {f: st[f].cpu().numpy() for f in chain.FLT_FIELDS}
    tbl["weight"] = chain.chain_weight(st).cpu().numpy()
    _flt_on_card_equals_plain(dev, tbl, 64, OPT, np.zeros(2, bool))


@pytest.mark.cuda
def test_chain_flt_kernel_times_each_launch_when_asked(dev):
    kernels.TIMED["chain_flt"] = []
    try:
        _flt_on_card_equals_plain(dev, flt_tables(3, 256, 64), 64, OPT)
        pairs = kernels.TIMED["chain_flt"]
    finally:
        kernels.TIMED.pop("chain_flt", None)
    torch.cuda.synchronize()
    assert len(pairs) == 1 and pairs[0][0].elapsed_time(pairs[0][1]) > 0


@pytest.mark.cuda
def test_chain_flt_kernel_refuses_c_above_its_widest(dev):
    lim = kernels.load("chain_flt").fgdp_chain_flt_max_c()
    assert lim >= 384
    C = lim + 1
    st = {f: torch.zeros((2, C), dtype=torch.int32, device=dev)
          for f in chain.FLT_FIELDS}
    st["n"] = torch.zeros(2, dtype=torch.int32, device=dev)
    dref = SimpleNamespace(is_alt=torch.zeros(1, dtype=torch.bool,
                                              device=dev), n_contigs=1)
    n0 = kernels.LAUNCHES["chain_flt"]
    with pytest.raises(RuntimeError, match="chain_flt launch failed"):
        chain.chain_flt(st, st["pos"], dref, OPT, C)
    assert kernels.LAUNCHES["chain_flt"] == n0
    # the widest C itself launches
    st = {f: a[:, :lim] if a.dim() == 2 else a for f, a in st.items()}
    kept = chain.chain_flt(st, st["pos"], dref, OPT, lim)
    assert kernels.LAUNCHES["chain_flt"] == n0 + 1
    assert not bool(kept.any())


@pytest.mark.cuda
def test_aligner_on_card_equals_cpu(dev):
    from fgdp_tpu_torch.index.fmindex import FMIndex
    from fgdp_tpu_torch.index.reference import PackedReference
    from fgdp_tpu_torch.io.fastq import parse_fastq_records
    from fgdp_tpu_torch.pipeline import Aligner
    from fgdp_tpu_torch.utils import dna

    pref = PackedReference.from_fasta(os.path.join(HERE, "rep_ref.fa"))
    fm = FMIndex.build(pref.codes)
    recs = list(parse_fastq_records(os.path.join(HERE, "rep.fq")))
    names = [r[0] for r in recs]
    seqs = [dna.encode(r[2]).astype(np.int64) for r in recs]
    quals = [r[3].decode() for r in recs]
    shapes = BatchShapes(batch_reads=128)
    on_card = Aligner(pref, fm, shapes=shapes, device=dev)
    on_cpu = Aligner(pref, fm, shapes=shapes, device="cpu")
    assert on_card.align_batch(names, seqs, quals) == \
        on_cpu.align_batch(names, seqs, quals)


def _kswv_on_card_equals_plain(dev, jobs, pen, path):
    args = [torch.as_tensor(a, device=dev) for a in jobs]
    n0, p0 = kernels.LAUNCHES["kswv"], kswv.PATH_LAUNCHES[path]
    got = kswv.kswv_forward(*args, **pen)
    assert kernels.LAUNCHES["kswv"] == n0 + 1
    assert kswv.PATH_LAUNCHES[path] == p0 + 1
    want = kswv.kswv_forward_plain(*args, **pen)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("pen", sorted(KSWV_PENALTIES))
@pytest.mark.parametrize("QP", KSWV_EDGE_QPS)
def test_kswv_kernel_at_lane_boundaries(dev, QP, pen):
    best = _kswv_on_card_equals_plain(dev, kswv_jobs(QP, 96, QP, 300),
                                      KSWV_PENALTIES[pen], "registers")[0]
    assert int(best.max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("QP", KSWV_WIDE_QPS)
def test_kswv_kernel_wide(dev, QP):
    """Queries above the register path's widest take the wide path, and
    it equals the register path where both apply (the same jobs padded
    wider give the same results)."""
    jobs = kswv_jobs(QP + 1, 64, QP, 512)
    _kswv_on_card_equals_plain(dev, jobs, KSWV_PENALTIES["default"],
                               "wide")
    narrow = kswv_jobs(5, 64, 160, 512)
    got = _kswv_on_card_equals_plain(dev, narrow, KSWV_PENALTIES["default"],
                                     "registers")
    q = np.full((64, QP), 4, np.int32)
    q[:, :160] = narrow[0]
    wide = _kswv_on_card_equals_plain(
        dev, (q,) + narrow[1:], KSWV_PENALTIES["default"], "wide")
    assert all(torch.equal(a, b) for a, b in zip(got[:2], wide[:2]))
    assert torch.equal(got[3], wide[3])
    assert torch.equal(got[2], wide[2][:, :160])


@pytest.mark.cuda
@pytest.mark.parametrize("pen", ["default", "large_e_ins", "pacbio",
                                 "byte_edge"])
@pytest.mark.parametrize("QP", KSWV_EDGE_QPS)
def test_kswv_kernel_wavefront_edges(dev, QP, pen):
    """kswv_wave_jobs: targets of 0-33 and TP - 1 rows, padding jobs, a
    best decided in the wavefront's drain, tied row maxima."""
    jobs, (te9, te10) = kswv_wave_jobs(QP, QP)
    _, te, _, _ = _kswv_on_card_equals_plain(dev, jobs, KSWV_PENALTIES[pen],
                                             "registers")
    if QP >= 16:
        assert int(te[9]) == te9 and int(te[10]) == te10


@pytest.mark.cuda
def test_kswv_kernel_scores_outside_a_byte_take_the_wide_path(dev):
    jobs = kswv_jobs(12, 64, 160, 300)
    for pen in (dict(KSWV_PENALTIES["default"], a=128),
                dict(KSWV_PENALTIES["default"], b=129)):
        _kswv_on_card_equals_plain(dev, jobs, pen, "wide")


@pytest.mark.cuda
def test_kswv_kernel_on_a_mostly_empty_batch(dev):
    jobs = kswv_jobs(3, 256, 160, 512, empty=0.9)
    best, te, _, row_max = _kswv_on_card_equals_plain(
        dev, jobs, KSWV_PENALTIES["default"], "registers")
    empty = torch.as_tensor(jobs[3] == 0, device=dev)
    assert int(best[empty].abs().sum()) == 0 and bool((te[empty] == -1).all())
    assert int(row_max[empty].abs().sum()) == 0 and int(best.max()) > 0


@pytest.mark.cuda
def test_kswv_kernel_times_each_launch_when_asked(dev):
    kernels.TIMED["kswv"] = []
    try:
        _kswv_on_card_equals_plain(dev, kswv_jobs(9, 64, 160, 512),
                                   KSWV_PENALTIES["default"], "registers")
        pairs = kernels.TIMED["kswv"]
    finally:
        kernels.TIMED.pop("kswv", None)
    torch.cuda.synchronize()
    assert len(pairs) == 1 and pairs[0][0].elapsed_time(pairs[0][1]) > 0


@pytest.mark.cuda
def test_align_pairs_on_card_equals_cpu(dev):
    """The golden pairs, five of them with the second end baited (every
    12th base changed: only mate rescue places it), in one batch."""
    from fgdp_tpu_torch.index.fmindex import FMIndex
    from fgdp_tpu_torch.index.reference import PackedReference
    from fgdp_tpu_torch.io.fastq import parse_fastq_records
    from fgdp_tpu_torch.pipeline import Aligner
    from fgdp_tpu_torch.utils import dna

    pref = PackedReference.from_fasta(os.path.join(HERE, "ref.fa"))
    fm = FMIndex.build(pref.codes)
    names, seqs, quals = [], [], []
    for i, (r1, r2) in enumerate(zip(*(
            parse_fastq_records(os.path.join(HERE, f))
            for f in ("pe1.fq", "pe2.fq")))):
        for k, r in enumerate((r1, r2)):
            s = dna.encode(r[2]).astype(np.int64)
            if k == 1 and i in (3, 17, 41, 75, 95):
                s[::12] = (s[::12] + 1) % 4
            names.append(r[0])
            seqs.append(s)
            quals.append(r[3].decode())
    shapes = BatchShapes(batch_reads=len(seqs))
    on_card = Aligner(pref, fm, shapes=shapes, device=dev)
    on_cpu = Aligner(pref, fm, shapes=shapes, device="cpu")
    n0 = kernels.LAUNCHES["kswv"]
    card_lines = on_card.align_pairs(names, seqs, quals)
    assert kernels.LAUNCHES["kswv"] > n0
    assert card_lines == on_cpu.align_pairs(names, seqs, quals)


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(HMM_CASES))
def test_pairhmm_kernel_equals_plain(dev, case):
    *arrs, cap = hmm_f32_inputs(*hmm_cases(*HMM_CASES[case]["args"]))
    args = [torch.as_tensor(a, device=dev) for a in arrs]
    n0 = kernels.LAUNCHES["pairhmm"]
    got = pairhmm.forward_f32_any(*args, n_doubling_cap=cap)
    assert kernels.LAUNCHES["pairhmm"] == n0 + 1
    want = pairhmm.forward_f32(*args, n_doubling_cap=cap)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_pairhmm_kernel_refuses_lengths_above_width(dev):
    *arrs, cap = hmm_f32_inputs(*hmm_cases(5, 8, 16, 32))
    args = [torch.as_tensor(a, device=dev) for a in arrs]
    args[5][2] = 33                      # hlen above H = 32
    n0 = kernels.LAUNCHES["pairhmm"]
    with pytest.raises(ValueError, match="rlens/hlens"):
        pairhmm.forward_f32_kernel(*args, n_doubling_cap=cap)
    assert kernels.LAUNCHES["pairhmm"] == n0


def _pairhmm_on_card_equals_plain(dev, args, path):
    """The kernel on the f32 inputs of `args` equals the plain version
    bit for bit (log10 and raw sum), through the kernel path `path`."""
    *arrs, cap = hmm_f32_inputs(*args)
    t = [torch.as_tensor(a, device=dev) for a in arrs]
    n0 = kernels.LAUNCHES["pairhmm"]
    p0 = dict(pairhmm.PATH_LAUNCHES)
    got = pairhmm.forward_f32_kernel(*t, n_doubling_cap=cap)
    assert kernels.LAUNCHES["pairhmm"] == n0 + 1
    assert pairhmm.PATH_LAUNCHES[path] == p0[path] + 1
    want = pairhmm.forward_f32(*t, n_doubling_cap=cap)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("cq", [10, 5])
@pytest.mark.parametrize("H", HMM_EDGE_HS)
def test_pairhmm_kernel_at_lane_boundaries(dev, H, cq):
    _pairhmm_on_card_equals_plain(
        dev, hmm_edge_pairs(H + cq, H, cq=cq), "registers")


@pytest.mark.cuda
def test_pairhmm_kernel_at_a_scale_launch(dev):
    """Launches as mutect's batcher makes them: 309 ragged pairs at its
    most common bucket (R 64, H 64) and at a wider one (R 160, H 320)."""
    for seed, R, H in ((15, 64, 64), (18, 160, 320)):
        _pairhmm_on_card_equals_plain(dev, hmm_cases(seed, 309, R, H),
                                      "registers")


@pytest.mark.cuda
@pytest.mark.parametrize("cq", [10, 5])
def test_pairhmm_kernel_wide(dev, cq):
    _pairhmm_on_card_equals_plain(
        dev, hmm_edge_pairs(HMM_WIDE_H + cq, HMM_WIDE_H, R=24, cq=cq), "wide")


@pytest.mark.cuda
def test_pairhmm_kernel_picks_path_by_shape(dev):
    """The same pairs padded to H = 639 take the register path, to
    H = 640 the wide one, with the same results: the launch width alone
    decides."""
    reads, rlens, q, iq, dq, c, haps, hlens = hmm_cases(16, 40, 48, 600)
    lim = kernels.load("pairhmm").fgdp_pairhmm_reg_max_h()
    assert lim == max(HMM_EDGE_HS)
    out = []
    for H, path in ((lim, "registers"), (lim + 1, "wide")):
        h = np.zeros((len(haps), H), np.int32)
        h[:, :haps.shape[1]] = haps
        out.append(_pairhmm_on_card_equals_plain(
            dev, (reads, rlens, q, iq, dq, c, h, hlens), path))
    for a, b in zip(*out):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_pairhmm_kernel_times_each_launch_when_asked(dev):
    kernels.TIMED["pairhmm"] = []
    try:
        _pairhmm_on_card_equals_plain(dev, hmm_cases(17, 64, 160, 256),
                                      "registers")
        pairs = kernels.TIMED["pairhmm"]
    finally:
        kernels.TIMED.pop("pairhmm", None)
    torch.cuda.synchronize()
    assert len(pairs) == 1 and pairs[0][0].elapsed_time(pairs[0][1]) > 0


@pytest.mark.cuda
def test_caller_on_card_equals_cpu(dev):
    from fgdp_tpu_torch.call.engine import Mutect2Engine
    from fgdp_tpu_torch.cli import _bam_to_read_dicts
    from fgdp_tpu_torch.io.fasta import read_fasta

    fix = os.path.join(HERE, "mutect")
    ref = read_fasta(os.path.join(fix, "ref.fa"))
    _, _, tumor = _bam_to_read_dicts(os.path.join(fix, "tumor.bam"))
    _, _, normal = _bam_to_read_dicts(os.path.join(fix, "normal.bam"))
    codes = ref.contig_codes(0)
    t = [r for r in tumor if r["rid"] == 0]
    n = [r for r in normal if r["rid"] == 0]
    n0 = kernels.LAUNCHES["pairhmm"]
    on_card = Mutect2Engine(codes, ref.names[0], device=dev).call(t, n)
    assert kernels.LAUNCHES["pairhmm"] > n0
    on_cpu = Mutect2Engine(codes, ref.names[0], device="cpu").call(t, n)
    assert len(on_card) == len(on_cpu) > 0
    # the kernel equals the plain version bit for bit; torch's f32 log10
    # differs by an ulp between the card and the CPU (~4e-6 per read),
    # and a LOD sums some 60 reads' log-likelihoods
    for a, b in zip(on_card, on_cpu):
        assert (a.pos, a.ref, a.alt, a.filters) == \
            (b.pos, b.ref, b.alt, b.filters)
        assert abs(a.tlod - b.tlod) <= 1e-4 and abs(a.nlod - b.nlod) <= 1e-4


@pytest.mark.cuda
def test_cnn_gate_on_card_equals_cpu(dev, tmp_path):
    """The gated caller on the 120x fixture: the card's forward keeps and
    drops the same regions as the CPU's, row for row."""
    from fgdp_tpu_torch.call import cnn_filter
    from fgdp_tpu_torch.call.engine import Mutect2Engine
    from fgdp_tpu_torch.cli import _bam_to_read_dicts
    from fgdp_tpu_torch.io.fasta import read_fasta

    fix = os.path.join(HERE, "mutect_cnn")
    model = gate_model(tmp_path / "gate.pt", 2, scale=400.0)
    ref = read_fasta(os.path.join(fix, "ref.fa"))
    _, _, t = _bam_to_read_dicts(os.path.join(fix, "tumor.bam"))
    _, _, n = _bam_to_read_dicts(os.path.join(fix, "normal.bam"))
    rows = []
    inner = cnn_filter.CnnFilter.scores

    def spy(self, inputs):
        rows.append(inputs)
        return inner(self, inputs)

    cnn_filter.CnnFilter.scores = spy
    try:
        card = Mutect2Engine(ref.contig_codes(0), ref.names[0],
                             cnn_model_path=model, device=dev)
        on_card = card.call(t, n)
    finally:
        cnn_filter.CnnFilter.scores = inner
    cpu = Mutect2Engine(ref.contig_codes(0), ref.names[0],
                        cnn_model_path=model, device="cpu")
    on_cpu = cpu.call(t, n)
    assert card.gated_regions == cpu.gated_regions > 0
    assert card.gate_dropped == cpu.gate_dropped
    assert [(c.pos, c.ref, c.alt) for c in on_card] == \
        [(c.pos, c.ref, c.alt) for c in on_cpu]
    x = np.concatenate(rows)
    a, b = card.cnn.scores(x), cpu.cnn.scores(x)
    assert cnn_filter.passes(a).tolist() == cnn_filter.passes(b).tolist()


@pytest.mark.cuda
def test_sharded_aligner_on_card_equals_cpu(dev):
    """Two shards (the golden pairs' contig and the repeat fixture's),
    the golden pairs with five ends baited: the card's SAM equals the
    CPU's, and P1, P2 and D6 launch."""
    from fgdp_tpu_torch.index.reference import PackedReference
    from fgdp_tpu_torch.io.fasta import read_fasta
    from fgdp_tpu_torch.io.fastq import parse_fastq_records
    from fgdp_tpu_torch.parallel.sharded_index import ShardedAligner
    from fgdp_tpu_torch.utils import dna

    seqs_ref = [read_fasta(os.path.join(HERE, f)).contig_codes(0)
                for f in ("ref.fa", "rep_ref.fa")]
    pref = PackedReference.from_contigs(["chrG", "chrR"], seqs_ref)
    names, seqs, quals = [], [], []
    for i, (r1, r2) in enumerate(zip(*(
            parse_fastq_records(os.path.join(HERE, f))
            for f in ("pe1.fq", "pe2.fq")))):
        for k, r in enumerate((r1, r2)):
            s = dna.encode(r[2]).astype(np.int64)
            if k == 1 and i in (3, 17, 41, 75, 95):
                s[::12] = (s[::12] + 1) % 4
            names.append(r[0])
            seqs.append(s)
            quals.append(r[3].decode())
    shapes = BatchShapes(batch_reads=len(seqs))
    on_card = ShardedAligner(pref, 2, shapes=shapes, device=dev)
    on_cpu = ShardedAligner(pref, 2, shapes=shapes, device="cpu")
    assert len(on_card.shards) == 2
    kernels.reset_launches()
    card_pe = on_card.align_pairs(names, seqs, quals)
    card_se = on_card.align_batch(names, seqs, quals)
    assert all(kernels.LAUNCHES[k] > 0
               for k in ("sw_extend", "chain_loop", "kswv"))
    assert card_pe == on_cpu.align_pairs(names, seqs, quals)
    assert card_se == on_cpu.align_batch(names, seqs, quals)


@pytest.mark.cuda
@pytest.mark.parametrize("n_chains", [4, 8, 16])
def test_vpu_ceiling_kernel_equals_plain(dev, n_chains):
    from fgdp_tpu_torch.probes import vpu_ceiling as vc

    rng = np.random.default_rng(n_chains)
    xf = torch.as_tensor(rng.random((7, 300), np.float32), device=dev)
    xi = torch.as_tensor(rng.integers(-2**31, 2**31, (7, 300))
                         .astype(np.int32), device=dev)
    n0 = kernels.LAUNCHES["vpu_ceiling"]
    got = vc.vpu_ceiling(xf, vc.CHECK_STEPS, n_chains)
    want = vc.vpu_ceiling_plain(xf, vc.CHECK_STEPS, n_chains)
    assert torch.isfinite(want).all()
    assert ((got - want).abs() / want.abs()).max() <= vc.FP32_RTOL
    assert torch.equal(vc.vpu_ceiling(xi, 9, n_chains),
                       vc.vpu_ceiling_plain(xi, 9, n_chains))
    assert kernels.LAUNCHES["vpu_ceiling"] == n0 + 2


@pytest.mark.cuda
def test_vpu_ceiling_kernel_refuses_bad_arguments(dev):
    from fgdp_tpu_torch.probes import vpu_ceiling as vc

    n0 = kernels.LAUNCHES["vpu_ceiling"]
    x = torch.zeros(64, device=dev)
    with pytest.raises(ValueError, match="n_chains"):
        vc.vpu_ceiling_kernel(x, 3, 5)
    with pytest.raises(ValueError, match="float32 or int32"):
        vc.vpu_ceiling_kernel(x.double(), 3, 4)
    assert kernels.LAUNCHES["vpu_ceiling"] == n0


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 8, 16, 32])
def test_gather_rows_kernel_equals_plain(dev, depth):
    from fgdp_tpu_torch.probes import gather

    tbl = gather.table(dev, rows=5000)
    for n in (1, 33, 1000):
        idx = gather.indices(dev, n, seed=n, rows=5000)
        assert torch.equal(gather.gather_rows(tbl, idx, depth),
                           gather.gather_rows_plain(tbl, idx))
    narrow = tbl[:, :12].contiguous()          # three 16-byte chunks
    idx = gather.indices(dev, 70, seed=3, rows=5000)
    assert torch.equal(gather.gather_rows(narrow, idx, depth),
                       gather.gather_rows_plain(narrow, idx))
    i0 = gather.indices(dev, 256, seed=4, rows=5000)
    assert torch.equal(
        gather.chain(tbl, i0, lambda t, i: gather.gather_rows(t, i, depth),
                     steps=8),
        gather.chain(tbl, i0, gather.gather_rows_plain, steps=8))


@pytest.mark.cuda
def test_gather_chase_kernel_equals_plain(dev):
    """The dependent-gather probe: chains alone and under each grid
    barrier a hop (cooperative_groups' and the seeding kernels' GridBar in
    either form) equal the plain chase; the latency and every barrier are
    timed."""
    from fgdp_tpu_torch.probes import chase

    occ = chase.table(dev, rows=50_000)
    n0 = kernels.LAUNCHES["gather_chase"]
    chase.check(occ)
    assert torch.equal(chase.chase(occ, 3, 0), chase.chase_plain(occ, 3, 0))
    assert kernels.LAUNCHES["gather_chase"] == n0 + 2 + len(chase.BARRIERS)
    cold, warm = chase.latency_us(occ, hops=256)
    assert cold > 0 and warm > 0
    for sync in chase.BARRIERS:
        assert chase.barrier_us(occ, 8, 64, hops=64, sync=sync) > 0


@pytest.mark.cuda
def test_gather_rows_kernel_refuses_bad_arguments(dev):
    from fgdp_tpu_torch.probes import gather

    tbl = gather.table(dev, rows=100)
    idx = gather.indices(dev, 10, seed=0, rows=100)
    n0 = kernels.LAUNCHES["gather_rows"]
    for bad in (idx.clone().fill_(100), idx.clone().fill_(-1)):
        with pytest.raises(ValueError, match="out of range"):
            gather.gather_rows_kernel(tbl, bad)
    with pytest.raises(ValueError, match="int32"):
        gather.gather_rows_kernel(tbl.long(), idx)
    with pytest.raises(ValueError, match="multiple of 4"):
        gather.gather_rows_kernel(tbl[:, :6].contiguous(), idx)
    with pytest.raises(ValueError, match="depth"):
        gather.gather_rows_kernel(tbl, idx, depth=3)
    with pytest.raises(ValueError, match="2-D"):
        gather.gather_rows_kernel(tbl[0], idx)
    assert kernels.LAUNCHES["gather_rows"] == n0


@pytest.mark.cuda
def test_sormadup_on_card_equals_cpu(dev, tmp_path):
    from fgdp_tpu_torch import cli

    sam = tmp_path / "in.sam"
    sam.write_text("\n".join(HEADER + random_sam(11)) + "\n")
    out = {}
    for d in ("cuda", "cpu"):
        bam = tmp_path / f"{d}.bam"
        cli.main(["sormadup", str(sam), str(bam), "--device", d])
        out[d] = (bam.read_bytes(),
                  (tmp_path / f"{d}.bam.bai").read_bytes())
    assert out["cuda"] == out["cpu"]


def seeding_world(seed=7, n_ref=600, n_reads=24, L=48):
    """tests/test_smem_sweep.py's world and a read mix like
    test_smem.make_reads' (planted, mutated, junk, with N), made here
    without JAX."""
    from fgdp_tpu_torch.index.fmindex import FMIndex
    from fgdp_tpu_torch.index.reference import PackedReference
    from fgdp_tpu_torch.utils import dna

    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, size=n_ref, dtype=np.uint8)
    pref = PackedReference.from_contigs(["chr1"], [ref])
    text = np.concatenate([ref, dna.revcomp(ref)])
    reads = np.zeros((n_reads, L), np.int32)
    for i in range(n_reads):
        p = rng.integers(0, len(text) - L)
        reads[i] = text[p:p + L]
        if i % 4 == 1:
            reads[i, rng.integers(0, L, 3)] = rng.integers(0, 4, 3)
        elif i % 4 == 2:
            reads[i] = rng.integers(0, 4, L)
        elif i % 4 == 3:
            reads[i, rng.integers(0, L, 2)] = 4
    return rng, ref, pref, FMIndex.build(pref.codes), reads


@pytest.mark.cuda
def test_seeding_engines_on_card_equal_cpu(dev):
    """The wave machine, the sweep (K1 and K2 shapes, at default and at
    tight caps) and collect_seeds on each engine: every output on the
    card equals the CPU's exactly."""
    from fgdp_tpu_torch.align import seeding
    from fgdp_tpu_torch.index.lcptree import LcpTree
    from fgdp_tpu_torch.index.reference import DeviceReference
    from fgdp_tpu_torch.ops import smem, smem_sweep
    from fgdp_tpu_torch.ops.fm import DeviceFMIndex
    from fgdp_tpu_torch.utils import dna

    rng, ref, pref, fm, reads = seeding_world()
    B, L = reads.shape
    NJ = 2 * B
    host = dict(codes=reads, lens=rng.integers(L // 2, L + 1, B)
                .astype(np.int32), mi=np.ones(B, np.int32),
                act=rng.random(B) < 0.85,
                ridx=np.repeat(np.arange(B), 2).astype(np.int32),
                x=rng.integers(0, L, NJ).astype(np.int32),
                jmi=rng.integers(2, 6, NJ).astype(np.int32),
                jon=rng.random(NJ) < 0.85)
    x = np.concatenate([ref, dna.revcomp(ref)]).astype(np.uint8)
    lcp = LcpTree.build(x, fm.sa)
    out = {}
    for d in (dev, torch.device("cpu")):
        t = {k: torch.as_tensor(v, device=d) for k, v in host.items()}
        dfm = DeviceFMIndex.from_host(fm, device=d)
        dref = DeviceReference(pref, device=d)
        r = {}
        r["wave"] = smem.smem_all_pos(
            dfm, dref.codes, dref.l_pac, t["codes"], t["lens"], t["mi"],
            t["act"], 8, max_seeds=64, prev_cap=50,
            ref_codes16=dref.codes16)
        lanes, nx = smem.smem_one_pos_lanes(
            dfm, dref.codes, dref.l_pac, t["codes"], t["lens"], t["ridx"],
            t["x"], t["jmi"], t["jon"], 8, 50, 8,
            ref_codes16=dref.codes16)
        r["wave_lanes"], r["wave_nx"] = lanes, nx
        for tag, ec, bm, pc in (("auto", 0, 0, 50), ("tight", 6, 2, 4)):
            r[f"sweep_{tag}"] = smem_sweep.smem_all_pos_sweep(
                dfm, dref.codes16, t["codes"], t["lens"], t["mi"],
                t["act"], 8, max_seeds=64, prev_cap=pc, entry_cap=ec,
                bwd_mult=bm)
            r[f"lanes_{tag}"] = smem_sweep.smem_lanes_sweep(
                dfm, dref.codes16, t["codes"], t["lens"], t["ridx"],
                t["x"], t["jmi"], t["jon"], 8, prev_cap=pc, B=B,
                max_seeds=64, entry_cap=ec, bwd_mult=bm, walk=False)
        tree = dict(lcp_tree=torch.as_tensor(lcp.tree, device=d),
                    lcp_isa=torch.as_tensor(lcp.isa, device=d))
        opt = AlignConfig(min_seed_len=10, max_mem_intv=20, split_width=10)
        for name, kw in (("sweep", {}), ("wave", dict(use_sweep=False)),
                         ("lcp", tree)):
            r[f"collect_{name}"] = seeding.collect_seeds(
                dfm, dref, t["codes"], t["lens"], t["act"], opt,
                max_seeds=64, **kw)
        out[d.type] = r
    for k, got in out["cuda"].items():
        want = out["cpu"][k]
        if isinstance(got, torch.Tensor):
            assert torch.equal(got.cpu(), want), k
            continue
        for f in got._fields:
            assert torch.equal(getattr(got, f).cpu(), getattr(want, f)), \
                (k, f)
    assert bool(out["cpu"]["sweep_tight"].overflow.any())


@pytest.mark.cuda
def test_exact_search_on_card_equals_cpu(dev):
    """RMI interval, exact search and inexact search (z = 1, and an
    output buffer small enough to overflow) on the card equal the CPU's
    exactly."""
    from fgdp_tpu_torch.index.rmi import RMIndex
    from fgdp_tpu_torch.ops import exact
    from fgdp_tpu_torch.ops.fm import DeviceFMIndex
    from fgdp_tpu_torch.utils import dna

    rng, ref, pref, fm, reads = seeding_world(seed=17, n_ref=1500,
                                              n_reads=32, L=41)
    x = np.concatenate([ref, dna.revcomp(ref)]).astype(np.uint8)
    rmi = RMIndex.build(x, fm.sa, leaf_bits=8)
    lens = np.full(len(reads), 41, np.int32)
    lens[2::4] = rng.integers(0, 15, len(lens[2::4]))
    qkeys = np.concatenate([rmi.keys[rng.integers(0, len(rmi.keys), 30)],
                            [rmi.keys[-1], 0]]).astype(np.int32)
    out = {}
    for d in (dev, torch.device("cpu")):
        dfm = DeviceFMIndex.from_host(fm, device=d)
        drmi = exact.DeviceRMI.from_host(rmi, device=d)
        t = lambda a: torch.as_tensor(a, device=d)
        short = t(reads[:, :17].copy())
        out[d.type] = (
            exact.rmi_interval(drmi, t(qkeys))
            + exact.exact_search(dfm, drmi, t(reads), t(lens))
            + exact.inexact_search(dfm, short, t(np.full(32, 17, np.int32)),
                                   z=1, max_out=64)
            + exact.inexact_search(dfm, t(reads[:, :9].copy()),
                                   t(np.full(32, 9, np.int32)), z=2,
                                   max_out=4))
    for i, (a, b) in enumerate(zip(out["cuda"], out["cpu"])):
        assert torch.equal(a.cpu(), b), i
    assert bool(out["cpu"][-1].any())


# the seeding kernels at the escalation ladder's shapes: (B, scale) with
# K1's max_seeds 160 x scale and max_rounds 24 x scale, K2's NK = 2 B
# k2_scale jobs with sj_cap 16, ascent_cap 64 and max_rounds 48 times
# k2_scale (k2_scale = scale here), K3's max_seeds 160 x scale; B 5 keeps
# every lane in K1's cascade, B 100 is no power of two
SEED_LADDER = ((5, 1), (100, 1), (128, 2), (512, 1), (1024, 2),
               (2048, 4))


@pytest.fixture(scope="module")
def seed_ctx():
    g = gen_genome(300_000, seed=0)
    return g, seed_index(g)


def _seed_equal(got, want, what):
    for f in got._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), (what, f)


@pytest.mark.cuda
@pytest.mark.parametrize("B,scale", SEED_LADDER)
def test_seed_kernels_equal_plain(dev, seed_ctx, B, scale):
    """K1, K2 and K3 on the card, each launched (counted) and exactly
    equal to its torch-op loop on the same CUDA inputs."""
    from fgdp_tpu_torch.ops import smem, smem_k2lcp, smem_lcp

    g, index = seed_ctx
    t = seed_tables(index, dev)
    codes, lens, active = seed_reads(g, B, 151, seed=B + scale)
    k1_args = seed_k1_inputs(t, codes, lens, active)
    k1_caps = (160 * scale, t[1].codes16)
    n0 = dict(kernels.LAUNCHES)
    k1 = smem_lcp.smem_all_lcp(*k1_args, *k1_caps, max_rounds=24 * scale)
    _seed_equal(k1, smem_lcp.smem_all_lcp_plain(*k1_args, *k1_caps,
                                                max_rounds=24 * scale), "K1")
    jobs = seed_k2_jobs(t, codes, lens, k1, k2_per_read=2 * scale)
    kw = dict(into=k1, sj_cap=16 * scale, ascent_cap=64 * scale,
              max_rounds=48 * scale)
    k2_args = (t[0], t[2], t[3], k1_args[3], k1_args[4], *jobs,
               OPT.min_seed_len, B, 160 * scale)
    k2 = smem_k2lcp.k2_reseed_lcp(*k2_args, **kw)
    _seed_equal(k2, smem_k2lcp.k2_reseed_lcp_plain(*k2_args, **kw), "K2")
    k3_args = (t[0], k1_args[3], k1_args[4], k1_args[5], OPT.max_mem_intv,
               OPT.min_seed_len + 1, 160 * scale)
    k3 = smem.seed_strategy(*k3_args)
    _seed_equal(k3, smem.seed_strategy_plain(*k3_args), "K3")
    for name in ("smem_lcp", "k2_lcp", "seed_strategy"):
        assert kernels.LAUNCHES[name] == n0[name] + 1, name
    assert int(k2.count.sum()) >= int(k1.count.sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("max_seeds", [160, 2])
def test_k3_kernel_edges_equal_plain(dev, seed_ctx, max_seeds):
    """K3's group kernel on k3_edge_reads (N at the anchor and inside an
    extension, length 0, inactive, overflow at max_seeds 2) and
    k3_cap_reads (the step cap), equal to the torch-op loop."""
    from fgdp_tpu_torch.ops import smem

    g, index = seed_ctx
    t = seed_tables(index, dev)
    for reads in (k3_edge_reads, k3_cap_reads):
        codes, lens, active = reads(g)
        args = (t[0], *(torch.as_tensor(a, device=dev)
                        for a in (codes, lens, active)),
                OPT.max_mem_intv, OPT.min_seed_len + 1, max_seeds)
        work = torch.zeros(4, dtype=torch.int64, device=dev)
        got = smem.seed_strategy_kernel(*args, work=work)
        _seed_equal(got, smem.seed_strategy_plain(*args), "K3")
        if reads is k3_cap_reads:
            assert int(work[3]) == 2 * codes.shape[1] ** 2


@pytest.mark.cuda
@pytest.mark.parametrize("L", [6_144, 6_145])
def test_k3_kernel_long_rows_equal_plain(dev, seed_ctx, L):
    """Batches at the widest L whose eight code buffers a block fit in 48
    KB (6,144: staged) and one past it (the codes read where they lie);
    the reads themselves are short."""
    from fgdp_tpu_torch.ops import smem

    g, index = seed_ctx
    t = seed_tables(index, dev)
    c0, l0, a0 = seed_reads(g, 24, 250, seed=12)
    codes = np.full((24, L), 4, np.int32)
    codes[:, :250] = c0
    args = (t[0], *(torch.as_tensor(a, device=dev) for a in (codes, l0, a0)),
            OPT.max_mem_intv, OPT.min_seed_len + 1, 160)
    got = smem.seed_strategy(*args)
    _seed_equal(got, smem.seed_strategy_plain(*args), "K3")
    assert int(got.count.sum()) > 0


@pytest.mark.cuda
def test_seed_kernels_tight_caps_equal_plain(dev, seed_ctx):
    """Caps tight enough that K1's cascade drops lanes and its round cap
    binds, max_seeds and sj_cap overflow and K2's ascents hit their cap."""
    from fgdp_tpu_torch.ops import smem, smem_k2lcp, smem_lcp

    g, index = seed_ctx
    t = seed_tables(index, dev)
    codes, lens, active = seed_reads(g, 256, 250, seed=9)
    k1_args = seed_k1_inputs(t, codes, lens, active)
    k1 = smem_lcp.smem_all_lcp(*k1_args, 4, t[1].codes16, max_rounds=1)
    _seed_equal(k1, smem_lcp.smem_all_lcp_plain(
        *k1_args, 4, t[1].codes16, max_rounds=1), "K1")
    assert bool(k1.overflow.any()) and bool((k1.count == 4).any())
    wide = smem_lcp.smem_all_lcp(*k1_args, 160, t[1].codes16)
    jobs = seed_k2_jobs(t, codes, lens, wide)
    kw = dict(into=wide, sj_cap=1, ascent_cap=2, max_rounds=1)
    k2_args = (t[0], t[2], t[3], k1_args[3], k1_args[4], *jobs,
               OPT.min_seed_len, 256, 160)
    _seed_equal(smem_k2lcp.k2_reseed_lcp(*k2_args, **kw),
                smem_k2lcp.k2_reseed_lcp_plain(*k2_args, **kw), "K2")
    k3_args = (t[0], k1_args[3], k1_args[4], k1_args[5], OPT.max_mem_intv,
               OPT.min_seed_len + 1, 2)
    k3 = smem.seed_strategy(*k3_args)
    _seed_equal(k3, smem.seed_strategy_plain(*k3_args), "K3")
    assert bool(k3.overflow.any())


@pytest.mark.cuda
def test_seed_kernels_time_each_launch_when_asked(dev, seed_ctx):
    from fgdp_tpu_torch.ops import smem

    g, index = seed_ctx
    t = seed_tables(index, dev)
    codes, lens, active = seed_reads(g, 64, 151, seed=3)
    args = (t[0], *(torch.as_tensor(a, device=dev)
                    for a in (codes, lens, active)),
            OPT.max_mem_intv, OPT.min_seed_len + 1, 160)
    kernels.TIMED["seed_strategy"] = []
    try:
        smem.seed_strategy(*args)
        pairs = kernels.TIMED["seed_strategy"]
    finally:
        kernels.TIMED.pop("seed_strategy", None)
    torch.cuda.synchronize()
    assert len(pairs) == 1 and pairs[0][0].elapsed_time(pairs[0][1]) > 0
    # the work counters: two 96-byte rows a forward step, every step
    work = torch.zeros(4, dtype=torch.int64, device=dev)
    smem.seed_strategy_kernel(*args, work=work)
    gathered, ext_max, steps, longest = work.tolist()
    assert steps >= longest > 0 and gathered % 192 == 0 and gathered > 0
    assert 0 < ext_max < longest and 192 * ext_max <= gathered


@pytest.mark.cuda
def test_seed_kernels_loop_over_lanes_past_resident_threads(dev, seed_ctx):
    """More reads than the card can hold resident threads (2,048 an SM):
    K1's and K2's threads each loop over several lanes, their cascade
    scan and counts over every lane, equal to the torch-op loops."""
    from fgdp_tpu_torch.ops import smem_k2lcp, smem_lcp

    g, index = seed_ctx
    t = seed_tables(index, dev)
    B = torch.cuda.get_device_properties(dev).multi_processor_count * 2048 + 1
    codes, lens, active = seed_reads(g, B, 101, seed=4)
    k1_args = seed_k1_inputs(t, codes, lens, active)
    k1 = smem_lcp.smem_all_lcp(*k1_args, 160, t[1].codes16)
    _seed_equal(k1, smem_lcp.smem_all_lcp_plain(*k1_args, 160,
                                                t[1].codes16), "K1")
    jobs = seed_k2_jobs(t, codes, lens, k1)
    k2_args = (t[0], t[2], t[3], k1_args[3], k1_args[4], *jobs,
               OPT.min_seed_len, B, 160)
    _seed_equal(smem_k2lcp.k2_reseed_lcp(*k2_args, into=k1),
                smem_k2lcp.k2_reseed_lcp_plain(*k2_args, into=k1), "K2")


def _k1_on_card_equals_plain(dev, t, codes, lens, active):
    """K1 on the card equal to its plain version; returns the launch's
    plan."""
    from fgdp_tpu_torch.ops import smem_lcp

    args = seed_k1_inputs(t, codes, lens, active)
    got = smem_lcp.smem_all_lcp_kernel(*args, 160, t[1].codes16)
    want = smem_lcp.smem_all_lcp_plain(*args, 160, t[1].codes16)
    _seed_equal(got, want, "K1")
    return smem_lcp.launch_plan(*codes.shape, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("L,staged", [(151, True), (1600, False)])
def test_k1_kernel_staged_and_in_place_equal_plain(dev, seed_ctx, L,
                                                   staged):
    """K1 at one lane a thread with the reads' codes staged in shared
    memory (L 151) and read where they lie (L 1,600: 64 threads x 50
    words of 16 bytes pass 48 KB), exactly equal to the torch-op loop;
    the wave split's grid steps add up to the launch's."""
    from fgdp_tpu_torch.ops import smem_lcp

    g, index = seed_ctx
    t = seed_tables(index, dev)
    codes, lens, active = seed_reads(g, 256, L, seed=L)
    plan = _k1_on_card_equals_plain(dev, t, codes, lens, active)
    assert (plan.lanes, plan.staged) == (1, staged)
    args = seed_k1_inputs(t, codes, lens, active)
    work = torch.zeros(smem_lcp.WORK_LEN, dtype=torch.int64, device=dev)
    smem_lcp.smem_all_lcp_kernel(*args, 160, t[1].codes16, work=work)
    w = work.cpu().tolist()
    nb = len(smem_lcp.WAVE_BUCKETS)
    assert sum(w[4 + nb:]) == w[1] > 0 and sum(w[4:4 + nb]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("staged", [True, False])
def test_k1_kernel_four_lanes_a_thread_equal_plain(dev, seed_ctx, staged):
    """K1 at four lanes a thread, the codes staged in shared memory or
    read where they lie: one read more than the threads that can be
    resident at one lane a thread, at the first read length whose launch
    takes that form (L 101: four lanes' rows of 4 words fit in 48 KB at
    64 threads a block; L 400: 13 words do not), exactly equal to the
    torch-op loop."""
    from fgdp_tpu_torch.ops import smem_lcp

    g, index = seed_ctx
    t = seed_tables(index, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for L in (101, 400):
        # past every one-lane form's resident threads
        B, plan = 1, smem_lcp.launch_plan(1, L, dev)
        while plan.lanes == 1:
            B = plan.per_sm * sms * plan.threads + 1
            plan = smem_lcp.launch_plan(B, L, dev)
        if (plan.lanes, plan.staged) == (4, staged):
            codes, lens, active = seed_reads(g, B, L, seed=6)
            got = _k1_on_card_equals_plain(dev, t, codes, lens, active)
            assert got == plan
            return
    raise AssertionError(f"no launch of four lanes a thread with staged "
                         f"{staged} among the shapes tried")


# the sweep's kernels (D9 sweep_fwd, D10 sweep_bwd) at the escalation
# ladder's shapes, (B, scale) with scale standing for collect_seeds'
# scale and k2_scale: K1 with prev_cap 20 x scale, E = min(2 L + 16, 192
# x scale) and 44 x scale backward lanes a read, K2 on the jobs of K1's
# seeds (2 B scale of them, walk off) with E = prev_cap + 2 and 16 x
# scale backward lanes a job
SWEEP_LADDER = ((5, 1), (100, 1), (512, 1), (1024, 2), (2048, 4))


def _sweep_equal(got, want, what):
    pairs = [(got[f], want[f], f) for f in want] if isinstance(want, dict) \
        else zip(got, want, ("m", "kf", "sf"))
    for a, b, f in pairs:
        assert torch.equal(a, b), (what, f)


def sweep_phases(dev, t, codes, lens, active, scale, plain):
    """The sweep's K1 and K2 machines on a batch, piece by piece, on the
    kernels (plain=False) or the torch-op loops, the other pieces torch
    ops: the inputs and outputs of each D9 and D10 call, in order."""
    from fgdp_tpu_torch.align import seeding
    from fgdp_tpu_torch.ops import smem_sweep as sw

    dfm, dref = t[0], t[1]
    fwd = sw.fwd_sweep_plain if plain else sw.fwd_sweep
    bwd = sw.bwd_entries_plain if plain else sw.bwd_entries
    B, L = codes.shape
    pc, E = 20 * scale, min(2 * L + 16, 192 * scale)
    rid = torch.arange(B, dtype=torch.int32, device=dev)
    ones = torch.ones(B, dtype=torch.int32, device=dev)
    calls = []
    fa = (dfm, codes, lens, rid, torch.zeros_like(rid), ones, active, pc,
          E, dref.codes16)
    fw = fwd(*fa, restart=True)
    lanes, _ = sw.flatten_entries(fw, rid, ones, E, B * 44 * scale)
    bw = bwd(dfm, codes, lens, lanes, dref.codes16)
    calls += [("K1 D9", fw), ("K1 D10", bw)]
    k1 = sw.emit_merge(lanes, *bw, OPT.min_seed_len, B, 160 * scale)
    split_len = int(OPT.min_seed_len * OPT.split_factor + 0.499)
    _, k_read, job_x, job_mi, k_on, _ = seeding.k2_jobs(
        k1, OPT, split_len, B * 2 * scale)
    fw2 = fwd(dfm, codes, lens, k_read, job_x, job_mi, k_on, pc, pc + 2,
              dref.codes16, restart=False, walk=False)
    lanes2, _ = sw.flatten_entries(fw2, k_read, job_mi, pc + 2,
                                   k_read.shape[0] * 16 * scale)
    bw2 = bwd(dfm, codes, lens, lanes2, dref.codes16)
    calls += [("K2 D9", fw2), ("K2 D10", bw2)]
    return calls


@pytest.mark.cuda
@pytest.mark.parametrize("B,scale", SWEEP_LADDER)
def test_sweep_kernels_equal_plain(dev, seed_ctx, B, scale):
    """D9 and D10 on the card, each launched once a call (counted) and
    exactly equal to its torch-op loop at every stage of the sweep's K1
    and K2."""
    g, index = seed_ctx
    t = seed_tables(index, dev)
    batch = [torch.as_tensor(a, device=dev)
             for a in seed_reads(g, B, 151, seed=B + scale)]
    n0 = dict(kernels.LAUNCHES)
    got = sweep_phases(dev, t, *batch, scale, plain=False)
    for name in ("sweep_fwd", "sweep_bwd"):
        assert kernels.LAUNCHES[name] == n0[name] + 2, name
    want = sweep_phases(dev, t, *batch, scale, plain=True)
    for (what, a), (_, b) in zip(got, want):
        _sweep_equal(a, b, what)
    assert int(got[0][1]["ecount"].sum()) > 0
    assert bool((got[1][1][1] < -1).any())      # walked single suffixes


@pytest.mark.cuda
def test_sweep_kernels_tight_caps_equal_plain(dev, seed_ctx):
    """D9 at caps where povf and eovf fire, D10 on a cut pool (drop_ovf),
    equal to the torch-op loops."""
    from fgdp_tpu_torch.ops import smem_sweep as sw

    g, index = seed_ctx
    t = seed_tables(index, dev)
    codes, lens, active = (torch.as_tensor(a, device=dev)
                           for a in seed_reads(g, 256, 151, seed=4))
    B = codes.shape[0]
    rid = torch.arange(B, dtype=torch.int32, device=dev)
    ones = torch.ones(B, dtype=torch.int32, device=dev)
    fa = (t[0], codes, lens, rid, torch.zeros_like(rid), ones, active, 3,
          12, t[1].codes16)
    got, want = sw.fwd_sweep(*fa), sw.fwd_sweep_plain(*fa)
    _sweep_equal(got, want, "D9")
    assert bool(got["povf"].any()) and bool(got["eovf"].any())
    lanes, drop = sw.flatten_entries(got, rid, ones, 12, 2 * B)
    assert bool(drop.any())
    _sweep_equal(sw.bwd_entries(t[0], codes, lens, lanes, t[1].codes16),
                 sw.bwd_entries_plain(t[0], codes, lens, lanes,
                                      t[1].codes16), "D10")


@pytest.mark.cuda
def test_sweep_kernels_time_each_launch_when_asked(dev, seed_ctx):
    from fgdp_tpu_torch.ops import smem_sweep as sw

    g, index = seed_ctx
    t = seed_tables(index, dev)
    codes, lens, active = (torch.as_tensor(a, device=dev)
                           for a in seed_reads(g, 64, 151, seed=3))
    rid = torch.arange(64, dtype=torch.int32, device=dev)
    ones = torch.ones(64, dtype=torch.int32, device=dev)
    fa = (t[0], codes, lens, rid, torch.zeros_like(rid), ones, active, 20,
          192, t[1].codes16)
    for name in ("sweep_fwd", "sweep_bwd"):
        kernels.TIMED[name] = []
    try:
        fw = sw.fwd_sweep(*fa)
        lanes, _ = sw.flatten_entries(fw, rid, ones, 192, 64 * 44)
        sw.bwd_entries(t[0], codes, lens, lanes, t[1].codes16)
        pairs = {n: kernels.TIMED[n] for n in ("sweep_fwd", "sweep_bwd")}
    finally:
        for name in ("sweep_fwd", "sweep_bwd"):
            kernels.TIMED.pop(name, None)
    torch.cuda.synchronize()
    for name, p in pairs.items():
        assert len(p) == 1 and p[0][0].elapsed_time(p[0][1]) > 0, name
    # the work counters: table bytes, the most dependent gathers of a
    # lane, lane steps, the longest lane's steps
    wf = torch.zeros(4, dtype=torch.int64, device=dev)
    wb = torch.zeros(4, dtype=torch.int64, device=dev)
    sw.fwd_sweep_kernel(*fa, work=wf)
    sw.bwd_entries_kernel(t[0], codes, lens, lanes, t[1].codes16, work=wb)
    for w in (wf.tolist(), wb.tolist()):
        gathered, chain, steps, longest = w
        assert steps >= longest > 0 and gathered > 0 and chain > 0


@pytest.mark.cuda
def test_sweep_kernels_make_no_host_sync_between_launches(dev, seed_ctx):
    """D9, the entries' flatten and D10 on the card run with CUDA's sync
    debug mode set to error: no .item(), bool() or int() on a card tensor
    between the two launches."""
    from fgdp_tpu_torch.ops import smem_sweep as sw

    g, index = seed_ctx
    t = seed_tables(index, dev)
    codes, lens, active = (torch.as_tensor(a, device=dev)
                           for a in seed_reads(g, 128, 151, seed=5))
    rid = torch.arange(128, dtype=torch.int32, device=dev)
    ones = torch.ones(128, dtype=torch.int32, device=dev)
    x0 = torch.zeros_like(rid)
    sw.fwd_sweep(t[0], codes, lens, rid, x0, ones, active, 20, 192,
                 t[1].codes16)            # builds and loads the kernels
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        fw = sw.fwd_sweep(t[0], codes, lens, rid, x0, ones, active, 20, 192,
                          t[1].codes16)
        lanes, _ = sw.flatten_entries(fw, rid, ones, 192, 128 * 44)
        m, kf, sf = sw.bwd_entries(t[0], codes, lens, lanes, t[1].codes16)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert int(fw["ecount"].sum()) > 0 and bool((kf < -1).any())


# D9 stages its lanes' codes in shared memory while eight groups' rows
# fit in 48 KB (csrc/sweep_fwd.cuh), L up to 12,288, and reads longer
# rows where they lie
SWEEP_STAGED_MAX_L = 12_288


def sweep_cut_off_batch(g, L):
    """seed_reads' 256 reads in code rows of length L, the first two
    replaced by a copy of L - 10 genome bases (every 97th changed) and one
    of 3,000 bases with an N run."""
    codes, lens, active = seed_reads(g, 256, 151, seed=L)
    rows = np.full((256, L), 4, np.int32)
    rows[:, :151] = codes
    for i, n in enumerate((L - 10, 3000)):
        s = g[1000:1000 + n].astype(np.int32).copy()
        s[::97] = (s[::97] + 1) % 4
        if i:
            s[1500:1530] = 4
        rows[i] = 4
        rows[i, :n] = s
        lens[i], active[i] = n, True
    return rows, lens, active


@pytest.mark.cuda
@pytest.mark.parametrize("L", [SWEEP_STAGED_MAX_L, SWEEP_STAGED_MAX_L + 1])
def test_sweep_fwd_kernel_both_sides_of_the_staging_cut_off(dev, seed_ctx,
                                                            L):
    """D9 staged (L 12,288) and reading its codes where they lie (L
    12,289), with a read of nearly L bases: the sweep's K1 and K2 stages
    and D9 at tight caps (povf and eovf fire) exactly equal to the
    torch-op loops."""
    from fgdp_tpu_torch.ops import smem_sweep as sw

    g, index = seed_ctx
    t = seed_tables(index, dev)
    assert kernels.load("sweep_fwd").fgdp_sweep_fwd_staged(L) == \
        int(L <= SWEEP_STAGED_MAX_L)
    codes, lens, active = (torch.as_tensor(a, device=dev)
                           for a in sweep_cut_off_batch(g, L))
    got = sweep_phases(dev, t, codes, lens, active, 1, plain=False)
    want = sweep_phases(dev, t, codes, lens, active, 1, plain=True)
    for (what, a), (_, b) in zip(got, want):
        _sweep_equal(a, b, what)
    B = codes.shape[0]
    rid = torch.arange(B, dtype=torch.int32, device=dev)
    ones = torch.ones(B, dtype=torch.int32, device=dev)
    fa = (t[0], codes, lens, rid, torch.zeros_like(rid), ones, active, 3,
          12, t[1].codes16)
    tight = sw.fwd_sweep(*fa)
    _sweep_equal(tight, sw.fwd_sweep_plain(*fa), "D9 tight")
    assert bool(tight["povf"].any()) and bool(tight["eovf"].any())
    assert int(got[0][1]["ecount"][0]) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("L", [151, SWEEP_STAGED_MAX_L + 1])
def test_sweep_fwd_kernel_ends_the_never_ending_lane(dev, seed_ctx, L):
    """K2 lanes with min_intv 1 and walk off from every read's start: a
    lane that narrows to one suffix takes neither branch, which the
    torch-op loop would step forever; on the card it ends with eovf set,
    and every lane equals D9's host twin (staged at L 151, in place past
    the cut-off)."""
    from fgdp_tpu_torch.ops import fm as fmops
    from fgdp_tpu_torch.ops import smem_sweep as sw

    g, index = seed_ctx
    t = seed_tables(index, dev)
    codes, lens, _ = seed_reads(g, 64, 151, seed=8)
    rows = np.full((64, L), 4, np.int32)
    rows[:, :151] = codes
    B = 64
    args = [rows, lens, np.arange(B, dtype=np.int32), np.zeros(B, np.int32),
            np.ones(B, np.int32), np.ones(B, bool)]
    got = sw.fwd_sweep(t[0], *(torch.as_tensor(a, device=dev) for a in args),
                       20, 22, t[1].codes16, restart=False, walk=False)
    cpu = seed_tables(index, "cpu")
    _keep, fm_args = fmops.kernel_args(cpu[0], torch.device("cpu"), "twin")
    c16 = cpu[1].codes16.contiguous()
    ins = [torch.as_tensor(a).contiguous() for a in args]
    want = dict(em=torch.zeros((B, 22), dtype=torch.int32),
                en=torch.zeros((B, 22), dtype=torch.int32),
                ek=torch.zeros((B, 22), dtype=torch.int32),
                es=torch.zeros((B, 22), dtype=torch.int32),
                ecount=torch.zeros(B, dtype=torch.int32),
                povf=torch.zeros(B, dtype=torch.bool),
                eovf=torch.zeros(B, dtype=torch.bool))
    assert kernels.build_host_twin().fgdp_sweep_fwd_host(
        *fm_args, *(a.data_ptr() for a in ins), c16.data_ptr(),
        c16.shape[0], B, L, B, 22, 20, 2 * cpu[0].n_ref, 0, 0,
        *(want[f].data_ptr() for f in want), None, -1, None) == 0
    for f in want:
        assert torch.equal(got[f].cpu(), want[f]), f
    assert bool(got["eovf"].any())
