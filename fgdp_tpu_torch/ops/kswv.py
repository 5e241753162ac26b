"""Batched local Smith-Waterman (kswv / ksw_align2 analogue) for mate
rescue: kernel wrapper, plain version and the batch driver.

The reference rescues mates with horizontal-SIMD local SW over job
batches (src/kswv.cpp:126, dispatched from mem_matesw
src/bwamem_pair.cpp:150-285). The JAX package runs the forward pass as a
jitted lax.fori_loop over the target rows (fgdp_tpu/ops/kswv.py
_forward, D6). On the card the hand-written kernel csrc/kswv.cu runs it,
one warp per job with the job's DP row in registers (the lanes an
anti-diagonal wavefront over the target rows), or in global scratch for
queries wider than 256 columns or scores outside a signed byte. `kswv_forward_plain` beside
it is the same function as a row loop of torch ops, transcribed from
_forward: the CPU path and the tests run it, and the card's smoke run
holds the kernel against it.

`kswv_forward` takes the kernel for CUDA tensors and the plain version
for CPU tensors, and nothing else: a failing launch raises.

Exactness of the single-pass in-row F recurrence: the true lazy-F
fixpoint lets a gap-in-target open from an F-derived H cell, but with
o_ins >= 0 re-opening from an F cell is never better than extending the
original gap (oe >= e), so
    F[j] = max_{k<j} (max(M[k], E[k], 0) - oe_ins - (j-1-k) e_ins)
is exact and is one cummax. align/pair.ksw_align_local (the scalar
transcription, 30-iteration fixpoint) stays as the test oracle.

Semantics mirrored bit-for-bit (tests/test_torch_kswv.py):
  * best = max H; te = FIRST target row achieving it (strict improve)
  * qe   = first argmax of the H row at te
  * score2 = max row-max outside te +- ceil(best/a)  (ksw.cpp:331-345)
  * qb/tb from a second (reversed-prefix) batched pass
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..config import AlignConfig
from . import kernels

NEG = -(1 << 30)
_I32 = torch.int32

# the kernel's two paths, as its C entry point reports the one it took
# (chosen from QP and the scores, before the launch): the DP row in
# registers, or in global scratch for queries wider than the kernel
# library's fgdp_kswv_reg_max_qp() or a match score or mismatch penalty
# outside a signed byte (fgdp_kswv_wide); launches of each
KERNEL_PATHS = ("registers", "wide")
PATH_LAUNCHES = {p: 0 for p in KERNEL_PATHS}
# rescue work handed to kswv_forward by ksw_align_local_batch: jobs (not
# counting the bucket's padding) and DP cells (qlen x tlen summed)
WORK = {"jobs": 0, "cells": 0}


def kswv_forward(q, qlen, t, tlen, *, a, b, o_del, e_del, o_ins, e_ins):
    """Local-SW forward pass over a job batch on the inputs' device.

    q int32[J, QP], t int32[J, TP] (codes 0..4; anything vs 4 scores
    -1 per bwa_fill_scmat), qlen/tlen int32[J].
    Returns (best[J], te[J], best_row[J, QP], row_max[J, TP])."""
    kw = dict(a=a, b=b, o_del=o_del, e_del=e_del, o_ins=o_ins, e_ins=e_ins)
    if q.is_cuda:
        return kswv_forward_kernel(q, qlen, t, tlen, **kw)
    return kswv_forward_plain(q, qlen, t, tlen, **kw)


def kswv_forward_kernel(q, qlen, t, tlen, *, a, b, o_del, e_del, o_ins,
                        e_ins):
    """Launch csrc/kswv.cu on CUDA tensors; returns what
    `kswv_forward_plain` returns."""
    J, QP = q.shape
    TP = t.shape[1]
    dev = q.device
    args = dict(q=q, qlen=qlen, t=t, tlen=tlen)
    conv = {}
    for name, x in args.items():
        if not x.is_cuda or x.device != dev:
            raise ValueError(f"kswv kernel: {name} is not on {dev}")
        if x.shape[0] != J:
            raise ValueError(f"kswv kernel: {name} has {x.shape[0]} rows, "
                             f"expected {J}")
        conv[name] = x.to(_I32).contiguous()
    if t.dim() != 2 or qlen.dim() != 1 or tlen.dim() != 1:
        raise ValueError("kswv kernel: t must be [J, TP], qlen/tlen 1-D")
    best = torch.empty(J, dtype=_I32, device=dev)
    te = torch.empty(J, dtype=_I32, device=dev)
    best_row = torch.empty((J, QP), dtype=_I32, device=dev)
    row_max = torch.empty((J, TP), dtype=_I32, device=dev)
    lib = kernels.load("kswv")
    # the wide path keeps each job's H and E rows in global scratch
    scratch = torch.empty((J, 2, QP), dtype=_I32, device=dev) \
        if lib.fgdp_kswv_wide(QP, int(a), int(b)) else None
    path = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        ev = kernels.event_pair("kswv", stream)
        rc = lib.fgdp_kswv(
            conv["q"].data_ptr(), conv["t"].data_ptr(),
            conv["qlen"].data_ptr(), conv["tlen"].data_ptr(), J, QP, TP,
            int(a), int(b), int(o_del), int(e_del), int(o_ins), int(e_ins),
            best.data_ptr(), te.data_ptr(), best_row.data_ptr(),
            row_max.data_ptr(),
            scratch.data_ptr() if scratch is not None else None,
            ctypes.addressof(path),
            *kernels.event_ptrs(ev),
            stream.cuda_stream)
    kernels.check(rc, "kswv")
    kernels.tally(kernels.LAUNCHES, "kswv")
    kernels.tally(PATH_LAUNCHES, KERNEL_PATHS[path.value])
    return best, te, best_row, row_max


def kswv_forward_plain(q, qlen, t, tlen, *, a, b, o_del, e_del, o_ins,
                       e_ins):
    """The plain version: one step of torch ops per target row over all
    jobs (the JAX package's _forward, transcribed)."""
    J, QP = q.shape
    TP = t.shape[1]
    dev = q.device
    oe_del = o_del + e_del
    oe_ins = o_ins + e_ins
    jq = torch.arange(QP, dtype=_I32, device=dev)[None, :]
    qlen = qlen.to(_I32)
    tlen = tlen.to(_I32)
    qmask = jq < qlen[:, None]
    qc = q.to(_I32).clamp(0, 4)
    s_ab = torch.tensor([a, -b, -1, NEG], dtype=_I32, device=dev)
    negcol = torch.full((J, 1), NEG, dtype=_I32, device=dev)
    zcol = torch.zeros((J, 1), dtype=_I32, device=dev)

    H = torch.zeros((J, QP + 1), dtype=_I32, device=dev)
    E = torch.zeros((J, QP), dtype=_I32, device=dev)
    best = torch.zeros(J, dtype=_I32, device=dev)
    te = torch.full((J,), -1, dtype=_I32, device=dev)
    best_row = torch.zeros((J, QP), dtype=_I32, device=dev)
    row_max = torch.zeros((J, TP), dtype=_I32, device=dev)
    for i in range(TP):
        tc = t[:, i].to(_I32).clamp(0, 4)[:, None]            # [J, 1]
        s = torch.where((qc >= 4) | (tc >= 4), s_ab[2],
                        torch.where(qc == tc, s_ab[0], s_ab[1]))
        s = torch.where(qmask, s, s_ab[3])
        M = H[:, :QP] + s                   # H prev row, boundary col 0
        G = torch.maximum(M, E).clamp(min=0)
        v = (G - oe_ins) + jq * e_ins
        cm = torch.cummax(v, dim=1).values
        F = torch.cat([negcol, cm[:, :-1]], dim=1) - (jq - 1) * e_ins
        h2 = torch.maximum(torch.maximum(M, E), F.clamp(min=0))
        h2 = torch.where(qmask, h2, 0)
        E2 = torch.maximum(E - e_del, h2 - oe_del).clamp(min=0)
        H = torch.cat([zcol, h2], dim=1)
        rm = h2.amax(dim=1) if QP else torch.zeros_like(best)
        act = i < tlen
        rm = torch.where(act, rm, 0)
        row_max[:, i] = rm
        imp = act & (rm > best)
        best = torch.where(imp, rm, best)
        te = torch.where(imp, i, te)
        best_row = torch.where(imp[:, None], h2, best_row)
        E = torch.where(act[:, None], E2, E)
    return best, te, best_row, row_max


def _bucket(n: int, quantum: int) -> int:
    return max(-(-n // quantum) * quantum, quantum)


def _pack(jobs):
    """Jobs -> padded numpy q[JP, QP], t[JP, TP], qlen, tlen. The job
    dimension is bucketed too (padded lanes have qlen = tlen = 0 and do
    no work), so the launches' shapes repeat as the JAX package's jit
    cache needed them to."""
    JP = _bucket(len(jobs), 64)
    QP = _bucket(max(len(q) for q, _ in jobs), 32)
    TP = _bucket(max(len(t) for _, t in jobs), 128)
    q = np.full((JP, QP), 4, np.int32)
    t = np.full((JP, TP), 4, np.int32)
    qlen = np.zeros(JP, np.int32)
    tlen = np.zeros(JP, np.int32)
    for i, (qi, ti) in enumerate(jobs):
        q[i, :len(qi)] = qi
        t[i, :len(ti)] = ti
        qlen[i] = len(qi)
        tlen[i] = len(ti)
    return q, t, qlen, tlen


def _forward_np(jobs, kw, device):
    """kswv_forward on `device` over packed jobs; numpy results."""
    q, t, qlen, tlen = _pack(jobs)
    WORK["jobs"] += len(jobs)
    WORK["cells"] += int(np.dot(qlen.astype(np.int64), tlen))
    out = kswv_forward(*(torch.as_tensor(x, device=device)
                         for x in (q, qlen, t, tlen)), **kw)
    return [x.cpu().numpy() for x in out] + [tlen]


def ksw_align_local_batch(jobs, opt: AlignConfig, device):
    """Batched ksw_align2 on `device`: jobs = [(query_codes,
    target_codes)], returns a list of dicts {score, qb, qe, tb, te,
    score2} or None (best < min_seed_len * a), each identical to
    align/pair.ksw_align_local."""
    if not jobs:
        return []
    min_sc = opt.min_seed_len * opt.a
    J = len(jobs)
    kw = dict(a=opt.a, b=opt.b, o_del=opt.o_del, e_del=opt.e_del,
              o_ins=opt.o_ins, e_ins=opt.e_ins)
    best, te, best_row, row_max, tlen = _forward_np(jobs, kw, device)

    # second pass: start positions via reversed prefixes of the hits
    hit = [i for i in range(J) if best[i] >= min_sc and te[i] >= 0]
    qe = np.zeros(J, np.int64)
    score2 = np.zeros(J, np.int64)
    rev_jobs = []
    for i in hit:
        qe[i] = int(np.argmax(best_row[i]))     # first index at max
        w = (int(best[i]) + opt.a - 1) // opt.a
        lo, hi = int(te[i]) - w, int(te[i]) + w
        tr = np.arange(int(tlen[i]))
        m = (tr < lo) | (tr > hi)
        score2[i] = int(row_max[i, :int(tlen[i])][m].max()) if m.any() \
            else 0
        rev_jobs.append((jobs[i][0][:qe[i] + 1][::-1],
                         jobs[i][1][:int(te[i]) + 1][::-1]))
    out = [None] * J
    if hit:
        b2, te2, br2, _, _ = _forward_np(rev_jobs, kw, device)
        for k, i in enumerate(hit):
            if b2[k] == best[i] and te2[k] >= 0:
                tb = int(te[i]) - int(te2[k])
                qb = int(qe[i]) - int(np.argmax(br2[k]))
            else:
                tb, qb = 0, 0
            out[i] = dict(score=int(best[i]), qb=qb, qe=int(qe[i]),
                          tb=tb, te=int(te[i]), score2=int(score2[i]))
    return out
