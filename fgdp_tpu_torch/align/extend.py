"""Batched seed-extension driver (mem_chain2aln_across_reads_V2 parity).

Port of the JAX package's align/extend.py. The reference gathers
left/right extension SeqPairs across a read batch and runs banded SW
with band-doubling retries (src/bwamem.cpp:2531-3283). Here the same
gathering builds fixed-shape job tensors, and the whole batch runs
through banded SW twice per side (band w and 2w), selecting per the
reference's retry rule (accept when max_off < (w>>1)+(w>>2),
src/bwamem.cpp:2950). On the card each of the four calls is one launch
of the hand-written SW kernel (ops/sw.py). Every seed of every surviving
chain becomes one alignment region; redundancy is removed afterwards by
mem_sort_dedup_patch (host side, align/finalize.py).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..config import AlignConfig
from ..index.reference import DeviceReference
from ..ops import sw as swops
from ..ops.smem import any_by
from ..ops.smem_sweep import pack_reads, read_window
from .chain import ChainBatch

_I32 = torch.int32
_BIG = 2**31 - 1


class AlnRegBatch(NamedTuple):
    """mem_alnreg_t fields, fixed shape [B, E]."""

    rid: torch.Tensor
    qb: torch.Tensor
    qe: torch.Tensor
    rb: torch.Tensor
    re: torch.Tensor
    score: torch.Tensor
    truesc: torch.Tensor
    sw_w: torch.Tensor      # a->w after band retries
    seedcov: torch.Tensor
    seedlen0: torch.Tensor
    frac_rep: torch.Tensor  # float32[B] (per read)
    valid: torch.Tensor     # bool[B, E]
    overflow: torch.Tensor  # bool[B] any-stage overflow
    ovf_seed: torch.Tensor  # bool[B] seed-stage overflow (see ChainBatch)


def _cal_max_gap(opt: AlignConfig, qlen):
    """cal_max_gap (src/bwamem.cpp:65-76) in float32, as the JAX package
    computes it; qlen int32[...]"""
    qf = qlen.to(torch.float32)
    l_del = torch.trunc((qf * opt.a - opt.o_del) / opt.e_del + 1.0)
    l_ins = torch.trunc((qf * opt.a - opt.o_ins) / opt.e_ins + 1.0)
    l = torch.maximum(torch.maximum(l_del, l_ins),
                      torch.ones_like(l_del))
    return torch.clamp(l, max=float(opt.w * 2)).to(_I32)


def extend_chains(cb: ChainBatch, codes, lens, dref: DeviceReference,
                  opt: AlignConfig, max_regs: int, t_max: int,
                  jobs_per_read: int = 6) -> AlnRegBatch:
    """codes int32[B, L] read codes; lens int32[B]. Returns regs [B, E].

    SW work is globally compacted: valid (read, seed) extension jobs
    across the whole batch are gathered into J = B * jobs_per_read
    lanes. Jobs beyond J are dropped with the read's overflow flag set.
    """
    B, P = cb.seed_qbeg.shape
    C = cb.pos.shape[1]
    E = max_regs
    L = codes.shape[1]
    J = B * jobs_per_read
    dev = codes.device
    l_pac = dref.l_pac
    lens = lens.to(_I32)

    # ---- flat job list from the chain batch's [NJ] seed lanes ----
    fread = cb.fread
    fr_c = fread.clamp(0, B - 1).long()
    fchain = torch.where(cb.fon, cb.seed_chain[fr_c, cb.fslot.long()], -1)
    fkept = cb.kept.reshape(-1)[
        (fr_c * C + fchain.clamp(0, C - 1)).clamp(0, B * C - 1)]
    job = cb.fon & (fchain >= 0) & (fkept > 0)

    # ---- per-chain ref window rmax (bwamem.cpp:2608-2630) ----
    flens = lens[fr_c]
    gap_l = _cal_max_gap(opt, cb.fqbeg)
    rem = flens - cb.fqbeg - cb.fslen
    gap_r = _cal_max_gap(opt, rem)
    b_t = cb.frbeg - (cb.fqbeg + gap_l)
    e_t = cb.frbeg + cb.fslen + rem + gap_r
    cidx = torch.where(job, fr_c * C + fchain, B * C).long()
    rmax0 = torch.full((B * C + 1,), 2 * l_pac, dtype=_I32,
                       device=dev).scatter_reduce(
        0, cidx, torch.where(job, b_t, _BIG).to(_I32), reduce="amin")
    rmax1 = torch.zeros(B * C + 1, dtype=_I32, device=dev).scatter_reduce(
        0, cidx, torch.where(job, e_t, -_BIG).to(_I32), reduce="amax")
    rmax0 = rmax0[:B * C].reshape(B, C).clamp(min=0)
    rmax1 = rmax1[:B * C].reshape(B, C).clamp(max=2 * l_pac)
    straddle = (rmax0 < l_pac) & (l_pac < rmax1)
    fwd_first = cb.first_r < l_pac
    rmax1 = torch.where(straddle & fwd_first, l_pac, rmax1)
    rmax0 = torch.where(straddle & ~fwd_first, l_pac, rmax0)
    far_beg, far_end, _ = dref.contig_window(cb.first_r)
    rmax0 = torch.maximum(rmax0, far_beg)
    rmax1 = torch.minimum(rmax1, far_end)

    # ---- reg slot within the read (order = flat order) ----
    cj = torch.cumsum(job.to(_I32), 0, dtype=_I32)
    start_idx = torch.searchsorted(
        fread.contiguous(), torch.arange(B, dtype=_I32, device=dev),
        right=False)
    base_r = torch.where(start_idx > 0,
                         cj[(start_idx - 1).clamp(0, cj.shape[0] - 1)], 0)
    eslot = cj - 1 - base_r[fr_c]
    keepE = job & (eslot < E)
    over_mask = job & (eslot >= E)
    overflow = any_by(fread, over_mask, B)

    # ---- global compaction to J SW lanes ----
    g2 = torch.cumsum(keepE.to(_I32), 0, dtype=_I32) - 1
    glive_m = keepE & (g2 < J)
    dropJ = keepE & (g2 >= J)
    overflow = overflow | any_by(fread, dropJ, B)
    gsl = torch.where(glive_m, g2, J).long()
    lane_tbl = torch.stack(
        [cb.fqbeg, cb.frbeg, cb.fslen, fread, eslot, fchain], dim=1).to(_I32)
    lanes = torch.zeros((J + 1, 6), dtype=_I32, device=dev)
    lanes[gsl] = lane_tbl
    lanes = lanes[:J]
    glive = torch.zeros(J + 1, dtype=torch.bool, device=dev)
    glive[gsl] = glive_m
    glive = glive[:J]
    gqb, grb, glen, gread, geslot, gchain = lanes.unbind(1)
    ctbl = torch.stack([rmax0, rmax1, cb.rid], dim=-1).reshape(B * C, 3)
    crow = ctbl[(gread.long() * C + gchain).clamp(0, B * C - 1)]
    gr0, gr1, grid = crow.unbind(1)
    glens = lens[gread.long()]

    TP = t_max
    pl = swops.SWParams(opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                        opt.zdrop, opt.pen_clip5, opt.a, opt.b)
    pr = swops.SWParams(opt.o_del, opt.e_del, opt.o_ins, opt.e_ins,
                        opt.zdrop, opt.pen_clip3, opt.a, opt.b)

    def run_retry(q, qn, t, tn, h0v, prev, params):
        """Band-doubling: w then 2w; accept try1 iff the score repeats the
        caller's previous score or max_off is small
        (MAX_BAND_TRY=2, bwamem.cpp:49,2927-2950)."""
        r1 = swops.sw_extend(q, qn, t, tn, h0v, opt.w, params, t_max=TP)
        take1 = (r1.score == prev) | \
            (r1.max_off < ((opt.w >> 1) + (opt.w >> 2)))
        # rerun only lanes that need the doubled band
        r2 = swops.sw_extend(q, torch.where(take1, 0, qn), t,
                             torch.where(take1, 0, tn), h0v, opt.w * 2,
                             params, t_max=TP)
        res = swops.SWResult(*(torch.where(take1, x1, x2)
                               for x1, x2 in zip(r1, r2)))
        w_used = torch.where(take1, opt.w, opt.w * 2).to(_I32)
        return res, w_used

    def sorted_lanes(qn):
        """Lanes in ascending extension-length order (the SW kernel takes
        them from the last, the longest first) and the inverse
        permutation."""
        perm = torch.sort(qn, stable=True).indices
        inv = torch.empty_like(perm)
        inv[perm] = torch.arange(J, device=dev)
        return perm, inv

    # ---- left extension: reversed prefixes ----
    h0 = glen * opt.a
    do_left = glive & (gqb > 0)
    qn_l = torch.where(do_left, gqb, 0).to(_I32)
    perm_l, inv_l = sorted_lanes(qn_l)
    gqb_s, grb_s = gqb[perm_l], grb[perm_l]
    rpacked = pack_reads(codes)
    q_left = read_window(rpacked, gread[perm_l], gqb_s - L,
                         glens[perm_l], L).flip(1)
    # every qn below is at most the read's length, at most L, the query
    # windows' width: the SW kernel's bound on qlen holds by shape (a
    # capture does not read it back, ops/sw.sw_extend_kernel)
    assert q_left.shape[1] == L
    t_left = dref.fetch_window(grb_s - TP, TP, reverse=True)
    rl_s, wl_s = run_retry(
        q_left, qn_l[perm_l], t_left,
        torch.where(do_left, grb - gr0, 0).to(_I32)[perm_l], h0[perm_l],
        torch.full((J,), -1, dtype=_I32, device=dev), pl)
    rl = swops.SWResult(*(x[inv_l] for x in rl_s))
    wl = wl_s[inv_l]

    # apply left results (bwamem.cpp:2952-2961)
    gs_ok = (rl.gscore <= 0) | (rl.gscore <= rl.score - opt.pen_clip5)
    g_qb = torch.where(do_left, torch.where(gs_ok, gqb - rl.qle, 0), 0)
    g_rb = torch.where(do_left,
                       torch.where(gs_ok, grb - rl.tle, grb - rl.gtle), grb)
    # a->score after left = sp->score (not gscore); truesc differs
    score_mid = torch.where(do_left, rl.score, glen * opt.a)
    g_truesc = torch.where(do_left & ~gs_ok, rl.gscore, score_mid)
    g_w = torch.where(do_left, torch.clamp(wl, min=opt.w), opt.w)

    # ---- right extension: suffixes (same sorted-lane scheme) ----
    gqe = gqb + glen
    re0 = grb + glen
    do_right = glive & (gqe < glens)
    qn_r = torch.where(do_right, glens - gqe, 0).to(_I32)
    perm_r, inv_r = sorted_lanes(qn_r)
    q_right = read_window(rpacked, gread[perm_r], gqe[perm_r],
                          glens[perm_r], L)
    t_right = dref.fetch_window(re0[perm_r], TP)
    rr_s, wr_s = run_retry(
        q_right, qn_r[perm_r], t_right,
        torch.where(do_right, gr1 - re0, 0).to(_I32)[perm_r],
        score_mid[perm_r], score_mid[perm_r], pr)
    rr = swops.SWResult(*(x[inv_r] for x in rr_s))
    wr = wr_s[inv_r]

    gs_ok_r = (rr.gscore <= 0) | (rr.gscore <= rr.score - opt.pen_clip3)
    g_qe = torch.where(do_right,
                       torch.where(gs_ok_r, gqe + rr.qle, glens), glens)
    g_re = torch.where(do_right,
                       torch.where(gs_ok_r, re0 + rr.tle, re0 + rr.gtle),
                       re0)
    g_score = torch.where(do_right, rr.score, score_mid)
    g_truesc = torch.where(
        do_right,
        g_truesc + torch.where(gs_ok_r, rr.score, rr.gscore) - score_mid,
        g_truesc)
    g_w = torch.where(do_right, torch.maximum(g_w, wr), g_w)

    # scatter back to the [B, E] reg layout: one fused J-row scatter
    greg = torch.where(glive, gread.long() * E + geslot, B * E).long()
    payload = torch.stack([g_qb, g_rb, g_qe, g_re, g_score, g_truesc,
                           g_w, grid, glen, gchain,
                           glive.to(_I32)], dim=1).to(_I32)
    # the columns' fills of slots no job writes, set on the device (fill_
    # takes the value as a kernel argument; an item assignment would copy
    # it from the host)
    out = torch.zeros((B * E + 1, 11), dtype=_I32, device=dev)
    out[:, 4:6].fill_(-1)
    out[:, 6].fill_(opt.w)
    out[:, 7].fill_(-1)
    out[:, 9].fill_(-1)
    out[greg] = payload
    out = out[:B * E].reshape(B, E, 11)
    qb, rb, qe, re = (out[..., i] for i in range(4))
    score, truesc, sw_w, jrid, jlen, jchain = (
        out[..., i] for i in range(4, 10))
    jvalid = out[..., 10] != 0

    # ---- seedcov (bwamem.cpp:2962-2972): chain seeds inside the region ----
    sc_q = cb.seed_qbeg[:, None, :]
    sc_r = cb.seed_rbeg[:, None, :]
    sc_l = cb.seed_len[:, None, :]
    same_chain = (cb.seed_chain[:, None, :] == jchain[:, :, None]) & \
        (cb.seed_chain[:, None, :] >= 0)
    inside = same_chain & (sc_q >= qb[:, :, None]) & \
        (sc_q + sc_l <= qe[:, :, None]) & (sc_r >= rb[:, :, None]) & \
        (sc_r + sc_l <= re[:, :, None])
    seedcov = torch.where(inside, sc_l, 0).sum(dim=2, dtype=_I32)

    return AlnRegBatch(
        rid=torch.where(jvalid, jrid, -1), qb=qb, qe=qe, rb=rb, re=re,
        score=torch.where(jvalid, score, -1),
        truesc=torch.where(jvalid, truesc, -1),
        sw_w=sw_w, seedcov=seedcov, seedlen0=jlen,
        frac_rep=cb.frac_rep, valid=jvalid,
        overflow=overflow | cb.overflow,
        ovf_seed=cb.ovf_seed,
    )
