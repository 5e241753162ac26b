"""Paired-end resolution: insert-size stats, mate rescue, pair scoring.

Transcribes src/bwamem_pair.cpp:
  * mem_infer_dir / cal_sub / mem_pestat      (:59-148)
  * mem_matesw (kswv mate-rescue local SW)    (:150-285)
  * mem_pair (orientation walk + erfc prior)  (:286-347)
  * mem_sam_pe (pair MAPQ, flags, SAM)        (:354-552)
plus ksw_align2 local-SW semantics (src/ksw.cpp:113-385) in vectorized
NumPy (rows over target, cummax scan for the in-row gap recurrence).

Mate rescue runs batched on a device (rescue_all -> ops/kswv, the CUDA
kernel csrc/kswv.cu on the card); the scalar ksw_align_local and the
per-pair matesw/sam_pe loop stay as the test oracle.

Port of the JAX package's align/pair.py.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from ..config import AlignConfig
from ..ops.kswv import ksw_align_local_batch
from . import finalize

MIN_RATIO = 0.8
MIN_DIR_CNT = 10
MIN_DIR_RATIO = 0.05
OUTLIER_BOUND = 2.0
MAPPING_BOUND = 3.0
MAX_STDDEV = 4.0
M_SQRT1_2 = 1.0 / math.sqrt(2.0)


def infer_dir(l_pac, b1, b2):
    """mem_infer_dir: orientation in {0:FF,1:FR,2:RF,3:RR} + distance."""
    r1, r2 = b1 >= l_pac, b2 >= l_pac
    p2 = b2 if r1 == r2 else 2 * l_pac - 1 - b2
    dist = p2 - b1 if p2 > b1 else b1 - p2
    return (0 if r1 == r2 else 1) ^ (0 if p2 > b1 else 3), dist


def cal_sub(opt: AlignConfig, regs):
    for j in range(1, len(regs)):
        b_max = max(regs[j]["qb"], regs[0]["qb"])
        e_min = min(regs[j]["qe"], regs[0]["qe"])
        if e_min > b_max:
            min_l = min(regs[j]["qe"] - regs[j]["qb"],
                        regs[0]["qe"] - regs[0]["qb"])
            if e_min - b_max >= min_l * opt.mask_level:
                return regs[j]["score"]
    return opt.min_seed_len * opt.a


@dataclasses.dataclass
class PEStat:
    failed: bool = True
    low: int = 0
    high: int = 0
    avg: float = 0.0
    std: float = 0.0


def pestat(opt: AlignConfig, l_pac, reg_pairs):
    """mem_pestat over [(regs1, regs2)] (score-sorted reg lists)."""
    isize = [[] for _ in range(4)]
    for r0, r1 in reg_pairs:
        if not r0 or not r1:
            continue
        if cal_sub(opt, r0) > MIN_RATIO * r0[0]["score"]:
            continue
        if cal_sub(opt, r1) > MIN_RATIO * r1[0]["score"]:
            continue
        if r0[0]["rid"] != r1[0]["rid"]:
            continue
        d, dist = infer_dir(l_pac, r0[0]["rb"], r1[0]["rb"])
        if dist and dist <= opt.max_ins:
            isize[d].append(dist)
    pes = [PEStat() for _ in range(4)]
    for d in range(4):
        q = sorted(isize[d])
        r = pes[d]
        if len(q) < MIN_DIR_CNT:
            continue
        r.failed = False
        p25 = q[int(0.25 * len(q) + 0.499)]
        p50 = q[int(0.50 * len(q) + 0.499)]
        p75 = q[int(0.75 * len(q) + 0.499)]
        r.low = max(int(p25 - OUTLIER_BOUND * (p75 - p25) + 0.499), 1)
        r.high = int(p75 + OUTLIER_BOUND * (p75 - p25) + 0.499)
        sel = [x for x in q if r.low <= x <= r.high]
        r.avg = sum(sel) / len(sel)
        r.std = math.sqrt(sum((x - r.avg) ** 2 for x in sel) / len(sel))
        # degenerate distributions (identical inserts) divide by zero in
        # the reference's erfc prior (bwamem_pair.cpp:322 is UB there)
        r.std = max(r.std, 1e-9)
        r.low = int(p25 - MAPPING_BOUND * (p75 - p25) + 0.499)
        r.high = int(p75 + MAPPING_BOUND * (p75 - p25) + 0.499)
        r.low = min(r.low, int(r.avg - MAX_STDDEV * r.std + 0.499))
        r.high = max(r.high, int(r.avg + MAX_STDDEV * r.std + 0.499))
        r.low = max(r.low, 1)
    mx = max(len(x) for x in isize)
    for d in range(4):
        if not pes[d].failed and len(isize[d]) < mx * MIN_DIR_RATIO:
            pes[d].failed = True
    return pes


def ksw_align_local(query, target, opt: AlignConfig, min_sc: int):
    """ksw_align2 semantics (local SW; score/qe/te/qb/tb/score2).
    Returns dict or None when best score < min_sc."""
    q = np.asarray(query, np.int64)
    t = np.asarray(target, np.int64)
    mat = np.asarray(opt.score_matrix(), np.int64)

    def run(qv, tv, stop_at=None):
        n, m = len(qv), len(tv)
        oe_del = opt.o_del + opt.e_del
        oe_ins = opt.o_ins + opt.e_ins
        H = np.zeros(n + 1, np.int64)
        E = np.zeros(n + 1, np.int64)
        jj = np.arange(n)
        best, te, row_max = 0, -1, np.zeros(m, np.int64)
        best_row = None
        prof = mat[:, qv]
        for i in range(m):
            s = prof[tv[i]]
            M = H[:-1] + s
            h = np.maximum(M, E[1:])
            # F scan: f[j+1] = max(f[j]-e_ins, h_pre[j]-oe_ins); local->0
            v = h - oe_ins + jj * opt.e_ins
            cm = np.maximum.accumulate(v)
            F = np.full(n, -1 << 40, np.int64)
            F[1:] = cm[:-1] - jj[1:] * opt.e_ins
            # note: exact kswv uses H-after-F for F source; iterate twice
            h2 = np.maximum(np.maximum(h, F), 0)
            # refine F against h2 until fixpoint (gap chains through
            # F-derived cells; converges geometrically)
            for _ in range(30):
                v = h2 - oe_ins + jj * opt.e_ins
                cm = np.maximum.accumulate(v)
                F2 = np.full(n, -1 << 40, np.int64)
                F2[1:] = cm[:-1] - jj[1:] * opt.e_ins
                nh = np.maximum(np.maximum(h, F2), 0)
                if (nh == h2).all():
                    break
                h2 = nh
            Hn = np.zeros(n + 1, np.int64)
            Hn[1:] = h2
            E[1:] = np.maximum(E[1:] - opt.e_del, h2 - oe_del)
            E[E < 0] = 0
            H = Hn
            row_max[i] = h2.max() if n else 0
            if row_max[i] > best:
                best, te = int(row_max[i]), i
                best_row = h2.copy()
            if stop_at is not None and best >= stop_at:
                break
        return best, te, best_row, row_max

    best, te, best_row, row_max = run(q, t)
    if best < min_sc or te < 0:
        return None
    qe = int(np.argmax(best_row))       # first index achieving the max
    # second best: best row-max outside te +- ceil(score/a)
    i = (best + opt.a - 1) // opt.a
    lo, hi = te - i, te + i
    mask = (np.arange(len(t)) < lo) | (np.arange(len(t)) > hi)
    score2 = int(row_max[mask].max()) if mask.any() else 0
    # start positions: rerun on reversed prefixes
    rq = q[:qe + 1][::-1]
    rt = t[:te + 1][::-1]
    b2, te2, br2, _ = run(rq, rt, stop_at=best)
    if b2 == best and te2 >= 0:
        tb = te - te2
        qb = qe - int(np.argmax(br2))
    else:
        tb, qb = 0, 0
    return dict(score=best, qb=qb, qe=qe, tb=tb, te=te, score2=score2)


_MISSING = object()


def _matesw_window(opt: AlignConfig, pref, pes, anchor, mate_codes, r):
    """The window/orientation setup of mem_matesw for one direction r:
    returns (seq, ref, rb, is_rev, l_ms) or None when the window is
    invalid (off-contig / too short). Shared by the scalar path and the
    batched enumerate+replay so jobs are constructed identically."""
    l_pac = pref.l_pac
    l_ms = len(mate_codes)
    is_rev = (r >> 1) != (r & 1)
    is_larger = not (r >> 1)
    if is_rev:
        seq = np.array([3 - b if b < 4 else 4
                        for b in mate_codes[::-1]], np.int64)
    else:
        seq = np.asarray(mate_codes, np.int64)
    if not is_rev:
        rb = anchor["rb"] + pes[r].low if is_larger \
            else anchor["rb"] - pes[r].high
        re = (anchor["rb"] + pes[r].high if is_larger
              else anchor["rb"] - pes[r].low) + l_ms
    else:
        rb = (anchor["rb"] + pes[r].low if is_larger
              else anchor["rb"] - pes[r].high) - l_ms
        re = anchor["rb"] + pes[r].high if is_larger \
            else anchor["rb"] - pes[r].low
    rb = max(rb, 0)
    re = min(re, 2 * l_pac)
    if rb >= re:
        return None
    ref, rb, re, rid = pref.fetch_window(rb, (rb + re) >> 1, re)
    if rid != anchor["rid"] or re - rb < opt.min_seed_len:
        return None
    return seq, ref, rb, is_rev, l_ms


def _skip_dirs(opt, pes, l_pac, anchor_rb, mate_regs):
    """Directions already satisfied (mem_matesw skip[] setup)."""
    skip = [p.failed for p in pes]
    for r in mate_regs:
        d, dist = infer_dir(l_pac, anchor_rb, r["rb"])
        if pes[d].low <= dist <= pes[d].high:
            skip[d] = True
    return skip


def matesw(opt: AlignConfig, pref, pes, anchor, mate_codes, mate_regs,
           aln_of=None):
    """mem_matesw (bwamem_pair.cpp:150-285): rescue the mate around the
    anchor alignment; appends found regs to mate_regs (kept score-sorted).
    Returns number of rescues. `aln_of(r)` supplies a precomputed
    ksw_align_local result per direction (the batched replay path,
    rescue_all); _MISSING falls back to the scalar SW."""
    l_pac = pref.l_pac
    l_ms = len(mate_codes)
    skip = _skip_dirs(opt, pes, l_pac, anchor["rb"], mate_regs)
    if all(skip):
        return 0
    n = 0
    for r in range(4):
        if skip[r]:
            continue
        w = _matesw_window(opt, pref, pes, anchor, mate_codes, r)
        if w is None:
            continue
        seq, ref, rb, is_rev, l_ms = w
        aln = aln_of(r) if aln_of is not None else _MISSING
        if aln is _MISSING:
            aln = ksw_align_local(seq, ref, opt, opt.min_seed_len * opt.a)
        if aln is None or aln["score"] < opt.min_seed_len * opt.a:
            continue
        b = dict(rid=anchor["rid"], is_alt=anchor["is_alt"],
                 qb=l_ms - (aln["qe"] + 1) if is_rev else aln["qb"],
                 qe=l_ms - aln["qb"] if is_rev else aln["qe"] + 1,
                 rb=2 * l_pac - (rb + aln["te"] + 1) if is_rev
                 else rb + aln["tb"],
                 re=2 * l_pac - (rb + aln["tb"]) if is_rev
                 else rb + aln["te"] + 1,
                 score=aln["score"], truesc=aln["score"],
                 csub=aln["score2"], sub=0, sub_n=0, secondary=-1,
                 w=opt.w, frac_rep=anchor.get("frac_rep", 0.0),
                 seedlen0=0, n_comp=1)
        b["seedcov"] = min(b["re"] - b["rb"], b["qe"] - b["qb"]) >> 1
        # sorted insert by score (bwamem_pair.cpp:232-238)
        i = 0
        while i < len(mate_regs) and mate_regs[i]["score"] >= b["score"]:
            i += 1
        mate_regs.insert(i, b)
        n += 1
    return n


def rescue_all(opt: AlignConfig, pref, pes, reg_pairs, codes_pairs, *,
               device):
    """Batched mate rescue over a whole PE batch — the kswv inter-task
    batch (src/kswv.cpp:126, driven from mem_sam_pe bwamem_pair.cpp:414)
    rebuilt as two device rounds + exact host replay.

    Round `side` rescues end 1-side around end `side`'s anchors. Within
    a round, each pair's anchor set is frozen before any rescue (as in
    mem_sam_pe: `cand` is computed before the anchor loop) and rescues
    only ADD skip conditions, so enumerating jobs with round-start skips
    yields a superset of the sequentially-executed jobs; the replay then
    runs the exact sequential logic consuming precomputed SW results.
    Round 1 re-enumerates after round 0's insertions (a round-0 rescue
    can become a round-1 anchor, bwamem_pair.cpp:414-428 order).

    Mutates reg_pairs in place (same postcondition as per-pair matesw
    calls inside sam_pe). The SW batches run on `device`: the kswv
    kernel on the card, its plain version on the CPU."""
    l_pac = pref.l_pac
    for side in (0, 1):
        jobs, meta, cands = [], [], []
        for p, regs_pair in enumerate(reg_pairs):
            regs = regs_pair[side]
            if not regs:
                continue
            best = regs[0]["score"]
            cand = [r for r in regs
                    if r["score"] >= best - opt.pen_unpaired]
            cand = cand[:opt.max_matesw]
            cands.append((p, cand))
            mate_codes = codes_pairs[p][1 - side]
            mate_regs = regs_pair[1 - side]
            for ai, anchor in enumerate(cand):
                skip0 = _skip_dirs(opt, pes, l_pac, anchor["rb"],
                                   mate_regs)
                if all(skip0):
                    continue
                for r in range(4):
                    if skip0[r]:
                        continue
                    w = _matesw_window(opt, pref, pes, anchor,
                                       mate_codes, r)
                    if w is None:
                        continue
                    jobs.append((w[0], w[1]))
                    meta.append((p, ai, r))
        alns = ksw_align_local_batch(jobs, opt, device)
        lookup = dict(zip(meta, alns))
        for p, cand in cands:
            mate_codes = codes_pairs[p][1 - side]
            mate_regs = reg_pairs[p][1 - side]
            for ai, anchor in enumerate(cand):
                matesw(opt, pref, pes, anchor, mate_codes, mate_regs,
                       aln_of=lambda r, p=p, ai=ai:
                       lookup.get((p, ai, r), _MISSING))


def raw_mapq(diff, a):
    return int(6.02 * diff / a + 0.499)


def sam_pe_plan(opt: AlignConfig, pref, pes, read_id, a):
    """Selection half of mem_sam_pe (bwamem_pair.cpp:354-527): primary
    marking, pairing, pair-MAPQ. Mutates the reg dicts exactly like
    sam_pe's first half; performs NO reg2aln (the CIGAR DP), so a
    batch driver can plan every pair first and run one batched DP
    (finalize.reg2aln_batch — the SE path's move; scalar per-reg DP
    measured 5.8 s of a 4096-read PE batch finalize).

    Returns {"mode": "paired", "z", "q_se", "extra_flag"} or
    {"mode": "unpaired", "which", "extra_flag", "n_pri"}."""
    n_pri = [finalize.mark_primary(opt, a[0], read_id * 2),
             finalize.mark_primary(opt, a[1], read_id * 2 + 1)]
    extra_flag = 1

    o = 0
    if n_pri[0] and n_pri[1]:
        o, subo, n_sub, z = mem_pair(opt, pref, pes, a, read_id, n_pri)
    if n_pri[0] and n_pri[1] and o > 0:
        # multi-hit check (bwamem_pair.cpp:441-447)
        is_multi = [any(a[i][j]["secondary"] < 0 and
                        a[i][j]["score"] >= opt.T
                        for j in range(1, n_pri[i])) for i in (0, 1)]
        if not (is_multi[0] or is_multi[1]):
            score_un = a[0][0]["score"] + a[1][0]["score"] - opt.pen_unpaired
            subo = max(subo, score_un)
            q_pe = raw_mapq(o - subo, opt.a)
            if n_sub > 0:
                q_pe -= int(4.343 * math.log(n_sub + 1) + 0.499)
            q_pe = min(max(q_pe, 0), 60)
            q_pe = int(q_pe * (1.0 - 0.5 * (a[0][0]["frac_rep"] +
                                            a[1][0]["frac_rep"])) + 0.499)
            q_se = [0, 0]
            if o > score_un:     # paired alignment preferred
                c = [a[0][z[0]], a[1][z[1]]]
                for i in (0, 1):
                    if c[i]["secondary"] >= 0:
                        c[i]["sub"] = a[i][c[i]["secondary"]]["score"]
                        c[i]["secondary"] = -2
                    q_se[i] = finalize.approx_mapq(opt, c[i])
                for i in (0, 1):
                    q_se[i] = max(q_se[i], min(q_pe, q_se[i] + 40))
                    q_se[i] = min(q_se[i],
                                  raw_mapq(c[i]["score"] - c[i]["csub"],
                                           opt.a))
                extra_flag |= 2
            else:
                z = [0, 0]
                q_se = [finalize.approx_mapq(opt, a[0][0]),
                        finalize.approx_mapq(opt, a[1][0])]
            return dict(mode="paired", z=z, q_se=q_se,
                        extra_flag=extra_flag)

    # no_pairing (bwamem_pair.cpp:528-552) — anchor choice + the
    # properly-paired heuristic flag (rid equality needs no DP)
    which = [None, None]
    for i in (0, 1):
        if a[i]:
            if a[i][0]["score"] >= opt.T:
                which[i] = 0
            elif n_pri[i] < len(a[i]) and \
                    a[i][n_pri[i]]["score"] >= opt.T:
                which[i] = n_pri[i]
    rid = [a[i][which[i]]["rid"] if which[i] is not None else -1
           for i in (0, 1)]
    if rid[0] == rid[1] and rid[0] >= 0 and a[0] and a[1]:
        d, dist = infer_dir(pref.l_pac, a[0][0]["rb"], a[1][0]["rb"])
        if not pes[d].failed and pes[d].low <= dist <= pes[d].high:
            extra_flag |= 2
    return dict(mode="unpaired", which=which, extra_flag=extra_flag)


def sam_pe_emit(opt: AlignConfig, pref, plan, read_id, names, codes_pair,
                quals_pair, a, aln_of=None, alns_by_k=(None, None)):
    """Emission half of mem_sam_pe: reg2aln + SAM text per the plan.
    aln_of(i, k): alignment of end i's reg k (k None = unmapped);
    defaults to the scalar reg2aln. alns_by_k: optional per-end
    {reg_idx: aln} caches forwarded to reg2sam (unpaired mode)."""
    if aln_of is None:
        def aln_of(i, k):
            return finalize.reg2aln(pref, opt, codes_pair[i],
                                    a[i][k] if k is not None else None)

    if plan["mode"] == "paired":
        z, q_se = plan["z"], plan["q_se"]
        h = [None, None]
        for i in (0, 1):
            h[i] = aln_of(i, z[i])
            h[i]["mapq"] = q_se[i]
            h[i]["flag"] |= (0x40 << i) | plan["extra_flag"]
        lines = ([], [])
        for i in (0, 1):
            lines[i].append(finalize.aln2sam(
                pref, opt, names[i], codes_pair[i], quals_pair[i],
                [h[i]], 0, mate=h[1 - i]))
        return lines

    which = plan["which"]
    extra_flag = plan["extra_flag"]
    h = [aln_of(0, which[0]), aln_of(1, which[1])]
    lines0 = finalize.reg2sam(pref, opt, names[0], codes_pair[0],
                              quals_pair[0], a[0], read_id,
                              extra_flag=0x41 | extra_flag, mate=h[1],
                              alns_by_k=alns_by_k[0])
    lines1 = finalize.reg2sam(pref, opt, names[1], codes_pair[1],
                              quals_pair[1], a[1], read_id,
                              extra_flag=0x81 | extra_flag, mate=h[0],
                              alns_by_k=alns_by_k[1])
    return lines0, lines1


def sam_pe(opt: AlignConfig, pref, pes, read_id, names, codes_pair,
           quals_pair, regs_pair, rescue_done=False):
    """mem_sam_pe (bwamem_pair.cpp:354-552): mate rescue, pairing, pair
    MAPQ, SAM for both ends. regs_pair: two score-sorted reg lists (raw,
    pre mark_primary). rescue_done skips the per-pair rescue loop when
    the batch already ran rescue_all. Returns (lines0, lines1)."""
    # mate rescue around near-best hits of the other end
    if not rescue_done:   # MEM_F_NO_RESCUE off by default
        for i in (0, 1):
            if not regs_pair[i]:
                continue
            best = regs_pair[i][0]["score"]
            cand = [r for r in regs_pair[i]
                    if r["score"] >= best - opt.pen_unpaired]
            for j, anchor in enumerate(cand):
                if j >= opt.max_matesw:
                    break
                matesw(opt, pref, pes, anchor, codes_pair[1 - i],
                       regs_pair[1 - i])

    plan = sam_pe_plan(opt, pref, pes, read_id, regs_pair)
    return sam_pe_emit(opt, pref, plan, read_id, names, codes_pair,
                       quals_pair, regs_pair)


def mem_pair(opt: AlignConfig, pref, pes, regs_pair, read_id, n_pri):
    """mem_pair (bwamem_pair.cpp:286-347). Returns
    (o_score, sub, n_sub, z=[i0, i1]) or (0, 0, 0, None)."""
    l_pac = pref.l_pac
    v = []
    for r in (0, 1):
        for i in range(n_pri[r]):
            e = regs_pair[r][i]
            x_fwd = e["rb"] if e["rb"] < l_pac else 2 * l_pac - 1 - e["rb"]
            key_x = (e["rid"] << 32) | int(x_fwd - pref.offsets[e["rid"]])
            key_y = (e["score"] << 32) | (i << 2) | \
                (2 if e["rb"] >= l_pac else 0) | r
            v.append((key_x, key_y))
    v.sort()
    y = [-1, -1, -1, -1]
    u = []
    for i in range(len(v)):
        for r in (0, 1):
            dr = (r << 1) | ((v[i][1] >> 1) & 1)
            if pes[dr].failed:
                continue
            which = (r << 1) | ((v[i][1] & 1) ^ 1)
            if y[which] < 0:
                continue
            for k in range(y[which], -1, -1):
                if (v[k][1] & 3) != which:
                    continue
                dist = v[i][0] - v[k][0]
                if dist > pes[dr].high:
                    break
                if dist < pes[dr].low:
                    continue
                ns = (dist - pes[dr].avg) / pes[dr].std
                # erfc underflows to 0 for |ns| >~ 27; C's log(0) = -inf
                # clamps q to 0 below — mirror that without raising
                tail = max(2.0 * math.erfc(abs(ns) * M_SQRT1_2), 1e-300)
                q = int((v[i][1] >> 32) + (v[k][1] >> 32) +
                        0.721 * math.log(tail) * opt.a + 0.499)
                q = max(q, 0)
                pair_y = (k << 32) | i
                u.append(((q << 32) |
                          (finalize.hash_64(pair_y ^ (read_id << 8)) &
                           0xffffffff), pair_y))
        y[v[i][1] & 3] = i
    if not u:
        return 0, 0, 0, None
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    u.sort()
    i = u[-1][1] >> 32
    k = u[-1][1] & 0xffffffff
    z = [0, 0]
    z[v[i][1] & 1] = (v[i][1] & 0xffffffff) >> 2
    z[v[k][1] & 1] = (v[k][1] & 0xffffffff) >> 2
    o = u[-1][0] >> 32
    sub = (u[-2][0] >> 32) if len(u) > 1 else 0
    n_sub = sum(1 for x in u[:-1] if sub - (x[0] >> 32) <= tmp)
    return o, sub, n_sub, z
