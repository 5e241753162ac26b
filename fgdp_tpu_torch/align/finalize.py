"""Host-side alignment finalization: dedup/patch, primary marking, MAPQ,
CIGAR + MD/NM, SAM formatting.

Transcribes the reference's post-extension path:
  * mem_sort_dedup_patch / mem_patch_reg  (src/bwamem.cpp:317-372, :195-243)
  * mem_mark_primary_se(+_core)           (src/bwamem.cpp:1854-1926)
  * mem_approx_mapq_se                    (src/bwamem.cpp:1931-1956)
  * mem_reg2aln + bwa_gen_cigar2 + ksw_global2
    (src/bwamem.cpp:2194-2267, src/bwa.cpp, src/ksw.cpp)
  * mem_reg2sam / mem_aln2sam             (src/bwamem.cpp:1983-2193)

These are heavy-logic, light-FLOP steps on O(#alignments) records — host
NumPy territory; the global-alignment DP runs in the native batch library
(fgdp_native ksw_global2), with the scalar ksw_global for jobs whose
CIGAR overflows its buffer. XA-tag generation
(mem_gen_alt, src/bwamem_extra.cpp:840) is implemented in gen_xa().
"""

from __future__ import annotations

import math

import numpy as np

from ..config import AlignConfig
from ..index.reference import PackedReference

MINUS_INF = -0x40000000
_CIGAR_OPS = "MIDSH"


def hash_64(key: int) -> int:
    """Invertible 64-bit mix (reference ext/TAL/ext/utils.h:117-128)."""
    mask = (1 << 64) - 1
    key = (key + (~(key << 32) & mask)) & mask
    key ^= key >> 22
    key = (key + (~(key << 13) & mask)) & mask
    key ^= key >> 8
    key = (key + (key << 3)) & mask
    key ^= key >> 15
    key = (key + (~(key << 27) & mask)) & mask
    key ^= key >> 31
    return key


# --------------------------------------------------------------------------
# ksw_global2: banded global alignment with traceback (src/ksw.cpp)
# --------------------------------------------------------------------------

def ksw_global(query, target, o_del, e_del, o_ins, e_ins, w, mat,
               want_cigar=True):
    """Returns (score, cigar) with cigar = [(op, len)] ops in {0:M,1:I,2:D}.
    Rows vectorized in numpy; per-cell direction bits match ksw_global2."""
    qlen, tlen = len(query), len(target)
    oe_del, oe_ins = o_del + e_del, o_ins + e_ins
    n_col = min(qlen, 2 * w + 1)
    mat = np.asarray(mat, np.int64).reshape(5, 5)
    q_prof = mat[:, np.asarray(query, np.int64)]      # [5, qlen]

    eh_h = np.full(qlen + 2, MINUS_INF, np.int64)
    eh_e = np.full(qlen + 2, MINUS_INF, np.int64)
    eh_h[0] = 0
    jr = np.arange(1, qlen + 1)
    eh_h[1:qlen + 1] = np.where(jr <= w, -(o_ins + e_ins * jr), MINUS_INF)
    z = np.zeros((tlen, n_col), np.uint8) if want_cigar else None
    jcols = np.arange(qlen)

    for i in range(tlen):
        beg = max(i - w, 0)
        end = min(i + w + 1, qlen)
        if beg >= end:
            continue
        h1_init = -(o_del + e_del * (i + 1)) if beg == 0 else MINUS_INF
        q = q_prof[int(target[i]), beg:end]
        Hd = eh_h[beg:end]                  # H(i-1, j-1)
        E = eh_e[beg:end]
        m = Hd + q
        d = (m < E).astype(np.uint8)        # 0: from M, 1: from E
        h = np.maximum(m, E)
        # F scan: f[beg]=-inf; f[j+1]=max(f[j]-e_ins, m[j]-oe_ins)
        t_ins = m - oe_ins
        v = t_ins + jcols[beg:end] * e_ins
        cm = np.maximum.accumulate(v)
        F = np.empty_like(m)
        F[0] = MINUS_INF
        if end - beg > 1:
            F[1:] = cm[:-1] - (jcols[beg + 1:end] - 1) * e_ins
        d = np.where(h >= F, d, 2).astype(np.uint8)
        H = np.maximum(h, F)
        # e/f continuation bits for the next cells (z layout f<<4|e<<2|h,
        # ksw.cpp: e-continue = 1<<2, f-continue = 2<<4)
        d |= ((E - e_del > m - oe_del).astype(np.uint8)) << 2
        d |= ((F - e_ins > m - oe_ins).astype(np.uint8)) << 5
        if want_cigar:
            z[i, :end - beg] = d
        # state update (shifted-H convention)
        eh_e[beg:end] = np.maximum(m - oe_del, E - e_del)
        eh_h[beg + 1:end + 1] = H
        eh_h[beg] = h1_init
        eh_e[end] = MINUS_INF

    score = int(eh_h[qlen])
    if not want_cigar:
        return score, None
    # backtrack (ksw.cpp:196-211)
    cigar = []
    i = tlen - 1
    k = min(i + w + 1, qlen) - 1
    which = 0
    while i >= 0 and k >= 0:
        which = (int(z[i, k - max(i - w, 0)]) >> (which << 1)) & 3
        if which == 0:
            _push(cigar, 0, 1)
            i -= 1
            k -= 1
        elif which == 1:
            _push(cigar, 2, 1)
            i -= 1
        else:
            _push(cigar, 1, 1)
            k -= 1
    if i >= 0:
        _push(cigar, 2, i + 1)
    if k >= 0:
        _push(cigar, 1, k + 1)
    cigar.reverse()
    return score, cigar


def _push(cigar, op, length):
    if cigar and cigar[-1][0] == op:
        cigar[-1] = (op, cigar[-1][1] + length)
    else:
        cigar.append((op, length))


def gen_cigar(pref: PackedReference, opt: AlignConfig, w, qb_query, rb, re,
              want_cigar=True):
    """bwa_gen_cigar2 (src/bwa.cpp): returns (score, cigar, NM, MD, rseq,
    query_used) — query/rseq reversed in place when on the reverse strand."""
    l_pac = pref.l_pac
    query = np.asarray(qb_query, np.uint8).copy()
    l_query = len(query)
    if l_query <= 0 or rb >= re or (rb < l_pac and re > l_pac):
        return None
    rseq = pref.get_seq(rb, re).copy()
    if len(rseq) != re - rb:
        return None
    if rb >= l_pac:
        query = query[::-1].copy()
        rseq = rseq[::-1].copy()
    if l_query == re - rb and w == 0:
        cigar = [(0, l_query)]
        mat = opt.score_matrix()
        score = int(sum(int(mat[rseq[i], query[i]]) for i in range(l_query)))
    else:
        max_ins = int((((l_query + 1) >> 1) * opt.a - opt.o_ins) /
                      opt.e_ins + 1.0)
        max_del = int((((l_query + 1) >> 1) * opt.a - opt.o_del) /
                      opt.e_del + 1.0)
        max_gap = max(max(max_ins, max_del), 1)
        ww = (max_gap + abs(len(rseq) - l_query) + 1) >> 1
        ww = min(ww, w)
        ww = max(ww, abs(len(rseq) - l_query) + 3)
        score, cigar = ksw_global(query, rseq, opt.o_del, opt.e_del,
                                  opt.o_ins, opt.e_ins, ww,
                                  opt.score_matrix(), want_cigar)
    if not want_cigar:
        return score, None, -1, "", rseq, query
    # NM / MD (bwa.cpp:...)
    int2base = "ACGTN" if rb < l_pac else "TGCAN"
    md = []
    x = y = u = 0
    n_mm = n_gap = 0
    for ci, (op, ln) in enumerate(cigar):
        if op == 0:
            for i in range(ln):
                if query[x + i] != rseq[y + i]:
                    md.append(str(u))
                    md.append(int2base[rseq[y + i]])
                    n_mm += 1
                    u = 0
                else:
                    u += 1
            x += ln
            y += ln
        elif op == 2:
            if 0 < ci < len(cigar) - 1:
                md.append(str(u))
                md.append("^")
                md.extend(int2base[rseq[y + i]] for i in range(ln))
                u = 0
                n_gap += ln
            y += ln
        elif op == 1:
            x += ln
            n_gap += ln
    md.append(str(u))
    return score, cigar, n_mm + n_gap, "".join(md), rseq, query


# --------------------------------------------------------------------------
# dedup / patch (mem_sort_dedup_patch)
# --------------------------------------------------------------------------

PATCH_MAX_R_BW = 0.05
PATCH_MIN_SC_RATIO = 0.90


def _patch_reg(pref, opt, query, a, b):
    """mem_patch_reg (bwamem.cpp:195-243): 0 or merged score (+w out)."""
    if a["rb"] < pref.l_pac <= b["rb"]:
        return 0, 0
    if a["qb"] >= b["qb"] or a["qe"] >= b["qe"] or a["re"] >= b["re"]:
        return 0, 0
    w = abs((a["re"] - b["rb"]) - (a["qe"] - b["qb"]))
    r = abs((a["re"] - b["rb"]) / (b["re"] - a["rb"]) -
            (a["qe"] - b["qb"]) / (b["qe"] - a["qb"]))
    if a["re"] < b["rb"] or a["qe"] < b["qb"]:
        if w > opt.w * 2 or r >= PATCH_MAX_R_BW:
            return 0, 0
    elif w > opt.w * 4 or r >= PATCH_MAX_R_BW * 2:
        return 0, 0
    w += a["w"] + b["w"]
    w = min(w, opt.w * 4)
    res = gen_cigar(pref, opt, w, query[a["qb"]:b["qe"]], a["rb"], b["re"],
                    want_cigar=False)
    if res is None:
        return 0, 0
    score = res[0]
    q_s = int((b["qe"] - a["qb"]) / ((b["qe"] - b["qb"]) +
                                     (a["qe"] - a["qb"])) *
              (b["score"] + a["score"]) + 0.499)
    r_s = int((b["re"] - a["rb"]) / ((b["re"] - b["rb"]) +
                                     (a["re"] - a["rb"])) *
              (b["score"] + a["score"]) + 0.499)
    if score / max(q_s, r_s) < PATCH_MIN_SC_RATIO:
        return 0, 0
    return score, w


def sort_dedup_patch(pref: PackedReference, opt: AlignConfig, query, regs):
    """mem_sort_dedup_patch (bwamem.cpp:317-372). regs: list of dicts,
    mutated; returns the surviving list."""
    n = len(regs)
    if n <= 1:
        return regs
    regs.sort(key=lambda r: r["re"])
    for r in regs:
        r["n_comp"] = 1
    for i in range(1, n):
        p = regs[i]
        if p["rid"] != regs[i - 1]["rid"] or \
                p["rb"] >= regs[i - 1]["re"] + opt.max_chain_gap:
            continue
        for j in range(i - 1, -1, -1):
            q = regs[j]
            if p["rid"] != q["rid"] or p["rb"] >= q["re"] + opt.max_chain_gap:
                break
            if q["qe"] == q["qb"]:
                continue
            or_ = q["re"] - p["rb"]
            oq = (q["qe"] - p["qb"]) if q["qb"] < p["qb"] else (p["qe"] - q["qb"])
            mr = min(q["re"] - q["rb"], p["re"] - p["rb"])
            mq = min(q["qe"] - q["qb"], p["qe"] - p["qb"])
            if or_ > opt.mask_level_redun * mr and \
                    oq > opt.mask_level_redun * mq:
                if p["score"] < q["score"]:
                    p["qe"] = p["qb"]
                    break
                q["qe"] = q["qb"]
            elif q["rb"] < p["rb"]:
                score, w = _patch_reg(pref, opt, query, q, p)
                if score > 0:
                    p["n_comp"] += q["n_comp"] + 1
                    p["seedcov"] = max(p["seedcov"], q["seedcov"])
                    p["sub"] = max(p.get("sub", 0), q.get("sub", 0))
                    p["csub"] = max(p.get("csub", 0), q.get("csub", 0))
                    p["qb"], p["rb"] = q["qb"], q["rb"]
                    p["truesc"] = p["score"] = score
                    p["w"] = w
                    q["qb"] = q["qe"]
    regs = [r for r in regs if r["qe"] > r["qb"]]
    regs.sort(key=lambda r: (-r["score"], r["rb"], r["qb"]))
    for i in range(1, len(regs)):
        if regs[i]["score"] == regs[i - 1]["score"] and \
                regs[i]["rb"] == regs[i - 1]["rb"] and \
                regs[i]["qb"] == regs[i - 1]["qb"]:
            regs[i]["qe"] = regs[i]["qb"]
    return [r for i, r in enumerate(regs) if i == 0 or r["qe"] > r["qb"]]


# --------------------------------------------------------------------------
# primary marking (mem_mark_primary_se)
# --------------------------------------------------------------------------

def _mark_primary_core(opt, regs, n):
    tmp = max(opt.a + opt.b, opt.o_del + opt.e_del, opt.o_ins + opt.e_ins)
    z = [0]
    for i in range(1, n):
        found = False
        for k in z:
            j = k
            b_max = max(regs[j]["qb"], regs[i]["qb"])
            e_min = min(regs[j]["qe"], regs[i]["qe"])
            if e_min > b_max:
                min_l = min(regs[i]["qe"] - regs[i]["qb"],
                            regs[j]["qe"] - regs[j]["qb"])
                if e_min - b_max >= min_l * opt.mask_level:
                    if regs[j]["sub"] == 0:
                        regs[j]["sub"] = regs[i]["score"]
                    if regs[j]["score"] - regs[i]["score"] <= tmp and \
                            (regs[j]["is_alt"] or not regs[i]["is_alt"]):
                        regs[j]["sub_n"] += 1
                    regs[i]["secondary"] = j
                    found = True
                    break
        if not found:
            z.append(i)


def mark_primary(opt: AlignConfig, regs, read_id: int):
    """mem_mark_primary_se (bwamem.cpp:1882-1926). Sorts regs in place by
    (score desc, is_alt, hash) and assigns secondary/sub fields."""
    n = len(regs)
    if n == 0:
        return 0
    n_pri = 0
    for i, r in enumerate(regs):
        r["sub"] = r["alt_sc"] = 0
        r["sub_n"] = 0
        r["secondary"] = r["secondary_all"] = -1
        r["hash"] = hash_64(read_id + i)
        if not r["is_alt"]:
            n_pri += 1
    regs.sort(key=lambda r: (-r["score"], r["is_alt"], r["hash"]))
    _mark_primary_core(opt, regs, n)
    for i, r in enumerate(regs):
        r["secondary_all"] = i
        if not r["is_alt"] and r["secondary"] >= 0 and \
                regs[r["secondary"]]["is_alt"]:
            r["alt_sc"] = regs[r["secondary"]]["score"]
    if n_pri < n:
        z = [0] * n
        if n_pri > 0:
            regs.sort(key=lambda r: (r["is_alt"], -r["score"], r["hash"]))
        for i, r in enumerate(regs):
            z[r["secondary_all"]] = i
        for r in regs:
            if r["secondary"] >= 0:
                r["secondary_all"] = z[r["secondary"]]
                if r["is_alt"]:
                    r["secondary"] = 2**31 - 1
            else:
                r["secondary_all"] = -1
        if n_pri > 0:
            for i in range(n_pri):
                regs[i]["sub"] = 0
                regs[i]["secondary"] = -1
            _mark_primary_core(opt, regs, n_pri)
    else:
        for r in regs:
            r["secondary_all"] = r["secondary"]
    return n_pri


def approx_mapq(opt: AlignConfig, r) -> int:
    """mem_approx_mapq_se (bwamem.cpp:1931-1956)."""
    sub = r["sub"] if r["sub"] else opt.min_seed_len * opt.a
    sub = max(r.get("csub", 0), sub)
    if sub >= r["score"]:
        return 0
    l = max(r["qe"] - r["qb"], r["re"] - r["rb"])
    identity = 1.0 - (l * opt.a - r["score"]) / (opt.a + opt.b) / l
    if r["score"] == 0:
        mapq = 0
    elif opt.mapQ_coef_len > 0:
        tmp = 1.0 if l < opt.mapQ_coef_len else opt.mapQ_coef_fac / math.log(l)
        tmp *= identity * identity
        mapq = int(6.02 * (r["score"] - sub) / opt.a * tmp * tmp + 0.499)
    else:
        mapq = int(30.0 * (1.0 - sub / r["score"]) *
                   math.log(r["seedcov"]) + 0.499)
        mapq = int(mapq * identity * identity + 0.499) if identity < 0.95 \
            else mapq
    if r["sub_n"] > 0:
        mapq -= int(4.343 * math.log(r["sub_n"] + 1) + 0.499)
    mapq = min(mapq, 60)
    mapq = max(mapq, 0)
    return int(mapq * (1.0 - r["frac_rep"]) + 0.499)


# --------------------------------------------------------------------------
# reg -> aln (coordinates, cigar) and SAM text
# --------------------------------------------------------------------------

def infer_bw(l1, l2, score, a, q, r):
    if l1 == l2 and l1 * a - score < (q + r - a) * 2:
        return 0
    w = int((min(l1, l2) * a - score - q) / r + 2.0)
    return max(w, abs(l1 - l2))


def reg2aln(pref: PackedReference, opt: AlignConfig, query, reg):
    """mem_reg2aln (bwamem.cpp:2194-2267). query: int codes.
    Returns aln dict (rid, pos, is_rev, mapq, flag, cigar, NM, MD, ...)."""
    aln = dict(flag=0, cigar=[], md="", nm=-1, sub=-1, score=-1, mapq=0,
               rid=-1, pos=-1, is_rev=False, is_alt=False, alt_sc=0)
    if reg is None or reg["rb"] < 0 or reg["re"] < 0:
        aln["flag"] |= 0x4
        return aln
    qb, qe, rb, re = reg["qb"], reg["qe"], reg["rb"], reg["re"]
    l_query = len(query)
    aln["mapq"] = approx_mapq(opt, reg) if reg["secondary"] < 0 else 0
    if reg["secondary"] >= 0:
        aln["flag"] |= 0x100
    w2 = max(infer_bw(qe - qb, re - rb, reg["truesc"], opt.a, opt.o_del,
                      opt.e_del),
             infer_bw(qe - qb, re - rb, reg["truesc"], opt.a, opt.o_ins,
                      opt.e_ins))
    if w2 > opt.w:
        w2 = min(w2, reg["w"])
    last_sc = -(1 << 30)
    i = 0
    while True:
        w2 = min(w2, opt.w * 4)
        res = gen_cigar(pref, opt, w2, query[qb:qe], rb, re)
        score, cigar, nm, md = res[0], res[1], res[2], res[3]
        if score == last_sc or w2 == opt.w * 4:
            break
        last_sc = score
        w2 <<= 1
        i += 1
        if i >= 3 or score >= reg["truesc"] - opt.a:
            break
    aln["nm"] = nm
    aln["md"] = md
    pos_f, is_rev = pref.depos(rb if rb < pref.l_pac else re - 1)
    aln["is_rev"] = is_rev
    if cigar:
        # squeeze leading/trailing deletions
        if cigar[0][0] == 2:
            pos_f += cigar[0][1]
            cigar = cigar[1:]
        elif cigar[-1][0] == 2:
            cigar = cigar[:-1]
    if qb != 0 or qe != l_query:
        clip5 = l_query - qe if is_rev else qb
        clip3 = qb if is_rev else l_query - qe
        if clip5:
            cigar = [(3, clip5)] + cigar
        if clip3:
            cigar = cigar + [(3, clip3)]
    aln["cigar"] = cigar
    rid = pref.pos2rid(pos_f)
    aln["rid"] = rid
    aln["pos"] = int(pos_f - pref.offsets[rid])
    aln["score"] = reg["score"]
    aln["sub"] = max(reg["sub"], reg.get("csub", 0))
    aln["is_alt"] = reg["is_alt"]
    aln["alt_sc"] = reg.get("alt_sc", 0)
    return aln


def _md_nm(cigar, query, rseq, int2base):
    """NM/MD from an alignment (bwa_gen_cigar2 tail), numpy per M run."""
    md = []
    x = y = u = 0
    n_mm = n_gap = 0
    for ci, (op, ln) in enumerate(cigar):
        if op == 0:
            qs = np.asarray(query[x:x + ln])
            rs = np.asarray(rseq[y:y + ln])
            mism = np.flatnonzero(qs != rs)
            prev = -1
            for i in mism:
                i = int(i)
                md.append(str((u + i) if prev < 0 else (i - prev - 1)))
                md.append(int2base[int(rs[i])])
                prev = i
                n_mm += 1
            u = (ln - prev - 1) if prev >= 0 else u + ln
            x += ln
            y += ln
        elif op == 2:
            if 0 < ci < len(cigar) - 1:
                md.append(str(u))
                md.append("^")
                md.extend(int2base[int(b)] for b in rseq[y:y + ln])
                u = 0
                n_gap += ln
            y += ln
        elif op == 1:
            x += ln
            n_gap += ln
    md.append(str(u))
    return n_mm + n_gap, "".join(md)


def reg2aln_batch(pref: PackedReference, opt: AlignConfig, jobs):
    """Batched mem_reg2aln over [(codes, reg)] — the per-read DP of
    bwa_gen_cigar2 runs through the native ksw_global_batch in
    w2-doubling rounds.
    Returns aln dicts in job order (exactly matching reg2aln).

    No-gap fast path: jobs whose query/ref spans are equal-length with
    initial w2 == 0 (<= 2 mismatches at default scoring) always resolve
    to a single-M cigar with the matrix-sum score — the w2-doubling loop
    is a provable no-op for them — so their score/NM/MD are computed in
    one vectorized padded compare instead of the per-lane machinery
    (which was the hot spot of host finalize at ~45 us/read)."""
    N = len(jobs)
    mat = opt.score_matrix()
    l_pac = pref.l_pac
    alns = []
    lanes = []   # per-lane DP state for mapped regs
    fast = []    # (idx, reg, query, rseq) no-gap jobs
    for codes, reg in jobs:
        if reg is None or reg["rb"] < 0 or reg["re"] < 0:
            alns.append(dict(flag=0x4, cigar=[], md="", nm=-1, sub=-1,
                             score=-1, mapq=0, rid=-1, pos=-1,
                             is_rev=False, is_alt=False, alt_sc=0))
            continue
        alns.append(None)
        qb, qe, rb, re = reg["qb"], reg["qe"], reg["rb"], reg["re"]
        query = np.asarray(codes[qb:qe], np.uint8)
        rseq = pref.get_seq(rb, re)
        if len(rseq) != re - rb or len(query) == 0:
            # bridging / out of range: scalar fallback
            alns[-1] = reg2aln(pref, opt, codes, reg)
            continue
        if rb >= l_pac:
            query = query[::-1]
            rseq = rseq[::-1]
        w2 = max(infer_bw(qe - qb, re - rb, reg["truesc"], opt.a,
                          opt.o_del, opt.e_del),
                 infer_bw(qe - qb, re - rb, reg["truesc"], opt.a,
                          opt.o_ins, opt.e_ins))
        if w2 > opt.w:
            w2 = min(w2, reg["w"])
        if w2 == 0 and qe - qb == re - rb:
            fast.append((len(alns) - 1, reg, query, rseq, len(codes)))
            continue
        lanes.append(dict(idx=len(alns) - 1, codes=codes, reg=reg,
                          query=np.ascontiguousarray(query),
                          rseq=np.ascontiguousarray(rseq), w2=w2,
                          last_sc=-(1 << 30), it=0, done=False,
                          score=None, cigar=None))

    # ---- vectorized no-gap batch: score + NM/MD in one compare ----
    if fast:
        LM = max(len(q) for _, _, q, _, _ in fast)
        M = len(fast)
        qs_f = np.zeros((M, LM), np.uint8)
        ts_f = np.full((M, LM), 4, np.uint8)   # pad mismatching (masked)
        for i, (_, _, q, t, _) in enumerate(fast):
            qs_f[i, :len(q)] = q
            ts_f[i, :len(t)] = t
        cols = np.arange(LM)
        inlen = cols[None, :] < np.array(
            [len(q) for _, _, q, _, _ in fast])[:, None]
        mm_rows, mm_cols = np.nonzero((qs_f != ts_f) & inlen)
        mm_split = np.searchsorted(mm_rows, np.arange(M + 1))
        for i, (idx, reg, q, t, l_query) in enumerate(fast):
            ln = len(q)
            pos_mm = mm_cols[mm_split[i]:mm_split[i + 1]]
            int2base = "ACGTN" if reg["rb"] < l_pac else "TGCAN"
            md = []
            prev = -1
            for p in pos_mm.tolist():
                md.append(str(p if prev < 0 else p - prev - 1))
                md.append(int2base[t[p]])
                prev = p
            md.append(str(ln - prev - 1 if prev >= 0 else ln))
            alns[idx] = _finish_aln(pref, opt, reg, [(0, ln)],
                                    "".join(md), int(len(pos_mm)),
                                    l_query)
    # w2-doubling rounds (reg2aln loop, bwamem.cpp:2220-2229)
    for _ in range(5):
        pend = [ln for ln in lanes if not ln["done"]]
        if not pend:
            break
        dp = []
        for ln in pend:
            ln["w2"] = min(ln["w2"], opt.w * 4)
            l_query = len(ln["query"])
            rlen = len(ln["rseq"])
            if l_query == rlen and ln["w2"] == 0:   # no-gap fast path
                ln["cigar"] = [(0, l_query)]
                ln["score"] = int(mat[np.asarray(ln["rseq"], np.intp),
                                      np.asarray(ln["query"], np.intp)]
                                  .sum())
            else:
                max_ins = int((((l_query + 1) >> 1) * opt.a - opt.o_ins) /
                              opt.e_ins + 1.0)
                max_del = int((((l_query + 1) >> 1) * opt.a - opt.o_del) /
                              opt.e_del + 1.0)
                max_gap = max(max(max_ins, max_del), 1)
                ww = (max_gap + abs(rlen - l_query) + 1) >> 1
                ww = min(ww, ln["w2"])
                ww = max(ww, abs(rlen - l_query) + 3)
                ln["_ww"] = ww
                dp.append(ln)
        if dp:
            QM = max(len(ln["query"]) for ln in dp)
            TM = max(len(ln["rseq"]) for ln in dp)
            qs = np.zeros((len(dp), QM), np.int64)
            ts = np.zeros((len(dp), TM), np.int64)
            qlens = np.zeros(len(dp), np.int64)
            tlens = np.zeros(len(dp), np.int64)
            ws = np.zeros(len(dp), np.int64)
            for i, ln in enumerate(dp):
                qs[i, :len(ln["query"])] = ln["query"]
                ts[i, :len(ln["rseq"])] = ln["rseq"]
                qlens[i] = len(ln["query"])
                tlens[i] = len(ln["rseq"])
                ws[i] = ln["_ww"]
            # native banded DP (computes only the band, pthread fan-out);
            # the scalar ksw_global on cigar overflow
            from ..io import native as _native
            scores, cigars = _native.ksw_global_batch(
                qs, qlens, ts, tlens, ws, opt.o_del, opt.e_del,
                opt.o_ins, opt.e_ins, mat)
            for i, ln in enumerate(dp):
                if cigars[i] is None:   # > max_cig ops: scalar twin
                    sc, cg = ksw_global(
                        ln["query"], ln["rseq"], opt.o_del, opt.e_del,
                        opt.o_ins, opt.e_ins, int(ws[i]), mat)
                    ln["score"], ln["cigar"] = int(sc), cg
                else:
                    ln["score"] = int(scores[i])
                    ln["cigar"] = cigars[i]
        for ln in pend:
            if ln["score"] == ln["last_sc"] or ln["w2"] == opt.w * 4:
                ln["done"] = True
                continue
            ln["last_sc"] = ln["score"]
            ln["w2"] <<= 1
            ln["it"] += 1
            if ln["it"] >= 3 or ln["score"] >= \
                    ln["reg"]["truesc"] - opt.a:
                ln["done"] = True

    for ln in lanes:
        reg = ln["reg"]
        int2base = "ACGTN" if reg["rb"] < pref.l_pac else "TGCAN"
        nm, md = _md_nm(ln["cigar"], ln["query"], ln["rseq"], int2base)
        alns[ln["idx"]] = _finish_aln(pref, opt, reg, ln["cigar"], md,
                                      nm, len(ln["codes"]))
    return alns


def _finish_aln(pref: PackedReference, opt: AlignConfig, reg, cigar, md,
                nm, l_query):
    """Shared aln-dict tail of mem_reg2aln: coordinates, strand, clip
    ops, mapq (bwamem.cpp:2230-2290). `cigar` is in DP orientation."""
    rb, re, qb, qe = reg["rb"], reg["re"], reg["qb"], reg["qe"]
    aln = dict(flag=0, cigar=[], md=md, nm=nm, sub=-1, score=-1,
               mapq=0, rid=-1, pos=-1, is_rev=False, is_alt=False,
               alt_sc=0)
    aln["mapq"] = approx_mapq(opt, reg) if reg["secondary"] < 0 else 0
    if reg["secondary"] >= 0:
        aln["flag"] |= 0x100
    pos_f, is_rev = pref.depos(rb if rb < pref.l_pac else re - 1)
    aln["is_rev"] = is_rev
    if cigar:
        if cigar[0][0] == 2:
            pos_f += cigar[0][1]
            cigar = cigar[1:]
        elif cigar[-1][0] == 2:
            cigar = cigar[:-1]
    if qb != 0 or qe != l_query:
        clip5 = l_query - qe if is_rev else qb
        clip3 = qb if is_rev else l_query - qe
        if clip5:
            cigar = [(3, clip5)] + cigar
        if clip3:
            cigar = cigar + [(3, clip3)]
    aln["cigar"] = cigar
    rid = pref.pos2rid(pos_f)
    aln["rid"] = rid
    aln["pos"] = int(pos_f - pref.offsets[rid])
    aln["score"] = reg["score"]
    aln["sub"] = max(reg["sub"], reg.get("csub", 0))
    aln["is_alt"] = reg["is_alt"]
    aln["alt_sc"] = reg.get("alt_sc", 0)
    return aln


def _cigar_str(opt, aln, which):
    if not aln["cigar"]:
        return "*"
    out = []
    for op, ln in aln["cigar"]:
        c = op
        if not aln["is_alt"] and c in (3, 4):
            c = 4 if which else 3   # hard clip supplementary
        out.append(f"{ln}{_CIGAR_OPS[c]}")
    return "".join(out)


_SEQ_FWD = "ACGTN"
_SEQ_REV = "TGCAN"
_SEQ_FWD_U8 = np.frombuffer(b"ACGTN", np.uint8)
_SEQ_REV_U8 = np.frombuffer(b"TGCAN", np.uint8)


def _cigar_rlen(cigar):
    return sum(ln for op, ln in cigar if op in (0, 2))


def aln2sam(pref: PackedReference, opt: AlignConfig, name, codes, qual,
            alns, which, mate=None, rg_id=None):
    """mem_aln2sam (bwamem.cpp:2054-2193) incl. the mate path.
    codes: int array. Returns one tab-separated SAM line."""
    p = dict(alns[which])
    m = dict(mate) if mate is not None else None
    if m is not None:
        p["flag"] |= 0x1
        p["flag"] |= 0x8 if m["rid"] < 0 else 0
        if p["rid"] < 0 and m["rid"] >= 0:   # copy mate to alignment
            p["rid"], p["pos"], p["is_rev"] = m["rid"], m["pos"], m["is_rev"]
            p["cigar"] = []
        if m["rid"] < 0 and p["rid"] >= 0:   # copy alignment to mate
            m["rid"], m["pos"], m["is_rev"] = p["rid"], p["pos"], p["is_rev"]
            m["cigar"] = []
    p["flag"] |= 0x4 if p["rid"] < 0 else 0
    p["flag"] |= 0x10 if p["is_rev"] else 0
    if m is not None and m["is_rev"]:
        p["flag"] |= 0x20
    cols = [name, str(p["flag"] & 0xffff | (0x100 if p["flag"] & 0x10000
                                            else 0))]
    if p["rid"] >= 0:
        cols += [pref.names[p["rid"]], str(p["pos"] + 1), str(p["mapq"]),
                 _cigar_str(opt, p, which)]
    else:
        cols += ["*", "0", "0", "*"]
    if m is not None and m["rid"] >= 0:
        rnext = "=" if p["rid"] == m["rid"] else pref.names[m["rid"]]
        if p["rid"] == m["rid"]:
            p0 = p["pos"] + (_cigar_rlen(p["cigar"]) - 1 if p["is_rev"]
                             else 0)
            p1 = m["pos"] + (_cigar_rlen(m["cigar"]) - 1 if m["is_rev"]
                             else 0)
            if not m["cigar"] or not p["cigar"]:
                tlen = 0
            else:
                tlen = -(p0 - p1 + (1 if p0 > p1 else -1 if p0 < p1 else 0))
        else:
            tlen = 0
        cols += [rnext, str(m["pos"] + 1), str(tlen)]
    else:
        cols += ["*", "0", "0"]   # without mate coordinate
    if p["flag"] & 0x100:
        cols += ["*", "*"]
    else:
        qb, qe = 0, len(codes)
        if p["cigar"] and which and not p["is_alt"]:
            if p["cigar"][0][0] in (3, 4):
                if p["is_rev"]:
                    qe -= p["cigar"][0][1]
                else:
                    qb += p["cigar"][0][1]
            if p["cigar"][-1][0] in (3, 4):
                if p["is_rev"]:
                    qb += p["cigar"][-1][1]
                else:
                    qe -= p["cigar"][-1][1]
        cseg = np.asarray(codes[qb:qe], np.intp)
        if p["is_rev"]:
            seq = _SEQ_REV_U8[cseg[::-1]].tobytes().decode("ascii")
            q = qual[qb:qe][::-1] if qual else "*"
        else:
            seq = _SEQ_FWD_U8[cseg].tobytes().decode("ascii")
            q = qual[qb:qe] if qual else "*"
        cols += [seq, q if q else "*"]
    tags = []
    if p["cigar"]:
        tags.append(f"NM:i:{p['nm']}")
        tags.append(f"MD:Z:{p['md']}")
    if p["score"] >= 0:
        tags.append(f"AS:i:{p['score']}")
    if p["sub"] >= 0:
        tags.append(f"XS:i:{p['sub']}")
    if rg_id:
        tags.append(f"RG:Z:{rg_id}")
    if not (p["flag"] & 0x100):
        others = [r for i, r in enumerate(alns)
                  if i != which and not (r["flag"] & 0x100)]
        if others:
            sa = []
            for r in others:
                sa.append(f"{pref.names[r['rid']]},{r['pos'] + 1},"
                          f"{'-' if r['is_rev'] else '+'},"
                          f"{''.join(str(ln) + _CIGAR_OPS[op] for op, ln in r['cigar'])},"
                          f"{r['mapq']},{r['nm']};")
            tags.append("SA:Z:" + "".join(sa))
    if p.get("xa"):
        tags.append("XA:Z:" + p["xa"])
    return "\t".join(cols + tags)


def gen_alt(pref: PackedReference, opt: AlignConfig, codes, regs):
    """mem_gen_alt (bwamem_extra.cpp:124-185): XA strings per reg index
    (None where absent). Call after mark_primary."""
    n = len(regs)
    if n == 0:
        return [None] * n

    def pri_idx(i):
        k = regs[i]["secondary_all"]
        if k is not None and 0 <= k < n and \
                regs[i]["score"] >= regs[k]["score"] * opt.XA_drop_ratio:
            return k
        return -1

    cnt = [0] * n
    has_alt = [False] * n
    tot = 0
    for i in range(n):
        r = pri_idx(i)
        if r >= 0:
            cnt[r] += 1
            tot += 1
            if regs[i]["is_alt"]:
                has_alt[r] = True
    if tot == 0:
        return [None] * n
    aln = [[] for _ in range(n)]
    jobs, owners = [], []
    for i in range(n):
        r = pri_idx(i)
        if r < 0:
            continue
        if cnt[r] > opt.max_XA_hits_alt or \
                (not has_alt[r] and cnt[r] > opt.max_XA_hits):
            continue
        jobs.append((codes, regs[i]))
        owners.append(r)
    # batched CIGAR DP (native ksw_global + vectorized no-gap path):
    # the scalar reg2aln per alt hit was the repeat-workload finalize
    # hot spot (~5.6 ms per gapped python-DP call)
    alns = reg2aln_batch(pref, opt, jobs) if jobs else []
    for r, t in zip(owners, alns):
        cig = "".join(f"{ln}{_CIGAR_OPS[op] if op < 5 else 'N'}"
                      for op, ln in t["cigar"])
        aln[r].append(f"{pref.names[t['rid']]},"
                      f"{'-' if t['is_rev'] else '+'}{t['pos'] + 1},"
                      f"{cig},{t['nm']};")
    return ["".join(x) if x else None for x in aln]


def selected_regs(opt: AlignConfig, regs):
    """Indices of regs that mem_reg2sam will emit
    (bwamem.cpp:2000-2005): score/secondary gates; with -a (MEM_F_ALL)
    non-alt secondaries above drop_ratio are emitted too."""
    out = []
    for k, r in enumerate(regs):
        if r["score"] < opt.T:
            continue
        if r["secondary"] >= 0 and (r["is_alt"] or not opt.output_all):
            continue
        if 0 <= r["secondary"] < 2**31 - 1 and \
                r["score"] < regs[r["secondary"]]["score"] * opt.drop_ratio:
            continue
        out.append(k)
    return out


def reg2sam(pref: PackedReference, opt: AlignConfig, name, codes, qual,
            regs, read_id, extra_flag=0, mate=None, alns_by_k=None):
    """mem_reg2sam (bwamem.cpp:1983-2040). regs already through
    dedup + mark_primary. alns_by_k: optional precomputed reg2aln
    results (from reg2aln_batch). Returns list of SAM lines."""
    # with -a, secondaries are emitted as records, not XA (bwamem.cpp:1991)
    xa = gen_alt(pref, opt, codes, regs) if not opt.output_all \
        else [None] * len(regs)
    alns = []
    keep = []
    sel = set(selected_regs(opt, regs))
    for k, r in enumerate(regs):
        if k not in sel:
            continue
        a = alns_by_k[k] if alns_by_k is not None and k in alns_by_k \
            else reg2aln(pref, opt, codes, r)
        a["xa"] = xa[k]
        a["flag"] |= extra_flag
        if r["secondary"] >= 0:
            a["sub"] = -1
        if keep and r["secondary"] < 0:
            a["flag"] |= 0x800   # supplementary
        if keep and not r["is_alt"] and a["mapq"] > alns[0]["mapq"]:
            a["mapq"] = alns[0]["mapq"]
        alns.append(a)
        keep.append(k)
    if not alns:
        a = reg2aln(pref, opt, codes, None)
        a["flag"] |= extra_flag
        return [aln2sam(pref, opt, name, codes, qual, [a], 0, mate=mate)]
    return [aln2sam(pref, opt, name, codes, qual, alns, k, mate=mate)
            for k in range(len(alns))]
