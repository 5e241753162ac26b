"""Batched seed chaining + chain filtering (device side, torch).

Port of the JAX package's align/chain.py: the reference's per-read
B-tree chaining (mem_chain_seeds_new, src/bwamem.cpp:1163-1237) and
chain filter (mem_chain_flt :529, mem_chain_weight :452) over a read
batch. Seed positions come from one batched SA gather; the chain loop
runs in the hand-written kernel csrc/chain_loop.cu on the card (it
replaces the TPU kernel fgdp_tpu/ops/chain_pallas.py; pos in registers
and the slot rows in shared memory, or the whole table in shared memory
above 256 chain slots), and
`chain_loop_plain` beside it is the same loop as torch ops over all
reads, transcribed from the JAX package's jnp loop: the CPU tests run
it, and the card's smoke run holds the kernel against it. The chain
filter runs in csrc/chain_flt.cu on the card (it replaces the JAX
package's lax.while_loop _chain_flt; one warp a read), beside it
`chain_flt_plain`, the same filter as torch ops.

Known deviation (as in the JAX package): chains with equal weight keep
insertion order in the filter sort (stable); the reference's introsort
is unstable there.

Capacity model: P flat seed-position slots and C chain slots per read;
overflow is flagged per read for the host escalation ladder.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from ..config import AlignConfig
from ..index.reference import DeviceReference
from ..ops import fm as fmops
from ..ops import kernels
from ..ops.fm import DeviceFMIndex
from ..ops.smem import SeedBatch, compact_order

INT32_MAX = 2**31 - 1
_I32 = torch.int32
# chain-table fields the loop returns, in the kernel's output order
LOOP_FIELDS = ("pos", "crid", "fq", "fr", "lq", "lr", "ll", "ns", "wq",
               "wr")
# the kernel's two paths, as its C entry point reports the one it took
# (chosen from C alone, before the launch): pos in registers, or the
# whole table in shared memory for more chain slots than the kernel
# library's fgdp_chain_reg_max_c(); launches of each
KERNEL_PATHS = ("registers", "wide")
PATH_LAUNCHES = {p: 0 for p in KERNEL_PATHS}


class ChainBatch(NamedTuple):
    """Fixed-shape chains + member seeds per read (B lanes)."""

    # flat seeds, in expansion order (qbeg-ascending)
    seed_qbeg: torch.Tensor   # int32[B, P]
    seed_rbeg: torch.Tensor   # int32[B, P]
    seed_len: torch.Tensor    # int32[B, P]
    seed_chain: torch.Tensor  # int32[B, P]  chain slot id, -1 = dropped
    # chain table, in insertion order
    pos: torch.Tensor         # int32[B, C] first-seed rbeg (B-tree key)
    rid: torch.Tensor         # int32[B, C]
    first_q: torch.Tensor     # int32[B, C]
    first_r: torch.Tensor     # int32[B, C]
    last_q: torch.Tensor      # int32[B, C]
    last_r: torch.Tensor      # int32[B, C]
    last_len: torch.Tensor    # int32[B, C]
    n_seeds: torch.Tensor     # int32[B, C]
    weight: torch.Tensor      # int32[B, C] min(query,ref) union coverage
    kept: torch.Tensor        # int32[B, C] 0=dropped 1/2/3 per mem_chain_flt
    n_chains: torch.Tensor    # int32[B]
    frac_rep: torch.Tensor    # float32[B]
    overflow: torch.Tensor    # bool[B] any-stage overflow (seed | chain)
    ovf_seed: torch.Tensor    # bool[B] seed-stage overflow alone
    # flat (read-major) copy of the expanded seeds, [NJ] lanes
    fread: torch.Tensor       # int32[NJ] owning read (non-decreasing)
    fslot: torch.Tensor       # int32[NJ] seed slot within the read
    fqbeg: torch.Tensor       # int32[NJ]
    frbeg: torch.Tensor       # int32[NJ]
    fslen: torch.Tensor       # int32[NJ]
    fon: torch.Tensor         # bool[NJ] lane holds a valid expanded seed


def expand_seeds(dfm: DeviceFMIndex, dref: DeviceReference, smems: SeedBatch,
                 opt: AlignConfig, max_seedpos: int, jobs_cap: int = 0):
    """SA expansion with occurrence-step sampling (bwamem.cpp:1181-1196).

    Returns per-read job arrays (qbeg, rbeg, len, rid, valid) of width
    P = max_seedpos, in smem-then-occurrence order, plus overflow and the
    flat [NJ] job lanes. Jobs are compacted globally (order-preserving)
    before any row gather; reads whose jobs run past NJ flag overflow."""
    B, S = smems.m.shape
    dev = smems.m.device
    P = max_seedpos
    NJ = jobs_cap or B * max(P // 16, 16)
    slot_valid = torch.arange(S, device=dev)[None, :] < smems.count[:, None]
    s = torch.where(slot_valid, smems.s, 0)
    step = torch.where(s > opt.max_occ, s // opt.max_occ, 1).to(_I32)
    # ceil(s / step); s >= 0 here, so -(-s // step) floors like the JAX
    # package's expression
    cnt = torch.where(slot_valid,
                      torch.clamp(-(-s // step.clamp(min=1)),
                                  max=opt.max_occ), 0).to(_I32)
    base = torch.cumsum(cnt, 1, dtype=_I32) - cnt   # exclusive within-read
    total = base[:, -1] + cnt[:, -1]
    overflow = total > P

    # global job layout: slot (b, i) owns job rows [gbase, gbase + cnt)
    fc = cnt.reshape(-1)
    gbase = torch.cumsum(fc, 0, dtype=_I32) - fc              # [B*S]
    l_src, l_on = compact_order(fc > 0, NJ)
    l_src = torch.where(l_on, l_src, 0).long()
    tbl = torch.stack([smems.m, smems.n, smems.k, step, base],
                      dim=-1).reshape(B * S, 5)
    rows_s = tbl[l_src]                           # [<=NJ, 5] slot table
    sgb = torch.where(l_on, gbase[l_src], NJ)
    # job -> owning slot rank: one start marker per slot, prefix-summed
    starts = torch.zeros(NJ + 1, dtype=_I32, device=dev).index_add(
        0, torch.clamp(sgb, max=NJ).long(), l_on.to(_I32))
    owner = (torch.cumsum(starts[:NJ], 0, dtype=_I32) - 1).clamp(
        0, NJ - 1).long()
    # owner indexes the compacted slot table: never past its live rows
    owner = owner.clamp(max=l_src.shape[0] - 1)
    jar = torch.arange(NJ, dtype=_I32, device=dev)
    live = jar < torch.clamp(gbase[-1] + fc[-1], max=NJ)
    ro = rows_s[owner]                            # [NJ, 5]
    occ_idx = jar - sgb[owner]
    qbeg_j, qend_j, k_j, step_j, base_j = ro.unbind(1)
    slen_j = qend_j + 1 - qbeg_j
    sa_row = k_j + occ_idx * step_j
    # k < -1 encodes a direct text position (-k - 2); sa_lookup clamps
    # to the table's global row count, sharded or not
    rbeg_j = torch.where(k_j < -1, -k_j - 2, fmops.sa_lookup(dfm, sa_row))
    read_j = (l_src[owner] // S).to(_I32)
    in_ref = rbeg_j + qend_j - qbeg_j <= 2 * dref.l_pac  # rotation guard
    rid_j = dref.intv2rid(rbeg_j, rbeg_j + slen_j)
    valid_j = live & in_ref & (rid_j >= 0)

    # scatter into the per-read [B, P] layout at t = base + occ_idx
    tslot = base_j + occ_idx
    keep = live & (tslot < P)
    payload = torch.stack([qbeg_j, rbeg_j, slen_j, rid_j,
                           valid_j.to(_I32)], dim=1)
    out = torch.zeros((B + 1, P, 5), dtype=_I32, device=dev)
    out[torch.where(keep, read_j, B).long(),
        torch.where(keep, tslot, 0).long()] = payload
    out = out[:B]
    qbeg, rbeg, slen, rid = (out[..., i] for i in range(4))
    valid = out[..., 4] != 0
    # reads whose jobs run past the global NJ cap lost jobs: flag them
    ovf_nj = (gbase.reshape(B, S)[:, -1] + cnt[:, -1]) > NJ
    flat = dict(read=read_j, slot=torch.where(keep, tslot, 0).to(_I32),
                qbeg=qbeg_j, rbeg=rbeg_j.to(_I32), slen=slen_j,
                on=keep & valid_j)
    return qbeg, rbeg, slen, rid, valid, overflow | ovf_nj, flat


def chain_loop(qbeg, rbeg, slen, rid, valid, overflow, l_pac: int, C: int,
               w: int, max_chain_gap: int):
    """Chain-table construction over every read's seed slots. Returns
    dict pos/crid/fq/fr/lq/lr/ll/ns/wq/wr int32[B, C], n int32[B],
    chain_of int32[B, P], ovf bool[B]. The kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if qbeg.is_cuda:
        return chain_loop_kernel(qbeg, rbeg, slen, rid, valid, overflow,
                                 l_pac, C, w, max_chain_gap)
    return chain_loop_plain(qbeg, rbeg, slen, rid, valid, overflow, l_pac,
                            C, w, max_chain_gap)


def chain_loop_kernel(qbeg, rbeg, slen, rid, valid, overflow, l_pac: int,
                      C: int, w: int, max_chain_gap: int):
    """Launch csrc/chain_loop.cu on CUDA tensors."""
    B, P = qbeg.shape
    dev = qbeg.device
    ins = [a.to(_I32).contiguous() for a in (qbeg, rbeg, slen, rid)]
    vb = valid.to(torch.bool).contiguous()
    ob = overflow.to(torch.bool).contiguous()
    for a in ins + [vb]:
        if not a.is_cuda or a.device != dev or a.shape != (B, P):
            raise ValueError("chain_loop kernel: seed columns must be "
                             f"[{B}, {P}] on {dev}")
    if not ob.is_cuda or ob.device != dev or ob.shape != (B,):
        raise ValueError(f"chain_loop kernel: overflow must be [{B}] on "
                         f"{dev}")
    tbl = torch.empty((len(LOOP_FIELDS), B, C), dtype=_I32, device=dev)
    n = torch.empty(B, dtype=_I32, device=dev)
    ovf = torch.empty(B, dtype=torch.bool, device=dev)
    chain_of = torch.empty((B, P), dtype=_I32, device=dev)
    lib = kernels.load("chain_loop")
    path = ctypes.c_int(-1)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev)
        ev = kernels.event_pair("chain_loop", stream)
        rc = lib.fgdp_chain_loop(
            ins[0].data_ptr(), ins[1].data_ptr(), ins[2].data_ptr(),
            ins[3].data_ptr(), vb.data_ptr(), ob.data_ptr(), B, P, C,
            int(l_pac), int(w), int(max_chain_gap), tbl.data_ptr(),
            n.data_ptr(), ovf.data_ptr(), chain_of.data_ptr(),
            ctypes.addressof(path),
            *kernels.event_ptrs(ev),
            stream.cuda_stream)
    kernels.check(rc, "chain_loop")
    kernels.tally(kernels.LAUNCHES, "chain_loop")
    kernels.tally(PATH_LAUNCHES, KERNEL_PATHS[path.value])
    out = dict(zip(LOOP_FIELDS, tbl.unbind(0)))
    out.update(n=n, chain_of=chain_of, ovf=ovf)
    return out


def chain_loop_plain(qbeg, rbeg, slen, rid, valid, overflow, l_pac: int,
                     C: int, w: int, max_chain_gap: int):
    """The plain version: one step of torch ops per seed slot over all
    reads (the jnp loop of the JAX package's chain_seeds, transcribed)."""
    B, P = qbeg.shape
    dev = qbeg.device
    zC = torch.zeros((B, C), dtype=_I32, device=dev)
    st = {f: zC for f in LOOP_FIELDS + ("qend", "rend")}
    n = torch.zeros(B, dtype=_I32, device=dev)
    ovf = overflow.clone()
    chain_of = torch.full((B, P), -1, dtype=_I32, device=dev)
    carange = torch.arange(C, dtype=_I32, device=dev)[None, :]

    # loop only to the last occupied seed slot in the batch
    occupied = valid.any(dim=0)
    t_max = int(torch.where(occupied, torch.arange(1, P + 1, device=dev),
                            0).max()) if P else 0

    for t in range(t_max):
        v = valid[:, t]
        qb, rb, ln, rd = qbeg[:, t], rbeg[:, t], slen[:, t], rid[:, t]
        have = carange < n[:, None]
        # closest chain with pos <= rb (kb_intervalp lower); tie -> latest
        elig = have & (st["pos"] <= rb[:, None])
        maxpos = torch.where(elig, st["pos"], -1).amax(dim=1)
        tie = elig & (st["pos"] == maxpos[:, None])
        lo = torch.where(tie, carange, 0).amax(dim=1)
        has_lo = elig.any(dim=1)

        oh_lo = carange == lo[:, None]
        g = {f: st[f].gather(1, lo.long()[:, None])[:, 0] for f in st}
        same_rid = g["crid"] == rd
        contained = (qb >= g["fq"]) & (qb + ln <= g["lq"] + g["ll"]) & \
            (rb >= g["fr"]) & (rb + ln <= g["lr"] + g["ll"])
        diff_strand = ((g["lr"] < l_pac) | (g["fr"] < l_pac)) & \
            (rb >= l_pac)
        x = qb - g["lq"]
        y = rb - g["lr"]
        growable = (y >= 0) & (x - y <= w) & (y - x <= w) & \
            (x - g["ll"] < max_chain_gap) & (y - g["ll"] < max_chain_gap)

        merged_contained = v & has_lo & same_rid & contained
        appended = v & has_lo & same_rid & ~contained & ~diff_strand & \
            growable
        new_chain = v & ~(merged_contained | appended)

        # --- append to chain `lo` ---
        app = oh_lo & appended[:, None]

        def upd(f, val):
            return torch.where(app, val[:, None], st[f]).to(_I32)

        # union-coverage increments (mem_chain_weight running ends)
        dq = torch.where(qb >= g["qend"], ln,
                         (qb + ln - g["qend"]).clamp(min=0))
        dr = torch.where(rb >= g["rend"], ln,
                         (rb + ln - g["rend"]).clamp(min=0))
        st2 = dict(st)
        st2["lq"] = upd("lq", qb)
        st2["lr"] = upd("lr", rb)
        st2["ll"] = upd("ll", ln)
        st2["ns"] = upd("ns", g["ns"] + 1)
        st2["wq"] = upd("wq", g["wq"] + dq)
        st2["wr"] = upd("wr", g["wr"] + dr)
        st2["qend"] = upd("qend", torch.maximum(g["qend"], qb + ln))
        st2["rend"] = upd("rend", torch.maximum(g["rend"], rb + ln))

        # --- new chain in slot n ---
        room = n < C
        slot = torch.where(new_chain & room, n, C)
        oh_slot = carange == slot[:, None]
        new_vals = dict(pos=rb, crid=rd, fq=qb, fr=rb, lq=qb, lr=rb, ll=ln,
                        ns=torch.ones_like(ln), wq=ln, wr=ln, qend=qb + ln,
                        rend=rb + ln)
        for f, val in new_vals.items():
            st2[f] = torch.where(oh_slot, val[:, None], st2[f]).to(_I32)
        ovf = ovf | (new_chain & ~room)
        cid = torch.where(appended | merged_contained, lo,
                          torch.where(new_chain & (slot < C), slot, -1))
        cid = torch.where(merged_contained, -1, cid)   # contained: dropped
        chain_of[:, t] = torch.where(v, cid, -1)
        n = n + (new_chain & room).to(_I32)
        st = st2

    out = {f: st[f] for f in LOOP_FIELDS}
    out.update(n=n, chain_of=chain_of, ovf=ovf)
    return out


def frac_rep(smems: SeedBatch, lens, opt: AlignConfig):
    """float32[B]: the share of each read covered by the union of its
    high-occurrence smem spans (m-ascending order)."""
    B, S = smems.m.shape
    dev = smems.m.device
    slot_valid = torch.arange(S, device=dev)[None, :] < smems.count[:, None]
    qual = slot_valid & (smems.s > opt.max_occ)
    se = torch.where(qual, smems.n + 1, 0)
    sb = torch.where(qual, smems.m, 0)
    run_e = torch.cummax(torch.where(qual, se, -1), dim=1).values
    prev_e = torch.cat([torch.zeros((B, 1), dtype=run_e.dtype, device=dev),
                        run_e[:, :-1]], dim=1).clamp(min=0)
    contrib = torch.where(qual, (se - torch.maximum(sb, prev_e)).clamp(min=0),
                          0)
    l_rep = contrib.sum(dim=1)
    return l_rep.to(torch.float32) / lens.clamp(min=1).to(torch.float32)


def chain_weight(st):
    """int32[B, C]: each chain's weight, min(wq, wr) capped below 2^30."""
    return torch.clamp(torch.minimum(st["wq"], st["wr"]), max=(1 << 30) - 1)


def chain_seeds(dfm: DeviceFMIndex, dref: DeviceReference, smems: SeedBatch,
                lens, opt: AlignConfig, max_seedpos: int,
                max_chains: int, jobs_cap: int = 0) -> ChainBatch:
    P, C = max_seedpos, max_chains
    frac = frac_rep(smems, lens, opt)
    qbeg, rbeg, slen, rid, valid, overflow, flat = expand_seeds(
        dfm, dref, smems, opt, P, jobs_cap=jobs_cap)

    st = chain_loop(qbeg, rbeg, slen, rid, valid, overflow, dref.l_pac, C,
                    opt.w, opt.max_chain_gap)
    weight = chain_weight(st)
    kept = chain_flt(st, weight, dref, opt, C)
    return ChainBatch(
        seed_qbeg=qbeg, seed_rbeg=rbeg, seed_len=slen,
        seed_chain=st["chain_of"],
        pos=st["pos"], rid=st["crid"], first_q=st["fq"], first_r=st["fr"],
        last_q=st["lq"], last_r=st["lr"], last_len=st["ll"],
        n_seeds=st["ns"], weight=weight, kept=kept, n_chains=st["n"],
        frac_rep=frac, overflow=st["ovf"] | smems.overflow,
        ovf_seed=smems.overflow,
        fread=flat["read"], fslot=flat["slot"], fqbeg=flat["qbeg"],
        frbeg=flat["rbeg"], fslen=flat["slen"], fon=flat["on"],
    )


# the chain-table fields the filter reads besides the weight
FLT_FIELDS = ("n", "pos", "crid", "fq", "lq", "ll")


def chain_flt(st, weight, dref: DeviceReference, opt: AlignConfig, C: int):
    """mem_chain_flt over every read's chain table (`st`: chain_loop's
    output, `weight`: chain_weight(st)). Returns the kept flags
    (0/1/2/3) int32[B, C] in insertion order. The kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if weight.is_cuda:
        return chain_flt_kernel(st, weight, dref, opt, C)
    return chain_flt_plain(st, weight, dref, opt, C)


def chain_flt_kernel(st, weight, dref: DeviceReference, opt: AlignConfig,
                     C: int):
    """Launch csrc/chain_flt.cu on CUDA tensors: one launch, no host
    sync. weight must lie in [0, 2^30) (chain_weight's). Raises when the
    launch fails, and without launching for a C whose table one block's
    shared memory cannot hold (40 bytes a chain slot: C above
    fgdp_chain_flt_max_c(), 5,811 on an H100)."""
    B = weight.shape[0]
    dev = weight.device
    cols = [kernels.tensor_arg(st[f], dev, _I32, f"chain_flt {f}")
            for f in FLT_FIELDS] + \
        [kernels.tensor_arg(weight, dev, _I32, "chain_flt weight")]
    if cols[0].shape != (B,) or any(a.shape != (B, C) for a in cols[1:]):
        raise ValueError(f"chain_flt kernel: n must be [{B}] and the table "
                         f"columns [{B}, {C}]")
    is_alt = kernels.tensor_arg(dref.is_alt, dev, torch.bool,
                                "chain_flt is_alt")
    lib = kernels.load("chain_flt")
    kept = torch.empty((B, C), dtype=_I32, device=dev)
    kernels.launch("chain_flt", lib.fgdp_chain_flt,
                   *(a.data_ptr() for a in cols), is_alt.data_ptr(),
                   dref.n_contigs, B, C, opt.min_chain_weight,
                   opt.min_seed_len, opt.max_chain_gap, opt.max_chain_extend,
                   opt.mask_level, opt.drop_ratio, kept.data_ptr(),
                   device=dev)
    return kept


def chain_flt_plain(st, weight, dref: DeviceReference, opt: AlignConfig,
                    C: int):
    """The plain version: mem_chain_flt transcription over the fixed
    chain table, a step of torch ops per filter rank up to the batch's
    largest rank count (the JAX package's _chain_flt, transcribed).

    Operates in weight-sorted order via an index permutation; returns
    kept flags (0/1/2/3) aligned to the insertion-order chain table."""
    B = weight.shape[0]
    dev = weight.device
    bidx = torch.arange(B, device=dev)
    carange = torch.arange(C, dtype=_I32, device=dev)[None, :]
    have = carange < st["n"][:, None]
    big_enough = have & (weight >= opt.min_chain_weight)

    # traversal order is pos-ascending (B-tree); then by weight,
    # ties keeping pos order (stable sorts)
    posord = torch.sort(torch.where(have, st["pos"], INT32_MAX), dim=1,
                        stable=True).indices
    alt = torch.cat([dref.is_alt, torch.zeros(1, dtype=torch.bool,
                                              device=dev)])[
        st["crid"].clamp(0, dref.n_contigs).long()].to(_I32)
    tbl = torch.stack([weight, big_enough.to(_I32), st["fq"],
                       st["lq"] + st["ll"], alt], dim=-1).reshape(B * C, 5)
    flat_p = bidx[:, None] * C + posord
    rows_p = tbl[flat_p.reshape(-1)].reshape(B, C, 5)
    w_p, big_p = rows_p[..., 0], rows_p[..., 1] != 0
    ordkey = torch.where(big_p, -w_p, INT32_MAX)
    order2 = torch.sort(ordkey, dim=1, stable=True).indices
    flat_o = flat_p.gather(1, order2)              # composed permutation
    order = flat_o - bidx[:, None] * C
    n_f = big_enough.sum(dim=1, dtype=_I32)

    rows_o = tbl[flat_o.reshape(-1)].reshape(B, C, 5)
    w_s = rows_o[..., 0]
    beg_s = rows_o[..., 2]
    end_s = rows_o[..., 3]
    alt_s = rows_o[..., 4]
    li_s = end_s - beg_s

    kept = torch.zeros((B, C), dtype=_I32, device=dev)
    kept[:, 0] = torch.where(n_f > 0, 3, 0)
    first = torch.full((B, C), -1, dtype=_I32, device=dev)
    w_f = w_s.to(torch.float32)

    # loop only over occupied filter ranks (batch max)
    n_hi = min(int(n_f.max()) if B else 0, C)
    for i in range(1, n_hi):
        on = i < n_f
        in_kept = kept > 0
        b_max = torch.maximum(beg_s, beg_s[:, i:i + 1])
        e_min = torch.minimum(end_s, end_s[:, i:i + 1])
        min_l = torch.minimum(li_s, li_s[:, i:i + 1])
        sig = in_kept & (carange < i) & (e_min > b_max) & \
            ((alt_s == 0) | (alt_s[:, i:i + 1] == 1)) & \
            ((e_min - b_max).to(torch.float32) >=
             min_l.to(torch.float32) * opt.mask_level) & \
            (min_l < opt.max_chain_gap)
        trig = sig & (w_f[:, i:i + 1] < w_f * opt.drop_ratio) & \
            (w_s - w_s[:, i:i + 1] >= opt.min_seed_len * 2)
        any_trig = trig.any(dim=1)
        first_trig = torch.where(trig, carange, C).amin(dim=1)
        # `first` assignment: sig chains scanned before (incl.) the trigger
        eligible = sig & (carange <= first_trig[:, None]) & (first == -1)
        first = torch.where(on[:, None] & eligible, i, first)
        large = sig.any(dim=1)
        ki = torch.where(any_trig, 0, torch.where(large, 2, 3))
        kept[:, i] = torch.where(on, ki, kept[:, i])

    # shadow marking: kept chains' `first` targets get kept=1
    is_kept = kept > 0
    tgt = torch.where(is_kept & (first >= 0), first, C).long()
    mark = torch.zeros((B, C + 1), dtype=torch.bool, device=dev)
    mark[bidx[:, None].expand(B, C), tgt] = True
    kept = torch.where(mark[:, :C], 1, kept)

    # max_chain_extend cap over kept in {1,2} in sorted order
    is12 = (kept == 1) | (kept == 2)
    csum = torch.cumsum(is12.to(_I32), dim=1, dtype=_I32)
    hit = is12 & (csum >= opt.max_chain_extend)
    cutpos = torch.where(hit, carange, C).amin(dim=1)
    kept = torch.where((carange >= cutpos[:, None]) & (kept < 3), 0, kept)

    # scatter kept flags back to insertion order
    kept_ins = torch.zeros((B, C), dtype=_I32, device=dev)
    kept_ins.scatter_(1, order, kept.to(_I32))
    return kept_ins
