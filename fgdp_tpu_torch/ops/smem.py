"""Batched SMEM seeding: the wave machine, the K3 seed-strategy machine
and the seed buffers they share (torch).

Port of the JAX package's ops/smem.py. The reference computes SMEMs one
read at a time with data-dependent loops and early exits
(FMI_search::getSMEMsOnePosOneThread / getSMEMsAllPosOneThread /
bwtSeedStrategyAllPosOneThread, reference
ext/TAL/src/FMI/FMI_search.cpp:1170-1488). Here the same per-read state
machine runs on every lane of a batch at once: each JAX `while_loop`
becomes a Python loop of batched tensor steps whose exit test reads the
lanes' state on the host before every step, so every loop stops where
the JAX package's stops (its step caps are host counters here). Only
K3 tests every 8 steps: its body is a no-op for finished lanes, so the
extra steps change nothing. On the card K3 is one launch of the
hand-written kernel csrc/seed_strategy.cu (D4, one thread a read running
its own steps); `seed_strategy` takes it for CUDA tensors with a whole FM
table, and the plain loop for CPU tensors and ShardedRows tables.

The wave machine (smem_all_pos, smem_one_pos_lanes) is the fallback K1
and K2 engine (align/seeding.py `use_sweep=False`) and the reference the
sweep (ops/smem_sweep.py) is held against.

Seed output layout (fixed shape, per read): (start m, end n inclusive,
SA-interval k, interval size s) + per-read count. Overflow beyond the
buffer capacity is dropped and flagged, exactly as in the JAX package.
Seeds resolved by a single-suffix text compare carry the direct
position encoding k = -pos - 2 (consumers treat k < -1 as a position).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import fm as fmops
from . import kernels
from .fm import DeviceFMIndex
from ..index.reference import packed_window

_I32 = torch.int32


class SeedBatch(NamedTuple):
    """Fixed-shape per-read seed buffers."""

    m: torch.Tensor        # int32[B, S] query start
    n: torch.Tensor        # int32[B, S] query end (inclusive)
    k: torch.Tensor        # int32[B, S] SA interval start
    s: torch.Tensor        # int32[B, S] SA interval size
    count: torch.Tensor    # int32[B]
    overflow: torch.Tensor  # bool[B]


class LaneSeeds(NamedTuple):
    """Per-lane emission buffers (one lane per job)."""

    m: torch.Tensor        # int32[NL, SA]
    n: torch.Tensor
    k: torch.Tensor
    s: torch.Tensor
    count: torch.Tensor    # int32[NL]
    overflow: torch.Tensor  # bool[NL]


def _empty_seeds(B, S, device):
    z = torch.zeros((B, S), dtype=_I32, device=device)
    return SeedBatch(m=z, n=z, k=z, s=z,
                     count=torch.zeros(B, dtype=_I32, device=device),
                     overflow=torch.zeros(B, dtype=torch.bool,
                                          device=device))


def put_at(dst, col, val, mask):
    """dst[r, col[r]] = val[r] where mask[r] (out-of-place). Lanes whose
    mask is off keep their value; col is clamped into the row, so a lane
    that is masked off never needs a valid column."""
    c = col.clamp(0, dst.shape[1] - 1).long()[:, None]
    old = dst.gather(1, c)
    return dst.scatter(1, c, torch.where(mask[:, None], val[:, None], old))


def _append_seed(seeds, mask, m, n, k, s):
    """Masked per-lane append into SeedBatch or LaneSeeds buffers: the
    value lands at slot `count` when it is below the capacity; a full
    buffer flags overflow and drops the value."""
    S = seeds.m.shape[1]
    can = mask & (seeds.count < S)
    cnt = seeds.count
    return type(seeds)(
        m=put_at(seeds.m, cnt, m, can),
        n=put_at(seeds.n, cnt, n, can),
        k=put_at(seeds.k, cnt, k, can),
        s=put_at(seeds.s, cnt, s, can),
        count=cnt + can.to(_I32),
        overflow=seeds.overflow | (mask & (cnt >= S)),
    )


def any_by(idx, flag, n: int):
    """out[i] = any(flag[idx == i]) for i < n; entries with idx outside
    [0, n) are dropped (the JAX package's .at[].max(mode="drop"))."""
    idx = idx.long()
    on = flag & (idx >= 0) & (idx < n)
    hits = torch.zeros(n + 1, dtype=_I32, device=flag.device).index_add(
        0, torch.where(on, idx, n), on.to(_I32))
    return hits[:n] > 0


def _read_base(codes, j):
    """codes[b, j_b] with out-of-range -> 4 (ambiguous sentinel)."""
    B, L = codes.shape
    jj = j.clamp(0, L - 1).long()[:, None]
    a = codes.gather(1, jj)[:, 0].to(_I32)
    return torch.where((j >= 0) & (j < L), a, 4)


def merge_lane_seeds(lanes: LaneSeeds, lane_read, lane_order, lane_valid,
                     B: int, max_seeds: int,
                     into: SeedBatch | None = None) -> SeedBatch:
    """Concatenate per-lane emissions into per-read SeedBatch buffers.
    PRECONDITION: lanes arrive segment-contiguous and already sorted by
    (read, desired order); lane_order is accepted for call-site
    documentation only. Reproduces the sequential matchArray append
    order. lane_read/lane_order int32[NL]."""
    NL, SA = lanes.m.shape
    S = max_seeds
    dev = lanes.m.device
    cnt = torch.where(lane_valid, lanes.count, 0)
    seg_start = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                           lane_read[1:] != lane_read[:-1]])
    csum = torch.cumsum(cnt, 0, dtype=_I32)
    seg_base = torch.where(seg_start, csum - cnt, 0)
    seg_base = torch.cummax(seg_base, 0).values
    lane_base = csum - cnt - seg_base            # offset within the read
    lr = lane_read.long()
    if into is not None:
        lane_base = lane_base + into.count[lr]

    ar = torch.arange(SA, dtype=_I32, device=dev)[None, :]
    valid = lane_valid[:, None] & (ar < cnt[:, None])
    tgt = lane_base[:, None] + ar
    ovf_lane = (valid & (tgt >= S)).any(dim=1)
    tgt = torch.where(valid & (tgt < S), tgt, S).long()
    rexp = lr[:, None].expand(NL, SA)

    if into is None:
        into = _empty_seeds(B, S, dev)

    def scat(dst, src):
        # column S is the drop slot (the JAX package's mode="drop")
        pad = torch.cat([dst, torch.zeros((B, 1), dtype=_I32, device=dev)],
                        dim=1)
        pad[rexp, tgt] = src
        return pad[:, :S]

    new_count = torch.zeros(B, dtype=_I32, device=dev).index_add(
        0, lr, cnt) + into.count
    ovf = any_by(lr, ovf_lane | (lane_valid & lanes.overflow), B)
    return SeedBatch(
        m=scat(into.m, lanes.m), n=scat(into.n, lanes.n),
        k=scat(into.k, lanes.k), s=scat(into.s, lanes.s),
        count=torch.clamp(new_count, max=S),
        overflow=into.overflow | ovf | (new_count > S),
    )


def _read_base_at(codes, rid, j):
    """codes[rid, j] with out-of-range j -> 4; rid/j int32[NL]."""
    B, L = codes.shape
    jj = j.clamp(0, L - 1).long()
    a = codes[rid.long(), jj].to(_I32)
    return torch.where((j >= 0) & (j < L), a, 4)


def first_true(mask):
    """Index of the first set entry of each row of a bool[N, T] (0 for a
    row with none, as jnp.argmax gives)."""
    return mask.to(torch.uint8).argmax(dim=1).to(_I32)


def compact_order(flags, cap: int):
    """Order-preserving compaction of a flat bool mask: the first `cap`
    set positions in ascending order, padded with len(flags). Returns
    (src int32[min(cap, n)], on bool[min(cap, n)])."""
    n = flags.shape[0]
    key = torch.where(flags, torch.arange(n, dtype=_I32,
                                          device=flags.device), n)
    src = torch.sort(key).values[:cap]
    return src, src < n


def _empty_lanes(NL, SA, device):
    return LaneSeeds(*_empty_seeds(NL, SA, device))


def _prev_push(pm, pn, pk, ps, num_prev, push, P, m, n, k, s):
    """Masked push of (m, n, k, s) onto each lane's prev stack. Returns
    the updated arrays + num_prev. The RC-interval bound l is not
    stacked: the backward phase only ever extends backward."""
    can = push & (num_prev < P)
    return (put_at(pm, num_prev, m, can), put_at(pn, num_prev, n, can),
            put_at(pk, num_prev, k, can), put_at(ps, num_prev, s, can),
            torch.clamp(num_prev + push.to(_I32), max=P))


def _text_base(ref_codes, l_pac, p):
    """Char at position p of the FM text (fwd reference + revcomp;
    sentinel / out of range -> 4)."""
    fwd = p < l_pac
    idx = torch.where(fwd, p, 2 * l_pac - 1 - p)
    c = ref_codes[idx.clamp(0, l_pac - 1).long()].to(_I32)
    c = torch.where(fwd, c, 3 - c)
    return torch.where((p >= 0) & (p < 2 * l_pac), c, 4)


def _text_window(ref_codes, ref_codes16, l_pac, start, T: int,
                 reverse: bool = False):
    """Contiguous text window [NL, T]: packed-word fetch when the caller
    supplies the packed doubled-space words, else elementwise
    _text_base."""
    if ref_codes16 is not None:
        return packed_window(ref_codes16, 2 * l_pac, start, T, reverse)
    tgrid = torch.arange(T, dtype=_I32, device=start.device)[None, :]
    tp = start[:, None] + ((T - 1) - tgrid if reverse else tgrid)
    return _text_base(ref_codes, l_pac, tp)


def _fwd_phase(fm: DeviceFMIndex, ref_codes, l_pac, L, x, lens_l,
               min_intv, read_base, read_grid, started, P,
               two_step: bool = True, ref_codes16=None):
    """Forward phase of getSMEMsOnePosOneThread (FMI_search.cpp:1201-1260)
    over independent lanes, with the single-suffix fast path: a lane
    whose interval narrows to s == 1 pauses, and its remaining extension
    is resolved afterwards by one SA lookup + a text compare.

    read_base(j) -> int32[NL]; read_grid(jt int32[NL, T]) -> int32[NL, T]
    (both with 4 = out-of-buffer/ambiguous). Returns dict(pm, pn, pk, ps,
    num_prev, povf, next_x) with prev reversed (longest match first).
    """
    NL = x.shape[0]
    dev = x.device
    k, l, s0 = fmops.init_interval(fm, read_base(x))
    s = torch.where(started, s0, 0)
    pm = pn = pk = ps = torch.zeros((NL, P), dtype=_I32, device=dev)
    num_prev = torch.zeros(NL, dtype=_I32, device=dev)
    n = x
    next_x = x + 1
    alive = started
    povf = torch.zeros(NL, dtype=torch.bool, device=dev)

    t = 0
    while t < L and bool((alive & (s > 1)).any()):
        stepping = alive & (s > 1)
        if not two_step:
            j = x + 1 + t
            in_range = stepping & (j < lens_l)
            a = read_base(j)
            ext = in_range & (a < 4)
            nk, nl, ns = fmops.forward_extend(fm, k, l, s, a)
            push = ext & (ns != s)
            povf = povf | (push & (num_prev >= P))
            pm, pn, pk, ps, num_prev = _prev_push(
                pm, pn, pk, ps, num_prev, push, P, x, n, k, s)
            die = ext & (ns < min_intv)
            take = ext & ~die
            next_x = torch.where(in_range, j + 1, next_x)
            next_x = torch.where(die, j, next_x)
            k = torch.where(take, nk, k)
            l = torch.where(take, nl, l)
            s = torch.where(take, ns, s)
            n = torch.where(take, j, n)
            alive = torch.where(stepping, take, alive)
            t += 1
            continue
        # two-step ("lambert") extension: chars j0, j1 resolve from the
        # same two checkpoint gathers; the two sub-steps replay exactly
        j0 = x + 1 + t
        j1 = j0 + 1
        a0 = read_base(j0)
        a1 = read_base(j1)
        (k1, l1, s1), (k2, l2, s2) = fmops.forward_extend2(
            fm, k, l, s, a0, a1)
        # ---- sub-step 0: char a0 at j0 ----
        in_range0 = stepping & (j0 < lens_l)
        ext0 = in_range0 & (a0 < 4)
        push0 = ext0 & (s1 != s)
        povf = povf | (push0 & (num_prev >= P))
        pm, pn, pk, ps, num_prev = _prev_push(
            pm, pn, pk, ps, num_prev, push0, P, x, n, k, s)
        die0 = ext0 & (s1 < min_intv)
        take0 = ext0 & ~die0
        next_x = torch.where(in_range0, j0 + 1, next_x)
        next_x = torch.where(die0, j0, next_x)
        kA = torch.where(take0, k1, k)
        lA = torch.where(take0, l1, l)
        sA = torch.where(take0, s1, s)
        nA = torch.where(take0, j0, n)
        aliveA = torch.where(stepping, take0, alive)
        # ---- sub-step 1: char a1 at j1 (only lanes that took a0) ----
        in_range1 = take0 & (j1 < lens_l)
        ext1 = in_range1 & (a1 < 4)
        push1 = ext1 & (s2 != sA)
        povf = povf | (push1 & (num_prev >= P))
        pm, pn, pk, ps, num_prev = _prev_push(
            pm, pn, pk, ps, num_prev, push1, P, x, nA, kA, sA)
        die1 = ext1 & (s2 < min_intv)
        take1 = ext1 & ~die1
        next_x = torch.where(in_range1, j1 + 1, next_x)
        next_x = torch.where(die1, j1, next_x)
        k = torch.where(take1, k2, kA)
        l = torch.where(take1, l2, lA)
        s = torch.where(take1, s2, sA)
        n = torch.where(take1, j1, nA)
        alive = torch.where(take0, take1, aliveA)
        t += 2

    # ---- fast-path epilogue: resolve paused single-suffix lanes ----
    paused = alive & (s == 1) & started
    pos = fmops.sa_lookup(fm, k)
    depth = n - x + 1
    tgrid = torch.arange(L, dtype=_I32, device=dev)[None, :]
    jt = (n + 1)[:, None] + tgrid
    rb = read_grid(jt)
    rb = torch.where(jt < lens_l[:, None], rb, 4)
    tb = _text_window(ref_codes, ref_codes16, l_pac, pos + depth, L)
    ok = (rb == tb) & (rb < 4) & (tb < 4)
    stop_t = first_true(~ok)
    n_new = n + stop_t
    jd = n_new + 1
    rb_stop = rb.gather(1, stop_t.long()[:, None])[:, 0]
    is_end = jd >= lens_l                 # ran off the read
    is_amb = ~is_end & (rb_stop >= 4)     # ambiguous read base: no push
    nx_fast = torch.where(is_end, lens_l,
                          torch.where(is_amb, jd + 1, jd))
    n_fin = torch.where(paused, n_new, n)
    next_x = torch.where(paused, nx_fast, next_x)
    # interval-death push (mismatch): pre-state (x, n, k, s=1), exactly
    # the in-loop push the paused lane would have made
    push_c = paused & ~is_end & ~is_amb
    povf = povf | (push_c & (num_prev >= P))
    pm, pn, pk, ps, num_prev = _prev_push(
        pm, pn, pk, ps, num_prev, push_c, P, x, n_fin, k, s)
    # final push of the last interval (FMI_search.cpp:1249-1254)
    push = started & (s >= min_intv)
    pm, pn, pk, ps, num_prev = _prev_push(
        pm, pn, pk, ps, num_prev, push, P, x, n_fin, k, s)

    # reverse prev so longest matches (smallest intervals) come first
    ridx = (num_prev[:, None] - 1
            - torch.arange(P, dtype=_I32, device=dev)[None, :]) \
        .clamp(0, P - 1).long()
    rev = lambda a: a.gather(1, ridx)
    return dict(pm=rev(pm), pn=rev(pn), pk=rev(pk), ps=rev(ps),
                num_prev=num_prev, povf=povf, next_x=next_x)


# --------------------------------------------------------------------------
# Shared backward-phase engine (pyramid widths)
# --------------------------------------------------------------------------
#
# The prev stack starts deep but collapses within a few backward steps,
# so the backward loop runs as a pyramid: full width until every live
# lane's stack fits the next width, then the arrays are sliced and a
# narrower loop continues. Results are bit-identical to one full-width
# loop.

_BWD_TIERS = (8, 3)


def _bwd_eligible(st, min_intv):
    """Lanes whose stack collapsed to one single-suffix entry: all
    remaining backward steps are a text comparison."""
    return st["alive"] & (st["num_prev"] == 1) & \
        (st["ps"][:, 0] == 1) & (min_intv == 1)


def _bwd_pyramid(fm: DeviceFMIndex, ref_codes, l_pac, L, x, min_intv,
                 min_seed_len, read_base, read_grid, st, emit,
                 prev_cap: int, two_step: bool = True, ref_codes16=None):
    """Run the backward phase of getSMEMsOnePosOneThread
    (FMI_search.cpp:1262-1339) over independent lanes.

    st: dict(t, num_prev, pm, pn, pk, ps, alive, seeds) with t a host
    int; emit(seeds, mask, m, n, k, s) -> seeds. Returns the final st.
    Lanes whose stack collapses to a single s == 1 entry leave the loop
    and finish by direct text comparison; their seed carries the text
    position as k = -pos - 2.
    """
    NL = st["num_prev"].shape[0]
    dev = st["num_prev"].device

    def make_body(P):
        parange = torch.arange(P, dtype=_I32, device=dev)[None, :]
        neg = torch.full((NL, 1), -1, dtype=_I32, device=dev)
        shift = lambda v: torch.cat([neg, v[:, :-1]], dim=1)

        def emit_round(seeds, proc, cand, die_ok, em_m, em_n, em_k, em_s):
            """Emission for one backward char: the first entry that
            either survives or dies-with-output decides it."""
            has_cand = cand.any(dim=1)
            pstar = first_true(cand).long()[:, None]
            pstar_die = die_ok.gather(1, pstar)[:, 0]
            do_emit = proc & has_cand & pstar_die
            take1 = lambda v: v.gather(1, pstar)[:, 0]
            return emit(seeds, do_emit, take1(em_m), take1(em_n),
                        take1(em_k), take1(em_s))

        def firsts(v):
            return v & (torch.cumsum(v.to(_I32), dim=1) == 1)

        def compact(keep, *srcs):
            perm = torch.argsort(torch.where(keep, parange, P + parange),
                                 dim=1)
            return [a.gather(1, perm) for a in srcs]

        def body_1step(st):
            j = x - 1 - st["t"]
            stepping = st["alive"] & ~_bwd_eligible(st, min_intv)
            in_range = stepping & (j >= 0)
            a = read_base(j)
            proc = in_range & (a < 4)
            c = a[:, None].expand(NL, P)
            nk, _, ns = fmops.backward_extend(
                fm, st["pk"], st["ps"], st["ps"], c)   # l input is dead
            validp = parange < st["num_prev"][:, None]
            survive = validp & (ns >= min_intv[:, None])
            plen = st["pn"] - st["pm"] + 1
            die_ok = validp & ~survive & (plen >= min_seed_len)
            seeds2 = emit_round(st["seeds"], proc, survive | die_ok,
                                die_ok, st["pm"], st["pn"], st["pk"],
                                st["ps"])
            keep = survive & (firsts(survive) | (ns != shift(ns)))
            pn_c, nk_c, ns_c = compact(keep, st["pn"], nk, ns)
            ncount = keep.sum(dim=1, dtype=_I32)
            sel = lambda new, old: torch.where(proc[:, None], new, old)
            return dict(
                t=st["t"] + 1,
                num_prev=torch.where(proc, ncount, st["num_prev"]),
                pm=sel(j[:, None].expand(NL, P), st["pm"]),
                pn=sel(pn_c, st["pn"]), pk=sel(nk_c, st["pk"]),
                ps=sel(ns_c, st["ps"]),
                alive=torch.where(stepping, proc & (ncount > 0),
                                  st["alive"]),
                seeds=seeds2)

        if not two_step:
            return body_1step

        def body(st):
            # two backward chars per gather pair: prepend q[j], then
            # q[j-1] (backward_extend2). Both rounds run on the
            # uncompacted entry axis (sizes are monotone along the nested
            # stack, so adjacent-slot dedup is exact); one compaction per
            # pair of chars
            j = x - 1 - st["t"]
            stepping = st["alive"] & ~_bwd_eligible(st, min_intv)
            in_range = stepping & (j >= 0)
            a = read_base(j)
            b = read_base(j - 1)
            proc0 = in_range & (a < 4)
            nk1, ns1, nk2, ns2 = fmops.backward_extend2(
                fm, st["pk"], st["ps"], a[:, None].expand(NL, P),
                b[:, None].expand(NL, P))

            # ---- round 1: char a at j ----
            validp = parange < st["num_prev"][:, None]
            survive1 = validp & (ns1 >= min_intv[:, None])
            plen = st["pn"] - st["pm"] + 1
            die_ok1 = validp & ~survive1 & (plen >= min_seed_len)
            seeds2 = emit_round(st["seeds"], proc0, survive1 | die_ok1,
                                die_ok1, st["pm"], st["pn"], st["pk"],
                                st["ps"])
            keep1 = survive1 & (firsts(survive1) | (ns1 != shift(ns1)))
            ncount1 = keep1.sum(dim=1, dtype=_I32)
            alive0 = torch.where(stepping, proc0 & (ncount1 > 0),
                                 st["alive"])

            # ---- round 2: char b at j-1, on round-1 keepers ----
            proc1 = alive0 & stepping & (j - 1 >= 0) & (b < 4)
            survive2 = keep1 & (ns2 >= min_intv[:, None])
            plen2 = st["pn"] - j[:, None] + 1   # pm after round 1 is j
            die_ok2 = keep1 & ~survive2 & (plen2 >= min_seed_len)
            seeds2 = emit_round(seeds2, proc1, survive2 | die_ok2,
                                die_ok2, j[:, None].expand(NL, P),
                                st["pn"], nk1, ns1)
            keep2 = survive2 & (firsts(survive2) | (ns2 != shift(ns2)))
            ncount2 = keep2.sum(dim=1, dtype=_I32)
            # an ambiguous second char kills the lane (the one-step body
            # and the reference break on N)
            amb_kill = alive0 & stepping & (j - 1 >= 0) & (b >= 4)
            alive1 = torch.where(proc1, ncount2 > 0, alive0 & ~amb_kill)

            # ---- one compaction for both rounds ----
            two = proc1[:, None]
            keepF = torch.where(two, keep2, keep1)
            pn_c, pk_c, ps_c = compact(keepF, st["pn"],
                                       torch.where(two, nk2, nk1),
                                       torch.where(two, ns2, ns1))
            pmF = torch.where(proc1, j - 1, j)
            ncountF = torch.where(proc1, ncount2, ncount1)
            sel = lambda new, old: torch.where(proc0[:, None], new, old)
            return dict(
                t=st["t"] + 2,
                num_prev=torch.where(proc0, ncountF, st["num_prev"]),
                pm=sel(pmF[:, None].expand(NL, P), st["pm"]),
                pn=sel(pn_c, st["pn"]), pk=sel(pk_c, st["pk"]),
                ps=sel(ps_c, st["ps"]), alive=alive1, seeds=seeds2)

        return body

    widths = [prev_cap] + [w for w in _BWD_TIERS if w < prev_cap]
    for i, P in enumerate(widths):
        nxt = widths[i + 1] if i + 1 < len(widths) else 0
        body = make_body(P)
        while st["t"] < L:
            active = st["alive"] & ~_bwd_eligible(st, min_intv)
            if nxt:
                go = torch.where(active, st["num_prev"], 0).max() > nxt
            else:
                go = active.any()
            if not bool(go):
                break
            st = body(st)
        if nxt:
            # every live lane's stack now fits in `nxt` entries; dead
            # lanes only ever contribute pm/pn/pk/ps[:, 0] afterwards
            for f in ("pm", "pn", "pk", "ps"):
                st[f] = st[f][:, :nxt]

    # ---- single-suffix epilogue: finish eligible lanes by direct
    # leftward text comparison, one emission each ----
    elig = _bwd_eligible(st, min_intv)
    pm0 = st["pm"][:, 0]
    pn0 = st["pn"][:, 0]
    pos = fmops.sa_lookup(fm, st["pk"][:, 0])
    tgrid = torch.arange(L, dtype=_I32, device=dev)[None, :]
    jt = pm0[:, None] - 1 - tgrid
    rb = read_grid(jt)
    tb = _text_window(ref_codes, ref_codes16, l_pac, pos - L, L,
                      reverse=True)
    ok = (rb == tb) & (rb < 4) & (tb < 4)
    lcp = first_true(~ok)
    pm_new = pm0 - lcp
    do_emit = elig & (pn0 - pm_new + 1 >= min_seed_len)
    k_enc = -(pos - lcp) - 2
    st["seeds"] = emit(st["seeds"], do_emit, pm_new, pn0, k_enc,
                       torch.ones(NL, dtype=_I32, device=dev))
    st["num_prev"] = torch.where(elig, 0, st["num_prev"])
    st["alive"] = st["alive"] & ~elig
    return st


# --------------------------------------------------------------------------
# One-anchor SMEM pass (getSMEMsOnePosOneThread parity)
# --------------------------------------------------------------------------

def _grid_reader(codes):
    """read_grid for lanes that are the rows of `codes`."""
    L = codes.shape[1]

    def read_grid(jt):
        a = codes.gather(1, jt.clamp(0, L - 1).long()).to(_I32)
        return torch.where((jt >= 0) & (jt < L), a, 4)
    return read_grid


def _final_emit(seeds, st, started, min_seed_len, emit):
    """Emission of the surviving prev[0] (FMI_search.cpp:1330-1339)."""
    final = started & (st["num_prev"] > 0)
    fl = st["pn"][:, 0] - st["pm"][:, 0] + 1
    return emit(seeds, final & (fl >= min_seed_len), st["pm"][:, 0],
                st["pn"][:, 0], st["pk"][:, 0], st["ps"][:, 0])


def smem_one_pos(fm: DeviceFMIndex, ref_codes, l_pac, codes, lens, x,
                 min_intv, active, min_seed_len: int, seeds: SeedBatch,
                 prev_cap: int, two_step: bool = True, ref_codes16=None):
    """Run one anchor pass for every active lane.

    codes: int32[B, L]; lens, x, min_intv: int32[B]; active: bool[B];
    ref_codes/l_pac: the forward reference (for the single-suffix fast
    path). Returns (seeds', next_x int32[B]).
    """
    B, L = codes.shape
    a0 = _read_base(codes, x)
    started = active & (a0 < 4) & (x < lens)
    read_base = lambda j: _read_base(codes, j)
    read_grid = _grid_reader(codes)
    fw = _fwd_phase(fm, ref_codes, l_pac, L, x, lens, min_intv, read_base,
                    read_grid, started, prev_cap, two_step=two_step,
                    ref_codes16=ref_codes16)
    bwd0 = dict(t=0, num_prev=fw["num_prev"], pm=fw["pm"], pn=fw["pn"],
                pk=fw["pk"], ps=fw["ps"],
                alive=started & (fw["num_prev"] > 0),
                seeds=seeds._replace(overflow=seeds.overflow | fw["povf"]))
    st = _bwd_pyramid(fm, ref_codes, l_pac, L, x, min_intv, min_seed_len,
                      read_base, read_grid, bwd0, _append_seed, prev_cap,
                      two_step=two_step, ref_codes16=ref_codes16)
    return (_final_emit(st["seeds"], st, started, min_seed_len,
                        _append_seed), fw["next_x"])


# --------------------------------------------------------------------------
# Anchor discovery for all positions + pointer-doubling anchor chain
# --------------------------------------------------------------------------

def anchor_next_x(fm: DeviceFMIndex, codes, lens):
    """next_x(x) for all positions: int32[B, L+1] (entry L = terminator).
    Matches the forward-phase next_x of getSMEMsOnePosOneThread
    (FMI_search.cpp:1170-1260) with min_intv = 1."""
    B, L = codes.shape
    dev = codes.device
    x = torch.arange(L, dtype=_I32, device=dev).repeat(B)
    ridx = torch.arange(B, dtype=_I32, device=dev).repeat_interleave(L)
    lens_l = lens.to(_I32)[ridx.long()]
    a0 = _read_base_at(codes, ridx, x)
    _, l, s0 = fmops.init_interval(fm, a0)
    started = (a0 < 4) & (x < lens_l)
    s = torch.where(started, s0, 0)
    next_x = x + 1
    alive = started
    t = 0
    while t < L and bool(alive.any()):
        # two chars per step from the same gathers (forward_extend2);
        # k is unused by next_x
        j0 = x + 1 + t
        j1 = j0 + 1
        a0 = _read_base_at(codes, ridx, j0)
        a1 = _read_base_at(codes, ridx, j1)
        k0 = torch.zeros_like(s)
        (_, l1, s1), (_, l2, s2) = fmops.forward_extend2(fm, k0, l, s,
                                                         a0, a1)
        in_range0 = alive & (j0 < lens_l)
        ext0 = in_range0 & (a0 < 4)
        die0 = ext0 & (s1 < 1)
        take0 = ext0 & ~die0
        next_x = torch.where(in_range0, j0 + 1, next_x)
        next_x = torch.where(die0, j0, next_x)
        lA = torch.where(take0, l1, l)
        sA = torch.where(take0, s1, s)
        in_range1 = take0 & (j1 < lens_l)
        ext1 = in_range1 & (a1 < 4)
        die1 = ext1 & (s2 < 1)
        take1 = ext1 & ~die1
        next_x = torch.where(in_range1, j1 + 1, next_x)
        next_x = torch.where(die1, j1, next_x)
        l = torch.where(take1, l2, lA)
        s = torch.where(take1, s2, sA)
        alive = take1
        t += 2
    nxt = next_x.reshape(B, L).clamp(0, L)
    return torch.cat([nxt, torch.full((B, 1), L, dtype=_I32, device=dev)],
                     dim=1)


def anchor_chain(nxt, lens, B, L):
    """Mark positions on the chain x0 = 0, x_{k+1} = nxt[x_k] by pointer
    doubling; also caps at per-read length. Returns bool[B, L]."""
    dev = nxt.device
    term = torch.clamp(lens.to(_I32), max=L)[:, None]
    ptr = torch.where(nxt >= term, L, nxt).to(_I32)  # terminator slot L
    visited = torch.zeros((B, L + 1), dtype=torch.uint8, device=dev)
    visited[:, 0] = 1
    ptr = torch.cat([ptr, torch.full((B, 1), L, dtype=_I32, device=dev)],
                    dim=1)
    steps = max(1, (max(L, 2) - 1).bit_length()) + 1   # ceil(log2 L) + 1
    for _ in range(steps):
        tgt = torch.where(visited > 0, ptr[:, :L + 1], L).long()
        visited = visited.scatter_reduce(1, tgt, visited, reduce="amax")
        ptr = ptr.gather(1, torch.clamp(ptr, max=L).long())
    pos_ok = torch.arange(L, device=dev)[None, :] < lens[:, None]
    return (visited[:, :L] > 0) & pos_ok


def smem_one_pos_lanes(fm: DeviceFMIndex, ref_codes, l_pac, codes, lens,
                       ridx, x, min_intv, active, min_seed_len: int,
                       prev_cap: int, max_out: int,
                       two_step: bool = True,
                       into: LaneSeeds | None = None, ref_codes16=None):
    """getSMEMsOnePosOneThread over NL independent (read, anchor) lanes.
    codes int32[B, L]; ridx/x/min_intv int32[NL]; active bool[NL].
    Emissions land in per-lane buffers in machine order (appended to
    `into` when given). Returns (LaneSeeds, next_x int32[NL])."""
    NL = ridx.shape[0]
    B, L = codes.shape
    lens_l = lens.to(_I32)[ridx.long()]
    a0 = _read_base_at(codes, ridx, x)
    started = active & (a0 < 4) & (x < lens_l)
    read_base = lambda j: _read_base_at(codes, ridx, j)
    read_grid = _grid_reader(codes[ridx.long()])
    fw = _fwd_phase(fm, ref_codes, l_pac, L, x, lens_l, min_intv,
                    read_base, read_grid, started, prev_cap,
                    two_step=two_step, ref_codes16=ref_codes16)
    if into is None:
        into = _empty_lanes(NL, max_out, codes.device)
    bwd0 = dict(t=0, num_prev=fw["num_prev"], pm=fw["pm"], pn=fw["pn"],
                pk=fw["pk"], ps=fw["ps"],
                alive=started & (fw["num_prev"] > 0),
                seeds=into._replace(overflow=into.overflow | fw["povf"]))
    st = _bwd_pyramid(fm, ref_codes, l_pac, L, x, min_intv, min_seed_len,
                      read_base, read_grid, bwd0, _append_seed, prev_cap,
                      two_step=two_step, ref_codes16=ref_codes16)
    return (_final_emit(st["seeds"], st, started, min_seed_len,
                        _append_seed), fw["next_x"])


# --------------------------------------------------------------------------
# All-position SMEM driver (getSMEMsAllPosOneThread parity)
# --------------------------------------------------------------------------

def smem_all_pos(fm: DeviceFMIndex, ref_codes, l_pac, codes, lens,
                 min_intv, active, min_seed_len: int, max_seeds: int,
                 prev_cap: int, two_step: bool = True, tail_frac: int = 4,
                 lane_emit_cap: int | None = None,
                 ref_codes16=None) -> SeedBatch:
    """K1: anchor waves sweep left to right until every lane is
    exhausted.

    Straggler tiering: once <= B/tail_frac reads still have anchors,
    the remaining reads compact into a B/tail_frac-wide lane machine
    whose emissions merge back per read (tail_frac=1 disables). Which
    wave hands over decides which reads overflow, so the hand-over is
    tested after every wave, as in the JAX package."""
    B, L = codes.shape
    dev = codes.device
    lens = lens.to(_I32)
    seeds = _empty_seeds(B, max_seeds, dev)
    NT = max(B // tail_frac, 1) if tail_frac > 1 else 0
    # a straggler read gets the same per-read budget as the main loop
    if lane_emit_cap is None:
        lane_emit_cap = max_seeds
    x = torch.zeros(B, dtype=_I32, device=dev)
    live = lambda x: active & (x < lens)

    while int(live(x).sum()) > NT:
        lane_on = live(x)
        seeds, next_x = smem_one_pos(fm, ref_codes, l_pac, codes, lens, x,
                                     min_intv, lane_on, min_seed_len,
                                     seeds, prev_cap, two_step=two_step,
                                     ref_codes16=ref_codes16)
        x = torch.where(lane_on, next_x, x)
    if not NT:
        return seeds

    # ---- tail tier: compact remaining reads into NT lanes ----
    rem = live(x)
    ar = torch.arange(B, dtype=_I32, device=dev)
    ridx = torch.argsort(torch.where(rem, ar, B + ar))[:NT].to(_I32)
    lane_on0 = rem[ridx.long()]
    x_l = x[ridx.long()]
    mi_l = min_intv[ridx.long()]
    lens_l = lens[ridx.long()]
    lanes = _empty_lanes(NT, lane_emit_cap, dev)
    while bool((lane_on0 & (x_l < lens_l)).any()):
        on = lane_on0 & (x_l < lens_l)
        lanes, nx = smem_one_pos_lanes(
            fm, ref_codes, l_pac, codes, lens, ridx, x_l, mi_l, on,
            min_seed_len, prev_cap, lane_emit_cap, two_step=two_step,
            into=lanes, ref_codes16=ref_codes16)
        x_l = torch.where(on, nx, x_l)
    return merge_lane_seeds(lanes, ridx, torch.zeros_like(ridx), lane_on0,
                            B, max_seeds, into=seeds)


# steps between host checks of the K3 loop's live-lane count: the body
# is a no-op for finished lanes, so running a few steps past the last
# live lane leaves the result bit-identical
_K3_CHECK_EVERY = 8


def seed_strategy(fm: DeviceFMIndex, codes, lens, active, max_intv: int,
                  min_seed_len: int, max_seeds: int) -> SeedBatch:
    """bwtSeedStrategyAllPosOneThread (FMI_search.cpp:1400-1488): each
    step is either an anchor restart or a two-char forward extension per
    lane. The JAX package's optional straggler tiering (tail_frac) is
    off on its main path and is not ported."""
    fn = seed_strategy_kernel if codes.is_cuda and \
        not fmops.is_sharded(fm) else seed_strategy_plain
    return fn(fm, codes, lens, active, max_intv, min_seed_len, max_seeds)


def seed_strategy_kernel(fm: DeviceFMIndex, codes, lens, active,
                         max_intv: int, min_seed_len: int,
                         max_seeds: int, work=None) -> SeedBatch:
    """Launch csrc/seed_strategy.cu on CUDA tensors; returns what
    `seed_strategy_plain` returns. `work`, a zeroed int64[4] on the card,
    receives the launch's work counters (csrc/seed_waves.cuh)."""
    B, L = codes.shape
    dev = codes.device
    what = "seed_strategy kernel"
    _keep, fm_args = fmops.kernel_args(fm, dev, what)
    arg = lambda x, dt, n: kernels.tensor_arg(x, dev, dt, f"{what}: {n}")
    codes_c = arg(codes, _I32, "codes")
    lens_c = arg(lens, _I32, "lens")
    act_c = arg(active, torch.bool, "active")
    if lens_c.shape != (B,) or act_c.shape != (B,):
        raise ValueError(f"{what}: lens/active must be [{B}]")
    m, n, k, s = (torch.zeros((B, max_seeds), dtype=_I32, device=dev)
                  for _ in range(4))
    count = torch.empty(B, dtype=_I32, device=dev)
    ovf = torch.empty(B, dtype=torch.bool, device=dev)
    lib = kernels.load("seed_strategy")
    kernels.launch(
        "seed_strategy", lib.fgdp_seed_strategy, *fm_args,
        codes_c.data_ptr(), lens_c.data_ptr(), act_c.data_ptr(), B, L,
        max_intv, min_seed_len, max_seeds, m.data_ptr(), n.data_ptr(),
        k.data_ptr(), s.data_ptr(), count.data_ptr(), ovf.data_ptr(),
        kernels.work_ptr(work, dev, what), device=dev)
    return SeedBatch(m=m, n=n, k=k, s=s, count=count, overflow=ovf)


def seed_strategy_plain(fm: DeviceFMIndex, codes, lens, active,
                        max_intv: int, min_seed_len: int,
                        max_seeds: int) -> SeedBatch:
    """The plain version: the JAX package's K3 loop as a Python loop of
    torch ops."""
    B, L = codes.shape
    seeds0 = _empty_seeds(B, max_seeds, codes.device)
    return _seed_strategy_loop(fm, codes, lens, active, max_intv,
                               min_seed_len, seeds0)


def _seed_strategy_loop(fm, codes, lens, active, max_intv, min_seed_len,
                        seeds):
    B, L = codes.shape
    dev = codes.device
    z = torch.zeros(B, dtype=_I32, device=dev)
    x = j = k = l = s = m = n = z
    started = torch.zeros(B, dtype=torch.bool, device=dev)
    lens = lens.to(_I32)
    step_cap = 2 * L * L

    steps = 0
    while steps < step_cap:
        if steps % _K3_CHECK_EVERY == 0 and \
                not bool((active & (x < lens)).any()):
            break
        steps += 1
        lane_on = active & (x < lens)
        # anchor restart lanes
        fresh = lane_on & ~started
        a0 = _read_base(codes, x)
        k0, l0, s0 = fmops.init_interval(fm, a0)
        start_ok = fresh & (a0 < 4)
        x_old = x
        x = torch.where(fresh & (a0 >= 4), x + 1, x)
        k = torch.where(start_ok, k0, k)
        l = torch.where(start_ok, l0, l)
        s = torch.where(start_ok, s0, s)
        m = torch.where(start_ok, x_old, m)
        n = torch.where(start_ok, x_old, n)
        j = torch.where(start_ok, x_old + 1, j)
        extl = lane_on & started
        started = started | start_ok

        # extension lanes: two chars per iteration from one gather pair
        a = _read_base(codes, j)
        b = _read_base(codes, j + 1)
        (k1, l1, s1), (k2, l2, s2) = fmops.forward_extend2(fm, k, l, s,
                                                           a, b)

        # ---- char 0 at j ----
        over0 = extl & (j >= lens)           # inner loop exhausted
        x = torch.where(over0, j, x)
        started = started & ~over0
        step0 = extl & ~over0
        amb0 = step0 & (a >= 4)
        x = torch.where(amb0, j + 1, x)
        started = started & ~amb0
        go0 = step0 & ~amb0
        k = torch.where(go0, k1, k)
        l = torch.where(go0, l1, l)
        s = torch.where(go0, s1, s)
        n = torch.where(go0, j, n)
        hit0 = go0 & (s1 < max_intv) & ((j - m + 1) >= min_seed_len)
        emit0 = hit0 & (s1 > 0)
        seeds = _append_seed(seeds, emit0, m, n, k, s)
        x = torch.where(hit0, j + 1, x)
        started = started & ~hit0
        j = torch.where(go0 & ~hit0, j + 1, j)

        # ---- char 1 at (old) j+1 ----
        cont = go0 & ~hit0
        over1 = cont & (j >= lens)
        x = torch.where(over1, j, x)
        started = started & ~over1
        step1 = cont & ~over1
        amb1 = step1 & (b >= 4)
        x = torch.where(amb1, j + 1, x)
        started = started & ~amb1
        go1 = step1 & ~amb1
        k = torch.where(go1, k2, k)
        l = torch.where(go1, l2, l)
        s = torch.where(go1, s2, s)
        n = torch.where(go1, j, n)
        hit1 = go1 & (s2 < max_intv) & ((j - m + 1) >= min_seed_len)
        emit1 = hit1 & (s2 > 0)
        seeds = _append_seed(seeds, emit1, m, n, k, s)
        x = torch.where(hit1, j + 1, x)
        started = started & ~hit1
        j = torch.where(go1 & ~hit1, j + 1, j)
    return seeds
