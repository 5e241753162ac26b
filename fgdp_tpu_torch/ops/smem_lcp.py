"""K1: single-pass SMEM enumeration by backward search + LCP-tree shrink.

Port of the JAX package's ops/smem_lcp.py (the LISA fork's all_SMEMs,
reference ext/TAL/src/LISA-FMI/LISA_search.h :365-385): a read's SMEMs
are enumerated right-to-left in ONE pass — backward-extend until the
interval empties, emit, ascend the suffix tree via the LCP-interval
arrays (index/lcptree.py) to the deepest ancestor that can be prepended
with the failing character, and continue. One lane per read.

Three alternating waves, as in the JAX package:
  EXT   two-chars-per-step backward extension (backward_extend2)
  WALK  single-suffix lanes (s == 1): packed-word text compare, WALK_T
        chars per step; re-entering the row space costs one ISA gather
  SHR   LCP-tree ascent to the deepest extendable ancestor

On the card the whole machine is one launch of the hand-written kernel
csrc/smem_lcp.cu (D2, on the rank device functions of csrc/fm.cuh, D1).
`smem_all_lcp_plain` beside it is the same machine as a Python loop of
batched tensor steps: each JAX `while_loop` is a host loop whose waves
test their exit condition (the mode's population against 1/8 of the
live lanes) before every step, exactly as the JAX package does: the
straggler cascade and the round caps decide which reads flag overflow,
so the step sequence must be the same for the escalation ladder to see
the same reads. Walk-resolved seeds carry the direct position encoding
k = -pos - 2.

`smem_all_lcp` takes the kernel for CUDA tensors with a whole FM table,
and the plain version for CPU tensors and for a table of ShardedRows
(the fm-sharded mesh: its gathers are all_reduces, which a kernel
cannot make); a failing launch raises.
"""

from __future__ import annotations

import ctypes
from collections import namedtuple

import torch

from . import fm as fmops
from . import kernels
from .smem import (SeedBatch, _append_seed, _empty_seeds, _read_base_at,
                   any_by)
from .smem_sweep import WALK_T, pack_reads, read_window
from ..index.reference import packed_window

MODE_EXT = 0     # backward-extending (s > 1)
MODE_SHR = 1     # ascending the lcp tree
MODE_DEAD = 2
MODE_WALK = 3    # single-suffix text walk (s == 1)

_LANE_FIELDS = ("l", "r", "lo", "hi", "pos", "mode")
_I32 = torch.int32


def smem_all_lcp(fm: fmops.DeviceFMIndex, tree, isa, codes, lens, active,
                 min_seed_len: int, max_seeds: int,
                 ref_codes16, max_rounds: int = 24) -> SeedBatch:
    """tree: int32[nrows+1, 4] (lcp, left, right, mask) and isa:
    int32[nrows] inverse SA from index/lcptree.py; codes int32[B, L];
    ref_codes16 the packed reference words (DeviceReference.codes16).
    Returns the read's SMEMs of length >= min_seed_len as a SeedBatch
    (m, n inclusive, k, s), unordered.

    Straggler control: each wave exits once its mode's population drops
    to 1/8 of the live lanes, and reads still live after the round
    budget flag overflow for the host escalation ladder."""
    fn = smem_all_lcp_kernel if codes.is_cuda and not fmops.is_sharded(fm) \
        else smem_all_lcp_plain
    return fn(fm, tree, isa, codes, lens, active, min_seed_len, max_seeds,
              ref_codes16, max_rounds)


# the kernel's work counters: csrc/seed_waves.cuh's four, then the wave
# split (ns, then grid steps, of each bucket: a step of a wave, the
# cascade's levels, the launch's start)
WAVE_BUCKETS = ("EXT", "WALK", "SHR", "cascade 1", "cascade 2", "start")
WORK_LEN = 4 + 2 * len(WAVE_BUCKETS)

LcpPlan = namedtuple("LcpPlan", "blocks threads lanes staged per_sm")


def launch_plan(B: int, L: int, device) -> LcpPlan:
    """The launch smem_all_lcp_kernel makes for B reads of L codes:
    blocks, threads a block, lanes a thread, whether the rows are staged
    in shared memory, and the blocks an SM holds; raises when the lanes
    cannot all be resident."""
    lib = kernels.load("smem_lcp")
    plan = (ctypes.c_int * 5)()
    with torch.cuda.device(device):
        rc = lib.fgdp_smem_lcp_plan(B, L, ctypes.addressof(plan))
    kernels.check(rc, "smem_lcp plan")
    return LcpPlan(plan[0], plan[1], plan[2], bool(plan[3]), plan[4])


def smem_all_lcp_kernel(fm, tree, isa, codes, lens, active,
                        min_seed_len: int, max_seeds: int, ref_codes16,
                        max_rounds: int = 24, work=None) -> SeedBatch:
    """Launch csrc/smem_lcp.cu on CUDA tensors; returns what
    `smem_all_lcp_plain` returns. `work`, a zeroed int64[WORK_LEN] on the
    card, receives the launch's work counters."""
    B, L = codes.shape
    dev = codes.device
    what = "smem_lcp kernel"
    _keep, fm_args = fmops.kernel_args(fm, dev, what)
    arg = lambda x, dt, n: kernels.tensor_arg(x, dev, dt, f"{what}: {n}")
    tree_c = arg(tree, _I32, "tree")
    isa_c = arg(isa, _I32, "isa")
    codes_c = arg(codes, _I32, "codes")
    lens_c = arg(lens, _I32, "lens")
    act_c = arg(active, torch.bool, "active")
    words = arg(ref_codes16, torch.int64, "ref_codes16")
    if lens_c.shape != (B,) or act_c.shape != (B,) or tree_c.dim() != 2 \
            or tree_c.shape[1] != 4:
        raise ValueError(f"{what}: lens/active must be [{B}], tree "
                         "[N + 1, 4]")
    m, n, k, s = (torch.zeros((B, max_seeds), dtype=_I32, device=dev)
                  for _ in range(4))
    count = torch.empty(B, dtype=_I32, device=dev)
    ovf = torch.empty(B, dtype=torch.bool, device=dev)
    lib = kernels.load("smem_lcp")
    slots = torch.zeros(6, dtype=torch.int64, device=dev)
    blk = torch.empty(lib.fgdp_smem_lcp_max_blocks(B), dtype=_I32,
                      device=dev)
    kernels.launch(
        "smem_lcp", lib.fgdp_smem_lcp, *fm_args, tree_c.data_ptr(),
        isa_c.data_ptr(), codes_c.data_ptr(), lens_c.data_ptr(),
        act_c.data_ptr(), words.data_ptr(), words.shape[0], B, L,
        tree_c.shape[0] - 1, 2 * fm.n_ref, min_seed_len, max_seeds,
        max_rounds, m.data_ptr(), n.data_ptr(), k.data_ptr(),
        s.data_ptr(), count.data_ptr(), ovf.data_ptr(), slots.data_ptr(),
        blk.data_ptr(), kernels.work_ptr(work, dev, what, WORK_LEN),
        device=dev)
    return SeedBatch(m=m, n=n, k=k, s=s, count=count, overflow=ovf)


def smem_all_lcp_plain(fm: fmops.DeviceFMIndex, tree, isa, codes, lens,
                       active, min_seed_len: int, max_seeds: int,
                       ref_codes16, max_rounds: int = 24) -> SeedBatch:
    """The plain version: the machine as a Python loop of torch ops (the
    JAX package's smem_all_lcp, transcribed)."""
    B, L = codes.shape
    dev = codes.device
    N = tree.shape[0] - 1            # SA rows
    lens = lens.to(_I32)
    rid = torch.arange(B, dtype=_I32, device=dev)
    rpacked = pack_reads(codes)
    l2ref = 2 * fm.n_ref             # text length (excl. sentinel)

    st = dict(
        l=lens, r=lens,
        lo=torch.zeros(B, dtype=_I32, device=dev),
        hi=torch.full((B,), N, dtype=_I32, device=dev),
        pos=torch.full((B,), -1, dtype=_I32, device=dev),
        mode=torch.where(active & (lens > 0), MODE_EXT,
                         MODE_DEAD).to(_I32),
        seeds=_empty_seeds(B, max_seeds, dev),
    )

    def run_phase(st, rid, round_cap):
        return _lcp_phase(fm, tree, isa, codes, rpacked, ref_codes16, rid,
                          lens[rid.long()], min_seed_len, N, l2ref,
                          round_cap, st)

    # Straggler-compaction cascade: after each bounded phase, live lanes
    # compact (stable) into a machine a quarter the width, seed rows
    # riding along; live lanes that do not fit flag overflow.
    rounds = (10, 14, max_rounds)
    st = run_phase(st, rid, rounds[0])
    dropped = torch.zeros(B, dtype=torch.bool, device=dev)
    for level, rcap in enumerate(rounds[1:], start=1):
        NC = max(B >> (2 * level - 1), 8)   # B/2, then B/8
        live = st["mode"] != MODE_DEAD
        if B <= NC:
            st = run_phase(st, rid, rcap)
            continue
        perm = torch.argsort((~live).to(torch.int8), stable=True)
        keep, rest = perm[:NC], perm[NC:]
        dropped = dropped | any_by(rid[rest], live[rest], B)
        sub = {f: st[f][keep] for f in _LANE_FIELDS}
        sub["mode"] = torch.where(live[keep], sub["mode"], MODE_DEAD) \
            .to(_I32)
        sub["seeds"] = SeedBatch(*(a[keep] for a in st["seeds"]))
        sub = run_phase(sub, rid[keep], rcap)
        nst = {}
        for f in _LANE_FIELDS:
            nst[f] = st[f].clone()
            nst[f][keep] = sub[f]
        nst["seeds"] = SeedBatch(*(_set_rows(a, keep, b) for a, b in
                                   zip(st["seeds"], sub["seeds"])))
        # lanes dropped from the sub machine keep their old (live) mode
        nst["mode"][rest] = torch.where(live[rest], st["mode"][rest],
                                        MODE_DEAD).to(_I32)
        st = nst

    # reads still live at the cascade end flag for the host escalation
    # ladder, which re-runs them with a scaled round budget
    unfinished = st["mode"] != MODE_DEAD
    seeds = st["seeds"]
    return seeds._replace(overflow=seeds.overflow | unfinished | dropped)


def _set_rows(a, rows, vals):
    out = a.clone()
    out[rows] = vals
    return out


def _count(mask) -> int:
    return int(mask.sum())


def _lcp_phase(fm, tree, isa, codes, rpacked, ref_codes16, rid, lens_l,
               msl, N, l2ref, round_cap, st):
    """One bounded run of the EXT/WALK/SHR wave alternation over the
    lanes `rid` (reads rid[i]; per-lane state arrays index i)."""

    def ext_body(st):
        l, r, lo, hi = st["l"], st["r"], st["lo"], st["hi"]
        s = hi - lo
        act = st["mode"] == MODE_EXT
        at_end = act & (l == 0)
        a = _read_base_at(codes, rid, l - 1)
        b = _read_base_at(codes, rid, l - 2)
        k1, s1, k2, s2 = fmops.backward_extend2(fm, lo, s, a, b)
        va = a < 4
        try1 = act & ~at_end & va
        ok1 = try1 & (s1 > 0)
        stuck1 = try1 & ~(s1 > 0)
        bad1 = act & ~at_end & ~va
        # emit at step-1 maximal points (end-of-read, interval-empty,
        # ambiguous char): pre-state [l, r) with interval [lo, hi)
        emit1 = (at_end | stuck1 | bad1) & (r - l >= msl)
        empty1 = r == l
        skip1 = bad1 | (stuck1 & empty1)       # restart left of the char
        to_shr1 = stuck1 & ~empty1
        l1x = torch.where(ok1 | skip1, l - 1, l)
        r1x = torch.where(skip1, l - 1, r)
        lo1x = torch.where(ok1, k1, torch.where(skip1, 0, lo))
        hi1x = torch.where(ok1, k1 + s1, torch.where(skip1, N, hi))
        to_walk1 = ok1 & (s1 == 1)
        cont = ok1 & (s1 > 1)

        # ---- step 2 (only lanes that took step 1 with s1 > 1) ----
        at_end2 = cont & (l1x == 0)
        vb = b < 4
        bad2 = cont & ~at_end2 & ~vb
        try2 = cont & ~at_end2 & vb
        ok2 = try2 & (s2 > 0)
        stuck2 = try2 & ~(s2 > 0)
        emit2 = (at_end2 | stuck2 | bad2) & (r - l1x >= msl)
        # step-1 and step-2 emissions are mutually exclusive: one append
        seeds = _append_seed(st["seeds"], emit1 | emit2,
                             torch.where(emit2, l1x, l), r - 1,
                             torch.where(emit2, k1, lo),
                             torch.where(emit2, s1, s))
        skip2 = bad2
        to_shr2 = stuck2
        l2x = torch.where(ok2 | skip2, l1x - 1, l1x)
        r2x = torch.where(skip2, l1x - 1, r1x)
        lo2x = torch.where(ok2, k2, torch.where(skip2, 0, lo1x))
        hi2x = torch.where(ok2, k2 + s2, torch.where(skip2, N, hi1x))
        to_walk2 = ok2 & (s2 == 1)

        dead = at_end | at_end2
        to_shr = to_shr1 | to_shr2
        to_walk = to_walk1 | to_walk2
        mode = torch.where(dead, MODE_DEAD,
                           torch.where(to_shr, MODE_SHR,
                                       torch.where(to_walk, MODE_WALK,
                                                   st["mode"])))
        # walk lanes init pos lazily (pos < 0) in the walk wave
        pos = torch.where(to_walk, -1, st["pos"])
        return dict(l=l2x.to(_I32), r=r2x.to(_I32), lo=lo2x.to(_I32),
                    hi=hi2x.to(_I32), pos=pos.to(_I32),
                    mode=mode.to(_I32), seeds=seeds)

    def walk_body(st):
        return _walk_step(fm, isa, rpacked, ref_codes16, rid, lens_l, msl,
                          N, l2ref, st)

    def shr_body(st):
        act = st["mode"] == MODE_SHR
        l, lo, hi = st["l"], st["lo"], st["hi"]
        t_lo = tree[lo.clamp(0, N).long()]
        t_hi = tree[hi.clamp(0, N).long()]
        # ascend to the parent: dissolve the deeper endpoint
        pick_lo = t_lo[:, 0] >= t_hi[:, 0]
        e = torch.where(pick_lo[:, None], t_lo, t_hi)
        d = e[:, 0].clamp(min=0)
        a = _read_base_at(codes, rid, l - 1)
        can = ((e[:, 3] >> a.clamp(0, 3)) & 1) == 1
        new_lo = torch.where(act, e[:, 1], lo)
        new_hi = torch.where(act, e[:, 2], hi)
        new_r = torch.where(act, l + d, st["r"])
        # d == 0 hands an unextendable root back to the extend wave,
        # whose empty-match path skips the character
        mode = torch.where(act & (can | (d == 0)), MODE_EXT, st["mode"])
        return dict(l=l, r=new_r.to(_I32), lo=new_lo.to(_I32),
                    hi=new_hi.to(_I32), pos=st["pos"], mode=mode.to(_I32),
                    seeds=st["seeds"])

    def wave(st, m, body):
        while True:
            mode = st["mode"]
            cm = _count(mode == m)
            live = _count(mode != MODE_DEAD)
            if not cm > (live >> 3):
                return st
            st = body(st)

    rnd = 0
    while rnd < round_cap and bool((st["mode"] != MODE_DEAD).any()):
        rnd += 1
        st = wave(st, MODE_EXT, ext_body)
        st = wave(st, MODE_WALK, walk_body)
        st = wave(st, MODE_SHR, shr_body)
    return st


def _walk_step(fm, isa, rpacked, ref_codes16, rid, lens_l, msl, N, l2ref,
               st):
    """One WALK step of the lanes in MODE_WALK (the others keep their
    state): the first of WALK_T characters where q[l-1-j] and
    text[pos-1-j] differ or either is 4 (pos from SA at a walk's first
    step) ends the walk."""
    act = st["mode"] == MODE_WALK
    l, r, lo = st["l"], st["r"], st["lo"]
    pos = torch.where(act & (st["pos"] < 0),
                      fmops.sa_lookup(fm, st["lo"]), st["pos"])
    # compare q[l-1-j] vs text[pos-1-j], j = 0..WALK_T-1
    rb = read_window(rpacked, rid, l - WALK_T, lens_l,
                     WALK_T).flip(1)
    tb = packed_window(ref_codes16, l2ref, pos - WALK_T, WALK_T,
                       reverse=True)
    okw = (rb == tb) & (rb < 4) & (tb < 4)
    hasbad = (~okw).any(dim=1)
    d = torch.where(hasbad, (~okw).to(torch.int8).argmax(dim=1),
                    WALK_T).to(_I32)
    l2 = l - d
    pos2 = pos - d
    stop = act & hasbad
    at_start = stop & (l2 == 0)
    rb_d = rb.gather(1, d.clamp(0, WALK_T - 1).long()[:, None])[:, 0]
    badchar = stop & ~at_start & (rb_d >= 4)   # read N at q[l2-1]
    mism = stop & ~at_start & ~badchar         # mismatch / text end
    emit = stop & (r - l2 >= msl)
    seeds = _append_seed(st["seeds"], emit, l2, r - 1, -pos2 - 2,
                         torch.ones_like(l2))
    # mism lanes re-enter row space at the single suffix's SA row
    loI = isa[pos2.clamp(0, N - 1).long()]
    new_l = torch.where(act, torch.where(badchar, l2 - 1, l2), l)
    new_r = torch.where(badchar, l2 - 1, r)
    new_lo = torch.where(mism, loI, torch.where(badchar, 0, lo))
    new_hi = torch.where(mism, loI + 1,
                         torch.where(badchar, N, st["hi"]))
    mode = torch.where(at_start, MODE_DEAD,
                       torch.where(mism, MODE_SHR,
                                   torch.where(badchar, MODE_EXT,
                                               st["mode"])))
    new_pos = torch.where(act, torch.where(stop, -1, pos2), st["pos"])
    return dict(l=new_l.to(_I32), r=new_r.to(_I32),
                lo=new_lo.to(_I32), hi=new_hi.to(_I32),
                pos=new_pos.to(_I32), mode=mode.to(_I32), seeds=seeds)
