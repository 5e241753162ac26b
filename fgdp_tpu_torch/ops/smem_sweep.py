"""Self-restarting SMEM machines (K1/K2 sweep) and packed read words
(torch).

Port of the JAX package's ops/smem_sweep.py, the default K1/K2 engine
when no LCP tree is given (align/seeding.py `lcp_tree=None`):

1. **Self-restarting forward sweep.** One loop; a lane whose anchor
   ends restarts at next_x at once, so occupancy stays near-full until
   a lane exhausts its read. Stack entries are appended to per-lane
   entry buffers. Lanes whose interval narrows to a single suffix
   (s == 1) walk the text WALK_T chars a step from packed words.
2. **Independent backward lanes.** The entries of one anchor are nested
   SA intervals, so the wave machine's emission rule reduces to a
   per-entry rule on the final left reach m_i:
       emit entry i  <=>  n_i - m_i + 1 >= min_seed_len
                          AND (i == 0 OR m_i < m_{i-1})
   and every entry extends one interval on its own lane.

Semantics equal ops/smem.py's smem_all_pos / smem_one_pos_lanes (the
wave machines), which tests/test_torch_smem_sweep.py holds them
against. Seeds resolved by a text walk carry the direct position
encoding k = -pos - 2. Every loop tests its exit before each step.

The two loops are the JAX package's device loops D9 (fwd_sweep) and D10
(bwd_entries). On CUDA tensors with whole FM tables each is one launch
of a hand-written kernel (csrc/sweep_fwd.cu: a 16-lane group a lane,
its read's codes staged in shared memory; csrc/sweep_bwd.cu: one thread
a lane; each lane run to its own end), with no host sync between
them; on the CPU, and on the fm-sharded mesh's ShardedRows tables, the
Python loops of torch ops below (`*_plain`) run them. flatten_entries
and emit_merge have no loop and stay torch ops.

Packed words are uint32 values carried in int64 tensors: torch has no
uint32 arithmetic, and int64 keeps every shift and mask exact.
"""

from __future__ import annotations

import torch

from . import fm as fmops
from . import kernels
from .fm import DeviceFMIndex
from .smem import (SeedBatch, _empty_seeds, _read_base_at, any_by,
                   compact_order, first_true, put_at)
from ..index.reference import packed_window

_I32 = torch.int32
WALK_T = 64          # chars per text-walk step

_U32 = 0xFFFFFFFF


def pack_reads(codes):
    """Pack int32[B, L] base codes into 2-bit words + N-flag words.

    Returns int64[B, W, 2] (words, nwords) with W = ceil(L/16) + 1 (one
    slack word so window fetches never index out of range). Codes >= 4
    pack as 0 with the N flag set."""
    B, L = codes.shape
    W = (L + 15) // 16 + 1
    pad = W * 16 - L
    c = torch.nn.functional.pad(codes.long(), (0, pad))
    isn = (c >= 4) | (c < 0)
    c2 = torch.where(isn, 0, c).reshape(B, W, 16)
    sh = (2 * torch.arange(16, device=codes.device))[None, None, :]
    words = (c2 << sh).sum(dim=2)
    nwords = (isn.long().reshape(B, W, 16) << sh).sum(dim=2)
    return torch.stack([words, nwords], dim=-1)


def read_window(packed, rid, start, lens_l, T: int):
    """Read codes [NL, T] at positions start..start+T-1 of read rid
    (4 = N / out of [0, len))."""
    Wf = (T + 15) // 16 + 1
    start = start.long()
    dev = packed.device
    w0 = start >> 4                          # floor for negative starts
    widx = (w0[:, None] + torch.arange(Wf, device=dev)[None, :]).clamp(
        0, packed.shape[1] - 1)
    rows = packed[rid.long()[:, None], widx]            # [NL, Wf, 2]
    wrows, nrows = rows[..., 0], rows[..., 1]
    off = start & 15
    sh = 2 * off[:, None]

    def align(ws):
        return torch.where(off[:, None] == 0, ws[:, :-1],
                           ((ws[:, :-1] >> sh) | (ws[:, 1:] << (32 - sh)))
                           & _U32)

    aw, an = align(wrows), align(nrows)
    cols = torch.arange(T, device=dev)
    wi = (cols >> 4).clamp(max=Wf - 2)
    bi = 2 * (cols & 15)
    c = (aw[:, wi] >> bi[None, :]) & 3
    nf = (an[:, wi] >> bi[None, :]) & 1
    pos = start[:, None] + cols[None, :]
    ok = (pos >= 0) & (pos < lens_l[:, None]) & (nf == 0)
    return torch.where(ok, c, 4).to(torch.int32)


# --------------------------------------------------------------------------
# Phase A: self-restarting forward sweep
# --------------------------------------------------------------------------

def _on_card(codes, fm) -> bool:
    return codes.is_cuda and not fmops.is_sharded(fm)


def fwd_sweep(fm: DeviceFMIndex, codes, lens, rid, x0, min_intv, active,
              prev_cap: int, entry_cap: int, ref_codes16,
              restart: bool = True, walk: bool = True):
    """Forward phase of getSMEMsOnePosOneThread over NL lanes, anchors
    self-restarting (restart=True: K1 sweeps every anchor of the read;
    False: one anchor per lane, the K2 shape).

    Per lane, entries are the prev-stack of each anchor laid out
    anchor-major in push order. Entry payload (em = anchor x, en, ek,
    es). Per-anchor pushes cap at prev_cap (dropping the last pushes,
    as the wave machine does); per-lane entries cap at entry_cap
    (overflow flagged).

    Returns dict(em, en, ek, es [NL, E], ecount, povf, eovf [NL]).
    D9's kernel on the card, fwd_sweep_plain elsewhere.
    """
    fn = fwd_sweep_kernel if _on_card(codes, fm) else fwd_sweep_plain
    return fn(fm, codes, lens, rid, x0, min_intv, active, prev_cap,
              entry_cap, ref_codes16, restart=restart, walk=walk)


def fwd_sweep_kernel(fm: DeviceFMIndex, codes, lens, rid, x0, min_intv,
                     active, prev_cap: int, entry_cap: int, ref_codes16,
                     restart: bool = True, walk: bool = True, work=None):
    """Launch csrc/sweep_fwd.cu (D9) on CUDA tensors; returns what
    `fwd_sweep_plain` returns. `work`, a zeroed int64[4] on the card,
    receives the launch's work counters (csrc/seed_waves.cuh)."""
    B, L = codes.shape
    NL, E = x0.shape[0], entry_cap
    dev = codes.device
    what = "sweep_fwd kernel"
    _keep, fm_args = fmops.kernel_args(fm, dev, what)
    arg = lambda x, dt, n: kernels.tensor_arg(x, dev, dt, f"{what}: {n}")
    codes_c = arg(codes, _I32, "codes")
    lens_c = arg(lens, _I32, "lens")
    rid_c, x0_c, mi_c = (arg(t, _I32, n) for t, n in (
        (rid, "rid"), (x0, "x0"), (min_intv, "min_intv")))
    act_c = arg(active, torch.bool, "active")
    words = arg(ref_codes16, torch.int64, "ref_codes16")
    if lens_c.shape != (B,) or any(t.shape != (NL,) for t in
                                   (rid_c, mi_c, act_c)):
        raise ValueError(f"{what}: lens must be [{B}], rid/min_intv/active "
                         f"[{NL}]")
    em, en, ek, es = (torch.zeros((NL, E), dtype=_I32, device=dev)
                      for _ in range(4))
    ecount = torch.empty(NL, dtype=_I32, device=dev)
    povf, eovf = (torch.empty(NL, dtype=torch.bool, device=dev)
                  for _ in range(2))
    lib = kernels.load("sweep_fwd")
    kernels.launch(
        "sweep_fwd", lib.fgdp_sweep_fwd, *fm_args, codes_c.data_ptr(),
        lens_c.data_ptr(), rid_c.data_ptr(), x0_c.data_ptr(),
        mi_c.data_ptr(), act_c.data_ptr(), words.data_ptr(),
        words.shape[0], B, L, NL, E, prev_cap, 2 * fm.n_ref, int(restart),
        int(walk), em.data_ptr(), en.data_ptr(), ek.data_ptr(),
        es.data_ptr(), ecount.data_ptr(), povf.data_ptr(), eovf.data_ptr(),
        kernels.work_ptr(work, dev, what), device=dev)
    return dict(em=em, en=en, ek=ek, es=es, ecount=ecount, povf=povf,
                eovf=eovf)


def fwd_sweep_plain(fm: DeviceFMIndex, codes, lens, rid, x0, min_intv,
                    active, prev_cap: int, entry_cap: int, ref_codes16,
                    restart: bool = True, walk: bool = True):
    """The plain version: the JAX package's forward loop as a Python loop
    of torch ops, a host sync a step."""
    NL = x0.shape[0]
    E = entry_cap
    dev = codes.device
    lens_l = lens.to(_I32)[rid.long()]
    rpacked = pack_reads(codes)
    z = torch.zeros(NL, dtype=_I32, device=dev)
    zE = torch.zeros((NL, E), dtype=_I32, device=dev)
    f = torch.zeros(NL, dtype=torch.bool, device=dev)
    st = dict(x=x0.to(_I32), n=z, k=z, l=z, s=z, started=f, done=~active,
              cur_np=z, ecount=z, em=zE, en=zE, ek=zE, es=zE,
              povf=f, eovf=f)

    def push(st, mask, pm, pn, pk, ps):
        """One masked entry append with per-anchor + per-lane caps."""
        can_p = mask & (st["cur_np"] < prev_cap)
        povf = st["povf"] | (mask & (st["cur_np"] >= prev_cap))
        can = can_p & (st["ecount"] < E)
        eovf = st["eovf"] | (can_p & (st["ecount"] >= E))
        ec = st["ecount"]
        return dict(st, em=put_at(st["em"], ec, pm, can),
                    en=put_at(st["en"], ec, pn, can),
                    ek=put_at(st["ek"], ec, pk, can),
                    es=put_at(st["es"], ec, ps, can),
                    ecount=ec + can.to(_I32),
                    cur_np=torch.clamp(st["cur_np"] + mask.to(_I32),
                                       max=prev_cap),
                    povf=povf, eovf=eovf)

    while bool((~st["done"] & (st["started"] | (st["x"] < lens_l))).any()):
        live = ~st["done"] & (st["x"] < lens_l)
        # ---- restart: lanes with no anchor in progress ----
        fresh = live & ~st["started"]
        a0 = _read_base_at(codes, rid, st["x"])
        start_ok = fresh & (a0 < 4)
        skipn = fresh & (a0 >= 4)
        k0, l0, s0 = fmops.init_interval(fm, a0)
        x = torch.where(skipn, st["x"] + 1, st["x"])
        st = dict(st, x=x, k=torch.where(start_ok, k0, st["k"]),
                  l=torch.where(start_ok, l0, st["l"]),
                  s=torch.where(start_ok, s0, st["s"]),
                  n=torch.where(start_ok, x, st["n"]),
                  cur_np=torch.where(start_ok, 0, st["cur_np"]),
                  started=st["started"] | start_ok)
        run = st["started"] & live & ~skipn
        j = st["n"] + 1                     # next char to match

        # ================= text-walk branch (s == 1) =================
        # a single-suffix interval is invariant under matching forward
        # extension: resolve it by direct text comparison, WALK_T chars
        # a step. walk=False (K2: min_intv >= 2, intervals die before
        # s == 1) leaves the branch out
        if walk:
            walkm = run & (st["s"] == 1)
            pos = fmops.sa_lookup(fm, st["k"])       # q[x] text position
            tb = packed_window(ref_codes16, 2 * fm.n_ref,
                               pos + (j - st["x"]), WALK_T)
            rb = read_window(rpacked, rid, j, lens_l, WALK_T)
            okw = (rb == tb) & (rb < 4) & (tb < 4)
            hasbad = (~okw).any(dim=1)
            d = torch.where(hasbad, first_true(~okw), WALK_T)
            jd = j + d
            n_w = jd - 1                             # last matched char
            w_stop = walkm & hasbad
            rb_d = rb.gather(1, d.clamp(0, WALK_T - 1).long()[:, None])[:, 0]
            w_end = w_stop & (jd >= lens_l)          # ran off the read
            w_amb = w_stop & ~w_end & (rb_d >= 4)    # read N: no push
            w_mis = w_stop & ~w_end & ~w_amb         # mismatch/text end
            # in-loop death push of the pre-state (x, n, k, 1)
            st = push(st, w_mis, st["x"], n_w, st["k"], st["s"])
            n2 = torch.where(walkm, n_w, st["n"])
        else:
            w_stop = w_end = w_amb = w_mis = torch.zeros_like(run)
            jd = j
            n2 = st["n"]

        # ================= occ branch (s > 1): two-step ==============
        occ = run & (st["s"] > 1)
        a = _read_base_at(codes, rid, j)
        b = _read_base_at(codes, rid, j + 1)
        (k1, l1, s1), (k2, l2, s2) = fmops.forward_extend2(
            fm, st["k"], st["l"], st["s"], a, b)
        off0 = occ & (j >= lens_l)
        in0 = occ & ~off0
        amb0 = in0 & (a >= 4)
        ext0 = in0 & (a < 4)
        push0 = ext0 & (s1 != st["s"])
        st = push(st, push0, st["x"], st["n"], st["k"], st["s"])
        die0 = ext0 & (s1 < min_intv)
        take0 = ext0 & ~die0
        kA = torch.where(take0, k1, st["k"])
        lA = torch.where(take0, l1, st["l"])
        sA = torch.where(take0, s1, st["s"])
        nA = torch.where(take0, j, n2)

        j1 = j + 1
        off1 = take0 & (j1 >= lens_l)
        in1 = take0 & ~off1
        amb1 = in1 & (b >= 4)
        ext1 = in1 & (b < 4)
        push1 = ext1 & (s2 != sA)
        st = push(st, push1, st["x"], nA, kA, sA)
        die1 = ext1 & (s2 < min_intv)
        take1 = ext1 & ~die1
        kB = torch.where(take1, k2, kA)
        lB = torch.where(take1, l2, lA)
        sB = torch.where(take1, s2, sA)
        nB = torch.where(take1, j1, nA)

        # ---- anchor end: final push + restart at next_x ----
        ended = off0 | amb0 | die0 | off1 | amb1 | die1 | w_stop
        nxt = lens_l                                     # w_end
        for cond, val in ((w_amb, jd + 1), (w_mis, jd), (off1, j1),
                          (amb1, j1 + 1), (die1, j1), (off0, j),
                          (amb0, j + 1), (die0, j)):
            nxt = torch.where(cond, val, nxt)
        # final push of the last interval (FMI_search.cpp:1249-1254)
        st = push(st, ended & (sB >= min_intv), st["x"], nB, kB, sB)

        if restart:
            x_new = torch.where(ended, nxt, st["x"])
            done_new = st["done"]
        else:
            x_new = st["x"]
            done_new = st["done"] | ended | skipn
        st = dict(st, x=x_new, n=nB, k=kB, l=lB, s=sB,
                  started=torch.where(run | start_ok, run & ~ended,
                                      st["started"]),
                  done=done_new)
    return {f: st[f] for f in ("em", "en", "ek", "es", "ecount", "povf",
                                "eovf")}


# --------------------------------------------------------------------------
# Entry reorder (longest-first within anchor) + global flatten
# --------------------------------------------------------------------------

def flatten_entries(fw, rid, min_intv, E: int, NL_OUT: int):
    """Compact valid entries of [NL, E] buffers into NL_OUT backward
    lanes, order-preserving. Entries stay in push order (shortest match
    of each anchor first): emit_merge applies the longest-first emission
    rule via next-lane adjacency and reversed in-group offsets. Returns
    per-lane arrays + per-source-lane drop overflow."""
    em, ecount = fw["em"], fw["ecount"]
    NL = em.shape[0]
    dev = em.device
    valid = torch.arange(E, device=dev)[None, :] < ecount[:, None]
    # drop exact adjacent duplicates within an anchor group (a dying
    # anchor's in-loop death push + final push coincide): the duplicate's
    # m equals its twin's, so it can never emit
    same = torch.ones((NL, E - 1), dtype=torch.bool, device=dev)
    for a in (fw["em"], fw["en"], fw["ek"], fw["es"]):
        same = same & (a[:, 1:] == a[:, :-1])
    valid = valid & ~torch.cat(
        [torch.zeros((NL, 1), dtype=torch.bool, device=dev), same], dim=1)
    l_src, l_on = compact_order(valid.reshape(-1), NL_OUT)
    l_src = torch.where(l_on, l_src, 0).long()
    l_lane = l_src // E
    ent4 = torch.stack([fw["em"], fw["en"], fw["ek"], fw["es"]],
                       dim=-1).reshape(NL * E, 4)
    rows = ent4[l_src]                       # one 4-wide gather
    lanes = dict(rid=rid[l_lane], lane=l_lane.to(_I32), anc=rows[:, 0],
                 n=rows[:, 1], k=rows[:, 2], s=rows[:, 3],
                 mi=min_intv[l_lane], on=l_on)
    # compaction is order-preserving, so dropped entries (global rank >=
    # NL_OUT) belong to the trailing source lanes: flag a lane when its
    # cumulative valid-entry count crosses the cap
    vcnt = valid.sum(dim=1, dtype=torch.int64)
    drop_ovf = torch.cumsum(vcnt, 0) > NL_OUT
    return lanes, drop_ovf


# --------------------------------------------------------------------------
# Phase B: independent backward extension per entry lane
# --------------------------------------------------------------------------

def bwd_entries(fm: DeviceFMIndex, codes, lens, lanes, ref_codes16):
    """Extend each entry's single interval leftward to its maximal reach.

    lanes: dict(rid, anc, n, k, s, mi, on). Returns (m, kf, sf): final
    match start, and the pre-death interval (kf < -1 encodes a direct
    text position for single-suffix lanes). Lanes pausing at s == 1
    finish in a WALK_T-chunked packed text compare. D10's kernel on the
    card, bwd_entries_plain elsewhere."""
    fn = bwd_entries_kernel if _on_card(codes, fm) else bwd_entries_plain
    return fn(fm, codes, lens, lanes, ref_codes16)


def bwd_entries_kernel(fm: DeviceFMIndex, codes, lens, lanes, ref_codes16,
                       work=None):
    """Launch csrc/sweep_bwd.cu (D10) on CUDA tensors; returns what
    `bwd_entries_plain` returns. `work` as fwd_sweep_kernel's."""
    B, L = codes.shape
    NL = lanes["n"].shape[0]
    dev = codes.device
    what = "sweep_bwd kernel"
    _keep, fm_args = fmops.kernel_args(fm, dev, what)
    arg = lambda x, dt, n: kernels.tensor_arg(x, dev, dt, f"{what}: {n}")
    codes_c = arg(codes, _I32, "codes")
    lens_c = arg(lens, _I32, "lens")
    cols = [arg(lanes[f], _I32, f) for f in ("rid", "anc", "k", "s", "mi")]
    on_c = arg(lanes["on"], torch.bool, "on")
    words = arg(ref_codes16, torch.int64, "ref_codes16")
    if lens_c.shape != (B,) or any(t.shape != (NL,) for t in cols + [on_c]):
        raise ValueError(f"{what}: lens must be [{B}], the lanes [{NL}]")
    m, kf, sf = (torch.empty(NL, dtype=_I32, device=dev) for _ in range(3))
    lib = kernels.load("sweep_bwd")
    kernels.launch(
        "sweep_bwd", lib.fgdp_sweep_bwd, *fm_args, codes_c.data_ptr(),
        lens_c.data_ptr(), *(t.data_ptr() for t in cols), on_c.data_ptr(),
        words.data_ptr(), words.shape[0], B, L, NL, 2 * fm.n_ref,
        m.data_ptr(), kf.data_ptr(), sf.data_ptr(),
        kernels.work_ptr(work, dev, what), device=dev)
    return m, kf, sf


def bwd_entries_plain(fm: DeviceFMIndex, codes, lens, lanes, ref_codes16):
    """The plain version: the JAX package's backward loops as Python loops
    of torch ops, a host sync a step. Both loops compact their
    stragglers (the occ loop into a quarter-width machine, the walk into
    a half-width one), as the JAX package does; each lane's result does
    not depend on when that happens, and the loops test their exit every
    step."""
    NL = lanes["n"].shape[0]
    rid = lanes["rid"]
    mi = lanes["mi"]
    rpacked = pack_reads(codes)

    def body(st, rid_l, mi_l):
        jb = st["m"] - 1
        a = _read_base_at(codes, rid_l, jb)
        b = _read_base_at(codes, rid_l, jb - 1)
        k1, s1, k2, s2 = fmops.backward_extend2(fm, st["k"], st["s"], a, b)
        proc0 = st["alive"] & (jb >= 0) & (a < 4)
        die0 = proc0 & (s1 < mi_l)
        surv0 = proc0 & ~die0
        m1 = torch.where(surv0, jb, st["m"])
        kA = torch.where(surv0, k1, st["k"])
        sA = torch.where(surv0, s1, st["s"])
        pz0 = surv0 & (s1 == 1)

        cont = surv0 & ~pz0
        proc1 = cont & (jb - 1 >= 0) & (b < 4)
        die1 = proc1 & (s2 < mi_l)
        surv1 = proc1 & ~die1
        pz1 = surv1 & (s2 == 1)
        return dict(m=torch.where(surv1, jb - 1, m1),
                    k=torch.where(surv1, k2, kA),
                    s=torch.where(surv1, s2, sA),
                    alive=surv1 & ~pz1,
                    paused=st["paused"] | pz0 | pz1)

    on = lanes["on"]
    st = dict(m=lanes["anc"], k=lanes["k"], s=lanes["s"],
              alive=on & (lanes["s"] > 1) & (lanes["anc"] > 0),
              paused=on & (lanes["s"] == 1))     # mi == 1 whenever s == 1

    NC = max(NL // 4, 8)
    while int(st["alive"].sum()) > NC:
        st = body(st, rid, mi)
    # compact survivors into a quarter-width machine (stable order;
    # results scatter back by origin)
    perm = _alive_first(st["alive"])[:NC]
    sub = {f: v[perm] for f, v in st.items()}
    rid_p, mi_p = rid[perm], mi[perm]
    while bool(sub["alive"].any()):
        sub = body(sub, rid_p, mi_p)
    for f in ("m", "k", "s", "paused"):
        st[f] = st[f].index_put((perm,), sub[f])

    # ---- single-suffix walk epilogue (chunked leftward compare) ----
    pos0 = fmops.sa_lookup(fm, st["k"]) - st["m"]   # text pos of q[0]
    lens_all = lens.to(_I32)[rid.long()]

    def wbody(m, going, rid_l, lens_l, pos0_l):
        rb = read_window(rpacked, rid_l, m - WALK_T, lens_l,
                         WALK_T).flip(1)         # read window, reversed
        tb = packed_window(ref_codes16, 2 * fm.n_ref,
                           pos0_l + m - WALK_T, WALK_T, reverse=True)
        okw = (rb == tb) & (rb < 4) & (tb < 4) & going[:, None]
        hasbad = (~okw).any(dim=1)
        lcp = torch.where(hasbad, first_true(~okw), WALK_T)
        m = torch.where(going, m - lcp, m)
        return m, going & ~hasbad & (m > 0)

    m, going = st["m"], st["paused"] & (st["m"] > 0)
    NW = max(NL // 2, 8)
    while int(going.sum()) > NW:
        m, going = wbody(m, going, rid, lens_all, pos0)
    wperm = _alive_first(going)[:NW]
    wm, wgo = m[wperm], going[wperm]
    rid_w, lens_w, pos0_w = rid[wperm], lens_all[wperm], pos0[wperm]
    while bool(wgo.any()):
        wm, wgo = wbody(wm, wgo, rid_w, lens_w, pos0_w)
    m = m.index_put((wperm,), wm)

    kf = torch.where(st["paused"], -(pos0 + m) - 2, st["k"])
    return m, kf, st["s"]


def _alive_first(flags):
    """Stable order of a flat bool mask with its set entries first (the
    JAX package's argsort(~flags))."""
    return torch.sort((~flags).to(torch.uint8), stable=True).indices


# --------------------------------------------------------------------------
# Emission + merge
# --------------------------------------------------------------------------

def emit_merge(lanes, m, kf, sf, min_seed_len, B: int, max_seeds: int,
               into: SeedBatch | None = None) -> SeedBatch:
    """Apply the per-entry emission rule and scatter seeds into per-read
    buffers in machine order.

    Lanes arrive in (read, anchor, push order): shortest match of each
    anchor first, m non-decreasing within a group. The longest-first
    rule "emit iff m strictly below every longer entry's m" is the
    next-lane compare m_i < m_{i+1} (last of group always passes); the
    machine emission order within a group is reversed push order, so
    the in-read offset is group_base + (group_total - 1 - emits_before)."""
    NL = m.shape[0]
    dev = m.device
    on = lanes["on"]
    rid = lanes["rid"]
    one = torch.ones(1, dtype=torch.bool, device=dev)
    same_next = torch.cat(
        [(rid[1:] == rid[:-1]) & (lanes["anc"][1:] == lanes["anc"][:-1])
         & (lanes["lane"][1:] == lanes["lane"][:-1]) & on[1:] & on[:-1],
         ~one])
    m_next = torch.cat([m[1:], torch.zeros(1, dtype=m.dtype, device=dev)])
    emit = on & (lanes["n"] - m + 1 >= min_seed_len) & \
        (~same_next | (m < m_next))

    rid_eff = torch.where(on, rid, B)            # padding tail sorts last
    seg = torch.cat([one, rid_eff[1:] != rid_eff[:-1]])
    gseg = seg | torch.cat([one, ~same_next[:-1]])   # anchor groups
    cnt = emit.to(_I32)
    csum = torch.cumsum(cnt, 0, dtype=_I32)
    excl = csum - cnt
    seg_base = torch.cummax(torch.where(seg, excl, 0), 0).values
    gbase = torch.cummax(torch.where(gseg, excl, 0), 0).values
    # group emit total, broadcast back over the group (reverse min scan
    # of the inclusive csum at each group's last lane)
    glast = torch.cat([gseg[1:], one])
    gtot_end = torch.cummin(torch.where(glast, csum, 2**30).flip(0),
                            0).values.flip(0)
    gtot = gtot_end - gbase
    off = (gbase - seg_base) + (gtot - 1 - (excl - gbase))
    if into is not None:
        off = off + into.count[rid.long()]
    S = max_seeds
    ovf_l = emit & (off >= S)
    tgt = torch.where(emit & (off < S), off, S).long()

    if into is None:
        into = _empty_seeds(B, S, dev)
    # one scatter for all four seed fields; column S is the drop slot
    # (the JAX package's mode="drop")
    dst = torch.stack([into.m, into.n, into.k, into.s], dim=2)
    dst = torch.cat([dst, torch.zeros((B, 1, 4), dtype=_I32, device=dev)],
                    dim=1)
    dst[rid.long(), tgt] = torch.stack([m, lanes["n"], kf, sf], dim=1)
    dst = dst[:, :S]

    # per-read totals from the sorted-by-read lane layout: csum gathered
    # at each read's last lane
    ends = torch.searchsorted(rid_eff.contiguous(),
                              torch.arange(B, dtype=rid_eff.dtype,
                                           device=dev), right=True)

    def per_read(c):
        tot = torch.where(ends > 0, c[(ends - 1).clamp(min=0)], 0)
        return tot - torch.cat([torch.zeros(1, dtype=tot.dtype,
                                            device=dev), tot[:-1]])

    n_new = per_read(csum)
    ovf = per_read(torch.cumsum(ovf_l.to(_I32), 0, dtype=_I32)) > 0
    new_count = n_new + into.count
    return SeedBatch(
        m=dst[..., 0], n=dst[..., 1], k=dst[..., 2], s=dst[..., 3],
        count=torch.clamp(new_count, max=S),
        overflow=into.overflow | ovf | (new_count > S))


# --------------------------------------------------------------------------
# Drivers
# --------------------------------------------------------------------------

def smem_all_pos_sweep(fm: DeviceFMIndex, dref_codes16, codes, lens,
                       min_intv, active, min_seed_len: int, max_seeds: int,
                       prev_cap: int, entry_cap: int = 0,
                       bwd_mult: int = 0) -> SeedBatch:
    """K1: smem_all_pos semantics via the self-restarting sweep +
    independent backward lanes. entry_cap 0 = auto (generous); bwd_mult
    0 = no lane compaction cap (NL_OUT = B * entry_cap)."""
    B, L = codes.shape
    E = entry_cap or 2 * L + 16
    rid = torch.arange(B, dtype=_I32, device=codes.device)
    fw = fwd_sweep(fm, codes, lens, rid, torch.zeros_like(rid), min_intv,
                   active, prev_cap, E, dref_codes16, restart=True)
    lanes, drop_ovf = flatten_entries(fw, rid, min_intv, E,
                                      B * (bwd_mult or E))
    m, kf, sf = bwd_entries(fm, codes, lens, lanes, dref_codes16)
    seeds = emit_merge(lanes, m, kf, sf, min_seed_len, B, max_seeds)
    return seeds._replace(
        overflow=seeds.overflow | fw["povf"] | fw["eovf"] | drop_ovf)


def smem_lanes_sweep(fm: DeviceFMIndex, dref_codes16, codes, lens, ridx,
                     x, min_intv, active, min_seed_len: int,
                     prev_cap: int, B: int, max_seeds: int,
                     into: SeedBatch | None = None,
                     entry_cap: int = 0, bwd_mult: int = 0,
                     walk: bool = True) -> SeedBatch:
    """K2: one anchor per lane (smem_one_pos_lanes semantics), merged
    straight into per-read SeedBatch buffers in (read, lane) order.
    Lanes must arrive sorted by (read, job order). Pass walk=False when
    every lane's min_intv >= 2 (the forward text-walk branch is then
    dead weight)."""
    NJ = ridx.shape[0]
    E = entry_cap or (prev_cap + 2)
    fw = fwd_sweep(fm, codes, lens, ridx, x, min_intv, active, prev_cap,
                   E, dref_codes16, restart=False, walk=walk)
    # flatten keeps each source lane (job) in lanes["lane"], which the
    # emission groups key on, so jobs of one read stay apart
    lanes, drop_ovf = flatten_entries(fw, ridx, min_intv, E,
                                      NJ * (bwd_mult or E))
    m, kf, sf = bwd_entries(fm, codes, lens, lanes, dref_codes16)
    seeds = emit_merge(lanes, m, kf, sf, min_seed_len, B, max_seeds,
                       into=into)
    povf = any_by(ridx, fw["povf"] | fw["eovf"], B)
    dovf = any_by(ridx, drop_ovf, B)
    return seeds._replace(overflow=seeds.overflow | povf | dovf)
