"""K2 re-seeding via ISA jump + LCP-tree ascent — the fmi_shrink analogue.

Port of the JAX package's ops/smem_k2lcp.py. The reference's K2 stage
re-seeds long low-occurrence K1 SMEMs at their midpoint x with
min_intv = occ+1 (mem_collect_smem, reference src/bwamem.cpp:1016-1040).
A K2 job knows an occurrence position of its parent K1 SMEM, so the
interval of q[x..n] needs no forward search:

  1. ISA jump: row = isa[pos_x]; one gather.
  2. Tree ascent to the minimal-depth ancestor with depth >= |q[x..n]|,
     then on while its size is < min_intv (fmi_shrink).
  3. Lanes whose interval at q[x..n] meets min_intv extend forward with
     forward_extend2 (the RC side from a mirrored ISA jump).
  4. Backward pass: the K1 single-pass engine with the death threshold
     s >= min_intv and a stop when the match no longer covers x.

On the card steps 1-4 are one launch of the hand-written kernel
csrc/k2_lcp.cu (D3, on the rank device functions of csrc/fm.cuh, D1),
and merge_lane_seeds scatters its lane rows into the reads' rows.
`k2_reseed_lcp_plain` beside it is the same function with each JAX
`while_loop` a Python loop of batched steps. The ascent and forward
loops are no-ops for finished lanes, but the ascent's step cap counts
steps, so both test their exit condition before every step as the JAX
package does; the wave loops test their population conditions before
every step too, since those decide the overflow flags.

`k2_reseed_lcp` takes the kernel for CUDA tensors with a whole FM table,
and the plain version for CPU tensors and for a table of ShardedRows;
a failing launch raises.
"""

from __future__ import annotations

import torch

from . import fm as fmops
from . import kernels
from .smem import LaneSeeds, _append_seed, any_by, merge_lane_seeds
from .smem import _read_base_at

MODE_EXT = 0
MODE_SHR = 1
MODE_DEAD = 2

INT32_MAX = 2**31 - 1
_I32 = torch.int32


def _ascend(tree, N, row, on, depth_floor, size_goal, cap: int):
    """Walk up the LCP-interval tree from leaf [row, row+1).

    Ascends while the parent's depth >= depth_floor OR the current size
    < size_goal. Returns (lo, hi, depth, ovf): the final node span, its
    effective depth (clipped to depth_floor), and a step-cap overflow
    flag."""
    lo, hi = row, row + 1
    dpt = torch.full_like(row, INT32_MAX)
    go = on
    steps = 0
    while steps < cap and bool(go.any()):
        t_lo = tree[lo.clamp(0, N).long()]
        t_hi = tree[hi.clamp(0, N).long()]
        pick_lo = t_lo[:, 0] >= t_hi[:, 0]
        e = torch.where(pick_lo[:, None], t_lo, t_hi)
        pd = e[:, 0]
        s_cur = hi - lo
        accept = go & ((pd >= depth_floor) | (s_cur < size_goal))
        lo = torch.where(accept, e[:, 1], lo)
        hi = torch.where(accept, e[:, 2], hi)
        dpt = torch.where(accept, pd, dpt)
        go = accept
        steps += 1
    return lo, hi, torch.minimum(dpt, depth_floor), go


def k2_reseed_lcp(fm: fmops.DeviceFMIndex, tree, isa, codes, lens,
                  k_read, job_x, job_mi, job_pos, job_d0, k_on,
                  min_seed_len: int, B: int, max_seeds: int,
                  into=None, sj_cap: int = 16, ascent_cap: int = 64,
                  max_rounds: int = 48):
    """One K2 job per lane. job_pos: text position of the occurrence of
    q[job_x ..] backing the job; job_d0 = parent_n - job_x + 1 (trusted
    match length from x). Returns the merged per-read SeedBatch
    (into=K1 seeds)."""
    fn = k2_reseed_lcp_kernel if codes.is_cuda and \
        not fmops.is_sharded(fm) else k2_reseed_lcp_plain
    return fn(fm, tree, isa, codes, lens, k_read, job_x, job_mi, job_pos,
              job_d0, k_on, min_seed_len, B, max_seeds, into=into,
              sj_cap=sj_cap, ascent_cap=ascent_cap, max_rounds=max_rounds)


def _merge(lanes: LaneSeeds, lane_ovf, k_read, k_on, B, max_seeds, into):
    """The lanes' rows merged into the reads' (after `into`); a read
    flags overflow where one of its jobs does."""
    seeds = merge_lane_seeds(lanes, k_read, torch.zeros_like(k_read),
                             k_on, B, max_seeds, into=into)
    ovf = any_by(k_read, lane_ovf & k_on, B)
    return seeds._replace(overflow=seeds.overflow | ovf)


def launch_grid(NK: int, device):
    """(blocks, threads) of k2_reseed_lcp_kernel's launch of NK jobs."""
    lib = kernels.load("k2_lcp")
    return kernels.coop_grid("k2_lcp", lib.fgdp_k2_lcp_grid, NK, device)


def k2_reseed_lcp_kernel(fm, tree, isa, codes, lens, k_read, job_x,
                         job_mi, job_pos, job_d0, k_on, min_seed_len: int,
                         B: int, max_seeds: int, into=None, sj_cap: int = 16,
                         ascent_cap: int = 64, max_rounds: int = 48,
                         work=None):
    """Launch csrc/k2_lcp.cu on CUDA tensors and merge its lane rows;
    returns what `k2_reseed_lcp_plain` returns. `work` as
    smem_lcp.smem_all_lcp_kernel's."""
    NK = k_read.shape[0]
    L = codes.shape[1]
    dev = codes.device
    what = "k2_lcp kernel"
    _keep, fm_args = fmops.kernel_args(fm, dev, what)
    arg = lambda x, dt, n: kernels.tensor_arg(x, dev, dt, f"{what}: {n}")
    tree_c = arg(tree, _I32, "tree")
    isa_c = arg(isa, _I32, "isa")
    codes_c = arg(codes, _I32, "codes")
    lens_c = arg(lens, _I32, "lens")
    jobs = [arg(x, _I32, n) for x, n in (
        (k_read, "k_read"), (job_x, "job_x"), (job_mi, "job_mi"),
        (job_pos, "job_pos"), (job_d0, "job_d0"))]
    on_c = arg(k_on, torch.bool, "k_on")
    if any(x.shape != (NK,) for x in jobs + [on_c]) or tree_c.dim() != 2 \
            or tree_c.shape[1] != 4:
        raise ValueError(f"{what}: the job arrays must be [{NK}], tree "
                         "[N + 1, 4]")
    m, n, k, s = (torch.zeros((NK, sj_cap), dtype=_I32, device=dev)
                  for _ in range(4))
    count = torch.empty(NK, dtype=_I32, device=dev)
    lane_ovf = torch.empty(NK, dtype=torch.bool, device=dev)
    lib = kernels.load("k2_lcp")
    slots = torch.zeros(6, dtype=torch.int64, device=dev)
    blk = torch.empty(lib.fgdp_k2_lcp_max_blocks(NK), dtype=_I32,
                      device=dev)
    kernels.launch(
        "k2_lcp", lib.fgdp_k2_lcp, *fm_args, tree_c.data_ptr(),
        isa_c.data_ptr(), codes_c.data_ptr(), lens_c.data_ptr(),
        *(x.data_ptr() for x in jobs), on_c.data_ptr(), NK, L,
        tree_c.shape[0] - 1, 2 * fm.n_ref, min_seed_len, sj_cap, ascent_cap,
        max_rounds, m.data_ptr(), n.data_ptr(), k.data_ptr(), s.data_ptr(),
        count.data_ptr(), lane_ovf.data_ptr(), slots.data_ptr(),
        blk.data_ptr(), kernels.work_ptr(work, dev, what), device=dev)
    lanes_out = LaneSeeds(m=m, n=n, k=k, s=s, count=count, overflow=lane_ovf)
    return _merge(lanes_out, lane_ovf, k_read, k_on, B, max_seeds, into)


def k2_reseed_lcp_plain(fm: fmops.DeviceFMIndex, tree, isa, codes, lens,
                        k_read, job_x, job_mi, job_pos, job_d0, k_on,
                        min_seed_len: int, B: int, max_seeds: int,
                        into=None, sj_cap: int = 16, ascent_cap: int = 64,
                        max_rounds: int = 48):
    """The plain version: the JAX package's k2_reseed_lcp as Python loops
    of torch ops."""
    NK = k_read.shape[0]
    dev = codes.device
    N = tree.shape[0] - 1
    lens_l = lens.to(_I32)[k_read.long()]
    msl = min_seed_len
    l2ref = 2 * fm.n_ref

    # ---- 1+2. ISA jump + ascent to the interval of q[x..n] ----
    row = isa[job_pos.clamp(0, N - 1).long()]
    lo, hi, dpt, asc_ovf = _ascend(tree, N, row, k_on, job_d0, job_mi,
                                   ascent_cap)

    # ---- 3. forward extension past the parent SMEM's right end ----
    n0 = job_x + dpt - 1
    fwd_need = k_on & (dpt >= job_d0) & (n0 + 1 < lens_l)
    mrow = isa[(l2ref - job_pos - job_d0).clamp(0, N - 1).long()]
    mlo, _, _, masc_ovf = _ascend(tree, N, mrow, fwd_need, job_d0,
                                  torch.ones_like(job_mi), ascent_cap)

    fk, fl, fs, fn, alive = lo, mlo, hi - lo, n0, fwd_need
    while bool(alive.any()):
        j = fn + 1
        a = _read_base_at(codes, k_read, j)
        b = _read_base_at(codes, k_read, j + 1)
        (k1, l1, s1), (k2, l2, s2) = fmops.forward_extend2(fm, fk, fl, fs,
                                                           a, b)
        ok0 = alive & (j < lens_l) & (a < 4) & (s1 >= job_mi)
        kA = torch.where(ok0, k1, fk)
        lA = torch.where(ok0, l1, fl)
        sA = torch.where(ok0, s1, fs)
        nA = torch.where(ok0, j, fn)
        j1 = j + 1
        ok1 = ok0 & (j1 < lens_l) & (b < 4) & (s2 >= job_mi)
        fk = torch.where(ok1, k2, kA)
        fl = torch.where(ok1, l2, lA)
        fs = torch.where(ok1, s2, sA)
        fn = torch.where(ok1, j1, nA)
        alive = ok1

    # ---- 4. backward single-pass with threshold min_intv ----
    zL = torch.zeros((NK, sj_cap), dtype=_I32, device=dev)
    st = dict(
        l=job_x.to(_I32),
        r=torch.where(fwd_need, fn + 1, job_x + dpt).to(_I32),
        lo=torch.where(fwd_need, fk, lo).to(_I32),
        hi=torch.where(fwd_need, fk + fs, hi).to(_I32),
        lastl=torch.full((NK,), INT32_MAX, dtype=_I32, device=dev),
        mode=torch.where(k_on, MODE_EXT, MODE_DEAD).to(_I32),
        seeds=LaneSeeds(m=zL, n=zL, k=zL, s=zL,
                        count=torch.zeros(NK, dtype=_I32, device=dev),
                        overflow=torch.zeros(NK, dtype=torch.bool,
                                             device=dev)),
    )

    def ext_body(st):
        l, r, lo_, hi_ = st["l"], st["r"], st["lo"], st["hi"]
        s = hi_ - lo_
        act = st["mode"] == MODE_EXT
        at_end = act & (l == 0)
        a = _read_base_at(codes, k_read, l - 1)
        b = _read_base_at(codes, k_read, l - 2)
        k1, s1, k2, s2 = fmops.backward_extend2(fm, lo_, s, a, b)
        va = a < 4
        try1 = act & ~at_end & va
        ok1 = try1 & (s1 >= job_mi)
        stuck1 = try1 & ~(s1 >= job_mi)
        bad1 = act & ~at_end & ~va          # N char: job cannot cross
        emit1 = (at_end | stuck1 | bad1) & (r - l >= msl) \
            & (l < st["lastl"])
        l1x = torch.where(ok1, l - 1, l)
        lo1x = torch.where(ok1, k1, lo_)
        hi1x = torch.where(ok1, k1 + s1, hi_)

        # ---- step 2 (lanes that took step 1) ----
        at_end2 = ok1 & (l1x == 0)
        vb = b < 4
        bad2 = ok1 & ~at_end2 & ~vb
        try2 = ok1 & ~at_end2 & vb
        ok2 = try2 & (s2 >= job_mi)
        stuck2 = try2 & ~(s2 >= job_mi)
        emit2 = (at_end2 | stuck2 | bad2) & (r - l1x >= msl) \
            & (l1x < st["lastl"])
        seeds = _append_seed(st["seeds"], emit1 | emit2,
                             torch.where(emit2, l1x, l), r - 1,
                             torch.where(emit2, k1, lo_),
                             torch.where(emit2, s1, s))
        lastl = torch.where(emit1, l, torch.where(emit2, l1x, st["lastl"]))
        l2x = torch.where(ok2, l1x - 1, l1x)
        lo2x = torch.where(ok2, k2, lo1x)
        hi2x = torch.where(ok2, k2 + s2, hi1x)

        dead = at_end | bad1 | at_end2 | bad2
        to_shr = stuck1 | stuck2
        mode = torch.where(dead, MODE_DEAD,
                           torch.where(to_shr, MODE_SHR, st["mode"]))
        return dict(l=l2x.to(_I32), r=r, lo=lo2x.to(_I32),
                    hi=hi2x.to(_I32), lastl=lastl.to(_I32),
                    mode=mode.to(_I32), seeds=seeds)

    def shr_body(st):
        act = st["mode"] == MODE_SHR
        l, lo_, hi_ = st["l"], st["lo"], st["hi"]
        t_lo = tree[lo_.clamp(0, N).long()]
        t_hi = tree[hi_.clamp(0, N).long()]
        pick_lo = t_lo[:, 0] >= t_hi[:, 0]
        e = torch.where(pick_lo[:, None], t_lo, t_hi)
        d = e[:, 0].clamp(min=0)
        new_r = l + d
        covers = new_r > job_x              # match must still contain x
        a = _read_base_at(codes, k_read, l - 1)
        can = ((e[:, 3] >> a.clamp(0, 3)) & 1) == 1
        mode = torch.where(act & ~covers, MODE_DEAD,
                           torch.where(act & can, MODE_EXT, st["mode"]))
        return dict(l=l,
                    r=torch.where(act, new_r, st["r"]).to(_I32),
                    lo=torch.where(act, e[:, 1], lo_).to(_I32),
                    hi=torch.where(act, e[:, 2], hi_).to(_I32),
                    lastl=st["lastl"], mode=mode.to(_I32),
                    seeds=st["seeds"])

    def wave(st, m, body):
        while True:
            mode = st["mode"]
            cm = int((mode == m).sum())
            live = int((mode != MODE_DEAD).sum())
            if not cm > (live >> 3):
                return st
            st = body(st)

    rnd = 0
    while rnd < max_rounds and bool((st["mode"] != MODE_DEAD).any()):
        rnd += 1
        st = wave(st, MODE_EXT, ext_body)
        st = wave(st, MODE_SHR, shr_body)
    unfinished = st["mode"] != MODE_DEAD

    lanes = st["seeds"]
    lane_ovf = lanes.overflow | asc_ovf | masc_ovf | unfinished
    return _merge(lanes, lane_ovf, k_read, k_on, B, max_seeds, into)
