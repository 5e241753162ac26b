"""Seed collection driver: K1 + K2 re-seeding + K3, merged and sorted.

Mirrors mem_collect_smem (reference src/bwamem.cpp:771-869):
  K1  all-position SMEMs, min_intv=1
  K2  re-seed at the midpoint of long low-occurrence K1 SMEMs with
      min_intv = occ+1
  K3  forward-only interval-capped seeding (max_mem_intv), minSeedLen+1
then a per-read stable sort by (start m, end n).

Port of the JAX package's align/seeding.py with its three engines:
given an LCP tree, K1 is the single-pass LCP engine (ops/smem_lcp.py)
and K2 the ISA-jump + tree-ascent engine (ops/smem_k2lcp.py);
FGDP_K2_SWEEP=1 sends K2 to the sweep instead. Without a tree, K1 and
K2 run the self-restarting sweep (ops/smem_sweep.py), or with
use_sweep=False the wave machine (ops/smem.py).

On the card with a whole FM table, the LCP engine's K1 and K2 and every
engine's K3 are one kernel launch each (csrc/smem_lcp.cu, k2_lcp.cu,
seed_strategy.cu); what stays torch ops here has no loop: K2's job
compaction (k2_jobs, lcp_job_pos), merge_lane_seeds and the final stable
sort (merge_sorted).
"""

from __future__ import annotations

import os

import torch

from ..config import AlignConfig
from ..ops import fm as fmops
from ..ops import smem as smemops
from ..ops import smem_k2lcp
from ..ops import smem_lcp as lcpops
from ..ops import smem_sweep as sweepops
from ..ops.fm import DeviceFMIndex
from ..ops.smem import SeedBatch, compact_order

INT32_MAX = 2**31 - 1
_I32 = torch.int32


def stable_sort2(key1, key2, *payload, dim: int = 1):
    """Stable lexicographic sort by (key1, key2) along `dim`, payload
    riding along: two stable sorts, the minor key first (torch's sort
    is unstable unless asked; the JAX package uses lax.sort with
    is_stable=True, num_keys=2)."""
    o2 = torch.sort(key2, dim=dim, stable=True).indices
    k1 = key1.gather(dim, o2)
    o1 = torch.sort(k1, dim=dim, stable=True).indices
    order = o2.gather(dim, o1)
    return tuple(a.gather(dim, order) for a in (key1, key2) + payload)


def k2_jobs(seeds: SeedBatch, opt: AlignConfig, split_len: int, NK: int):
    """K2's jobs: the K1 SMEMs of at least split_len bases and at most
    split_width occurrences, compacted GLOBALLY in (read, K1 slot) order
    (the reference's matchArray scan order) into NK lanes. Returns
    (qidx, k_read, job_x, job_mi, k_on, k2_overflow): the flat K1 slot,
    read, midpoint and min_intv = occ + 1 of each lane, the lanes in use,
    and the reads that own a job ranked past NK."""
    B, S = seeds.m.shape
    dev = seeds.m.device
    slot_valid = torch.arange(S, device=dev)[None, :] < seeds.count[:, None]
    qual = slot_valid & ((seeds.n + 1 - seeds.m) >= split_len) & \
        (seeds.s <= opt.split_width)
    fq = qual.reshape(-1)
    l_src, k_on = compact_order(fq, NK)
    qidx = torch.where(k_on, l_src, 0).long()
    k_read = (qidx // S).to(_I32)
    job_x = ((seeds.m + seeds.n + 1) >> 1).reshape(-1)[qidx]
    job_mi = (seeds.s + 1).reshape(-1)[qidx]
    # a read overflows iff it owns a qual job ranked past NK
    ends = torch.cumsum(fq.to(_I32), 0, dtype=_I32).reshape(B, S)[:, -1]
    starts = torch.cat([torch.zeros(1, dtype=_I32, device=dev), ends[:-1]])
    k2_overflow = (ends > NK) & (ends > starts)
    return qidx, k_read, job_x, job_mi, k_on, k2_overflow


def lcp_job_pos(dfm: DeviceFMIndex, seeds: SeedBatch, qidx, job_x):
    """The LCP K2 jobs' text position of q[job_x ..] (from the parent
    seed's SA entry, or its direct position k = -pos - 2) and the match
    length trusted from job_x (parent n - job_x + 1)."""
    job_k = seeds.k.reshape(-1)[qidx]
    job_m = seeds.m.reshape(-1)[qidx]
    pos_occ = torch.where(job_k < -1, -job_k - 2,
                          fmops.sa_lookup(dfm, job_k.clamp(min=0)))
    job_pos = pos_occ + (job_x - job_m)
    job_d0 = seeds.n.reshape(-1)[qidx] - job_x + 1
    return job_pos, job_d0


def collect_seeds(dfm: DeviceFMIndex, dref, codes, lens, active,
                  opt: AlignConfig, max_seeds: int, prev_cap: int = 20,
                  k2_per_read: int = 2, lane_emit_cap: int = 16,
                  use_sweep: bool = True, scale: int = 1,
                  lcp_tree=None, lcp_isa=None,
                  k1_emit_cap: int | None = None,
                  k3_emit_cap: int | None = None,
                  k2_scale: int = 0) -> SeedBatch:
    """Returns per-read seed buffers sorted by (m, n); codes int32[B, L].

    Capacities: NK = B*k2_per_read K2 lanes (scaled by k2_scale or
    scale); `scale` widens every seeding-internal cap (the overflow
    escalation ladder); excess flags overflow."""
    B, L = codes.shape
    dev = codes.device
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    k2s = k2_scale or scale       # K2 pools scale independently of K1
    prev_cap = prev_cap * k2s
    k2_per_read = k2_per_read * k2s

    s_k1 = min(k1_emit_cap * scale, max_seeds) if k1_emit_cap \
        else max_seeds
    s_k3 = min(k3_emit_cap * scale, max_seeds) if k3_emit_cap \
        else max_seeds
    ones = torch.ones(B, dtype=_I32, device=dev)
    if lcp_tree is not None:
        seeds = lcpops.smem_all_lcp(
            dfm, lcp_tree, lcp_isa, codes, lens, active,
            opt.min_seed_len, s_k1, ref_codes16=dref.codes16,
            max_rounds=24 * scale)
    elif use_sweep:
        seeds = sweepops.smem_all_pos_sweep(
            dfm, dref.codes16, codes, lens, ones, active,
            opt.min_seed_len, s_k1, prev_cap,
            entry_cap=min(2 * L + 16, 192 * scale), bwd_mult=44 * scale)
    else:
        seeds = smemops.smem_all_pos(
            dfm, dref.codes, dref.l_pac, codes, lens, ones, active,
            opt.min_seed_len, s_k1, prev_cap, ref_codes16=dref.codes16)

    # --- K2: qualifying K1 SMEMs re-seeded at their midpoint ---
    S = seeds.m.shape[1]
    qidx, k_read, job_x, job_mi, k_on, k2_overflow = k2_jobs(
        seeds, opt, split_len, B * k2_per_read)

    if lcp_tree is not None and os.environ.get("FGDP_K2_SWEEP") != "1":
        job_pos, job_d0 = lcp_job_pos(dfm, seeds, qidx, job_x)
        seeds = smem_k2lcp.k2_reseed_lcp(
            dfm, lcp_tree, lcp_isa, codes, lens, k_read, job_x, job_mi,
            job_pos, job_d0, k_on, opt.min_seed_len, B, s_k1, into=seeds,
            sj_cap=16 * k2s, ascent_cap=64 * k2s, max_rounds=48 * k2s)
    elif use_sweep:
        # walk=False: K2 min_intv = occ + 1 >= 2, the s == 1 walk branch
        # cannot trigger
        seeds = sweepops.smem_lanes_sweep(
            dfm, dref.codes16, codes, lens, k_read, job_x, job_mi, k_on,
            opt.min_seed_len, prev_cap, B, s_k1, into=seeds,
            entry_cap=prev_cap + 2, bwd_mult=16 * k2s, walk=False)
    else:
        k2lanes, _ = smemops.smem_one_pos_lanes(
            dfm, dref.codes, dref.l_pac, codes, lens, k_read, job_x,
            job_mi, k_on, opt.min_seed_len, prev_cap, lane_emit_cap,
            ref_codes16=dref.codes16)
        seeds = smemops.merge_lane_seeds(k2lanes, k_read,
                                         (qidx % S).to(_I32), k_on, B,
                                         s_k1, into=seeds)
    # --- K3 ---
    if opt.max_mem_intv > 0:
        k3 = smemops.seed_strategy(dfm, codes, lens, active,
                                   opt.max_mem_intv, opt.min_seed_len + 1,
                                   s_k3)
    else:
        k3 = smemops._empty_seeds(B, 1, dev)

    return merge_sorted(seeds, k3, k2_overflow)


def merge_sorted(seeds: SeedBatch, k3: SeedBatch, k2_overflow) -> SeedBatch:
    """K1 + K2 seeds and K3 seeds in one buffer a read, stably sorted by
    (m, n); the overflow flags of both and of K2's job compaction."""
    dev = seeds.m.device
    m = torch.cat([seeds.m, k3.m], dim=1)
    n = torch.cat([seeds.n, k3.n], dim=1)
    k = torch.cat([seeds.k, k3.k], dim=1)
    s = torch.cat([seeds.s, k3.s], dim=1)
    St = m.shape[1]
    valid = torch.cat(
        [torch.arange(seeds.m.shape[1], device=dev)[None, :]
         < seeds.count[:, None],
         torch.arange(k3.m.shape[1], device=dev)[None, :]
         < k3.count[:, None]], dim=1)
    key_m = torch.where(valid, m, INT32_MAX)
    key_n = torch.where(valid, n, INT32_MAX)
    key_m, key_n, k, s = stable_sort2(key_m, key_n, k, s)
    count = (seeds.count + k3.count).to(_I32)
    out_valid = torch.arange(St, device=dev)[None, :] < count[:, None]
    return SeedBatch(
        m=torch.where(out_valid, key_m, 0),
        n=torch.where(out_valid, key_n, 0),
        k=k, s=s, count=count,
        overflow=seeds.overflow | k3.overflow | k2_overflow,
    )
