"""Seed collection driver: K1 + K2 re-seeding + K3, merged and sorted.

Mirrors mem_collect_smem (reference src/bwamem.cpp:771-869):
  K1  all-position SMEMs, min_intv=1 (LCP-tree single-pass engine)
  K2  re-seed at the midpoint of long low-occurrence K1 SMEMs with
      min_intv = occ+1 (ISA jump + LCP-tree ascent engine)
  K3  forward-only interval-capped seeding (max_mem_intv), minSeedLen+1
then a per-read stable sort by (start m, end n).

Port of the JAX package's align/seeding.py on its LCP path; the sweep
and wave-machine engines are not part of the port yet.
"""

from __future__ import annotations

import torch

from ..config import AlignConfig
from ..ops import fm as fmops
from ..ops import smem as smemops
from ..ops import smem_k2lcp
from ..ops import smem_lcp as lcpops
from ..ops.fm import DeviceFMIndex
from ..ops.smem import SeedBatch

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


def compact_order(flags, cap: int):
    """Order-preserving compaction of a flat bool mask: the first `cap`
    set positions in ascending order, padded with len(flags). Returns
    (src int32[min(cap, n)], on bool[min(cap, n)])."""
    n = flags.shape[0]
    key = torch.where(flags, torch.arange(n, dtype=_I32,
                                          device=flags.device), n)
    src = torch.sort(key).values[:cap]
    return src, src < n


def collect_seeds(dfm: DeviceFMIndex, dref, codes, lens, active,
                  opt: AlignConfig, max_seeds: int, lcp_tree, lcp_isa,
                  prev_cap: int = 20, k2_per_read: int = 2,
                  scale: int = 1, k1_emit_cap: int | None = None,
                  k3_emit_cap: int | None = None,
                  k2_scale: int = 0) -> SeedBatch:
    """Returns per-read seed buffers sorted by (m, n); codes int32[B, L].

    Capacities: NK = B*k2_per_read K2 lanes (scaled by k2_scale or
    scale); excess flags overflow."""
    B, L = codes.shape
    dev = codes.device
    split_len = int(opt.min_seed_len * opt.split_factor + 0.499)
    k2s = k2_scale or scale       # K2 pools scale independently of K1
    k2_per_read = k2_per_read * k2s

    s_k1 = min(k1_emit_cap * scale, max_seeds) if k1_emit_cap \
        else max_seeds
    s_k3 = min(k3_emit_cap * scale, max_seeds) if k3_emit_cap \
        else max_seeds
    seeds = lcpops.smem_all_lcp(
        dfm, lcp_tree, lcp_isa, codes, lens, active,
        opt.min_seed_len, s_k1, ref_codes16=dref.codes16,
        max_rounds=24 * scale)
    k1_count = seeds.count

    # --- K2: qualifying K1 SMEMs re-seeded at their midpoint. Jobs are
    # compacted GLOBALLY, ordered by (read, K1 slot) = the reference's
    # matchArray scan order. ---
    S = seeds.m.shape[1]
    slot_valid = torch.arange(S, device=dev)[None, :] < k1_count[:, None]
    qual = slot_valid & ((seeds.n + 1 - seeds.m) >= split_len) & \
        (seeds.s <= opt.split_width)
    NK = B * k2_per_read
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

    job_k = seeds.k.reshape(-1)[qidx]
    job_m = seeds.m.reshape(-1)[qidx]
    pos_occ = torch.where(job_k < -1, -job_k - 2,
                          fmops.sa_lookup(dfm, job_k.clamp(min=0)))
    job_pos = pos_occ + (job_x - job_m)
    job_d0 = seeds.n.reshape(-1)[qidx] - job_x + 1
    seeds = smem_k2lcp.k2_reseed_lcp(
        dfm, lcp_tree, lcp_isa, codes, lens, k_read, job_x, job_mi,
        job_pos, job_d0, k_on, opt.min_seed_len, B, s_k1, into=seeds,
        sj_cap=16 * k2s, ascent_cap=64 * k2s, max_rounds=48 * k2s)

    # --- K3 ---
    if opt.max_mem_intv > 0:
        k3 = smemops.seed_strategy(dfm, codes, lens, active,
                                   opt.max_mem_intv, opt.min_seed_len + 1,
                                   s_k3)
    else:
        k3 = smemops._empty_seeds(B, 1, dev)

    # --- merge + stable per-read sort by (m, n) ---
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
