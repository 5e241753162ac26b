"""Seed buffers and the K3 seed-strategy machine (torch).

Ports the parts of the JAX package's ops/smem.py that the LCP seeding
path runs: the fixed-shape per-read seed buffers, the per-lane append,
merge_lane_seeds (segmented concatenation of per-lane emissions) and the
bwtSeedStrategy forward-only machine (FMI_search.cpp:1400-1488). The
JAX `while_loop` becomes a Python loop over batched tensor steps; the
wave machines of the sweep engines are not part of the port yet.

Seed output layout (fixed shape, per read): (start m, end n inclusive,
SA-interval k, interval size s) + per-read count. Overflow beyond the
buffer capacity is dropped and flagged, exactly as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from . import fm as fmops
from .fm import DeviceFMIndex

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
