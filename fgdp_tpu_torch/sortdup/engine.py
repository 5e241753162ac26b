"""Device coordinate sort + duplicate marking, as torch ops.

The reference streams records through 100 range partitions with per-
partition std::sort and run-scans (sortmardup/main.cpp:129-360) — a CPU
memory workaround. On the card the whole batch lives in device memory:
a multi-key sort replaces partition+sort, a shifted compare replaces the
run scan, and the `double_pair_indicator` bitmap (4x genome bits) becomes
a sorted-membership lookup (same semantics, no giant bitmap).

Port of the JAX package's sortdup/engine.py. Torch has int64, so 5'
positions ride as int64 where the JAX package splits them into (hi, lo)
int32 pairs; the split is monotone (hi = floor(x / 2^30)), so the order
is the same, negative positions included. Torch has no multi-key sort:
`lexsort` composes stable single-key sorts, least significant key first,
and starts from input order, so the input index is the last key and
records that tie on every key keep their input order, as XLA's sort does
(full ties are common: names without Illumina tile:x:y give 0, 0, 0).
Invalid lanes take the largest int64 in every position key, as the JAX
package's padding takes INT32_MAX, and sort last behind their `inval`
key.

Key semantics (tbb/pair.cpp:52-110, main.cpp:236-346):
  * DoublePair key  = (p5_min << 2 | orient, p5_max); orient in
    {FF,FR,RF,RR} by (strand of left end, strand of right end), RF -> FR
    when positions equal
  * SinglePair key  = p5 << 2 | (FF fwd / RR rev)
  * runs of equal keys sorted by (score desc, tile, X, Y): all but the
    first are duplicates; a single whose (p5, strand) matches any double
    end is a duplicate too
"""

from __future__ import annotations

import torch

BIG = torch.iinfo(torch.int64).max


def lexsort(keys):
    """Permutation sorting by `keys` (most significant first), ties
    broken by input index: stable sorts, least significant key first."""
    n = keys[0].shape[0]
    perm = torch.arange(n, device=keys[0].device)
    for k in reversed(keys):
        perm = perm[torch.sort(k[perm], stable=True).indices]
    return perm


def _runs(sorted_keys):
    """same[i]: every key equals element i-1's; element 0 never does."""
    same = torch.ones_like(sorted_keys[0], dtype=torch.bool)
    for k in sorted_keys:
        same &= k == torch.roll(k, 1)
    same[:1] = False
    return same


def _scatter(sidx, vals):
    """vals given in sorted order -> input order."""
    out = torch.zeros_like(vals)
    out[sidx] = vals
    return out


def mark_doubles(dbl_p5a, dbl_orient, dbl_p5b, dbl_score, dbl_tile, dbl_x,
                 dbl_y, dbl_valid):
    """Doubles sort + equal-key run scan -> dup bool[ND] (input order).
    5' positions int64, the rest int32."""
    inval = ~dbl_valid
    pos_keys = [torch.where(dbl_valid, k.to(torch.int64), BIG)
                for k in (dbl_p5a, dbl_orient, dbl_p5b)]
    sidx = lexsort([inval.to(torch.int32)] + pos_keys +
                   [-dbl_score, dbl_tile, dbl_x, dbl_y])
    same = _runs([k[sidx] for k in pos_keys])
    return _scatter(sidx, same & ~inval[sidx])


def indicator_keys(dbl_p5a, dbl_orient, dbl_p5b, dbl_valid, ref_len: int):
    """(p5 + strand*L) keys of every double end (the reference's
    double_pair_indicator bitmap, main.cpp:180-192) -> unsorted
    int64[2*ND]; invalid lanes pushed to the largest int64."""
    # left end strand: orient in {RF, RR} -> reverse; right end: {FR, RR}
    lrev = dbl_orient >= 2
    rrev = (dbl_orient & 1) == 1
    ia = dbl_p5a + torch.where(lrev, ref_len, 0)
    ib = dbl_p5b + torch.where(rrev, ref_len, 0)
    return torch.cat([torch.where(dbl_valid, ia, BIG),
                      torch.where(dbl_valid, ib, BIG)])


def mark_singles(sgl_p5, sgl_rev, sgl_score, sgl_tile, sgl_x, sgl_y,
                 sgl_valid, ind, ref_len: int):
    """Singles sort + run scan + indicator membership -> dup bool[NS].
    `ind` must be sorted ascending."""
    inval = ~sgl_valid
    p5 = torch.where(sgl_valid, sgl_p5, BIG)
    rev = torch.where(sgl_valid, sgl_rev.to(torch.int64), BIG)  # FF 0/RR 3
    sidx = lexsort([inval.to(torch.int32), p5, rev,
                    -sgl_score, sgl_tile, sgl_x, sgl_y])
    p5, rev, inval = p5[sidx], rev[sidx], inval[sidx]
    same = _runs([p5, rev])
    head = ~same & ~inval
    # head duplicate if its (p5 + strand*L) hits the indicator set:
    # first index with key >= target, then equality below n_ind
    target = p5 + torch.where(rev > 0, ref_len, 0)
    n_ind = ind.shape[0]
    fidx = torch.searchsorted(ind, target)
    hit = (fidx < n_ind) & (ind[fidx.clamp(max=n_ind - 1)] == target)
    return _scatter(sidx, (same | (head & hit)) & ~inval)


def mark_duplicates(dbl_p5a, dbl_orient, dbl_p5b, dbl_score, dbl_tile,
                    dbl_x, dbl_y, dbl_valid, sgl_p5, sgl_rev, sgl_score,
                    sgl_tile, sgl_x, sgl_y, sgl_valid, ref_len: int):
    """Returns (dup_dbl bool[ND], dup_sgl bool[NS]) aligned to inputs.

    Tensors on one device; 5' positions int64, the other keys int32,
    *_valid masks lanes to ignore. ND and NS must be at least 1."""
    dup_dbl = mark_doubles(dbl_p5a, dbl_orient, dbl_p5b, dbl_score,
                           dbl_tile, dbl_x, dbl_y, dbl_valid)
    ind = indicator_keys(dbl_p5a, dbl_orient, dbl_p5b, dbl_valid, ref_len)
    ind = torch.sort(ind).values
    dup_sgl = mark_singles(sgl_p5, sgl_rev, sgl_score, sgl_tile, sgl_x,
                           sgl_y, sgl_valid, ind, ref_len)
    return dup_dbl, dup_sgl


def coordinate_sort_order(ucoord, valid):
    """Stable order of records by unified coordinate (invalid last).
    Matches the stable_sort at sortmardup/main.cpp:350-356."""
    key = torch.where(valid, ucoord.to(torch.int64), BIG)
    return torch.sort(key, stable=True).indices
