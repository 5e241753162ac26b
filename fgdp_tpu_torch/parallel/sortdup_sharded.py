"""Contig-range-sharded sort + duplicate marking over a process group.

Port of the JAX package's parallel/sortdup_sharded.py on
torch.distributed. The reference partitions the unified 64-bit
coordinate space into 100 host-memory ranges (sortmardup/main.cpp:
106-115, RangePartitioner tbb/range_partitioner.h:34); here the ranges
are the ranks of one mesh axis. Each rank holds its own records in
arbitrary (aligner-output) order; a capacity-bounded
`all_to_all_single` routes each record to the rank owning its coordinate
range, each rank runs the single-device sort/scan (sortdup/engine.py)
on its range, and the flags ride the reverse exchange back to the
producers.

Range partitioning preserves the reference's key invariant: records
with equal duplicate keys share a 5' coordinate, so equal-key runs
never straddle ranks and the per-rank run scans are exact. The one
cross-rank data flow is the doubles' end indicator (a pair owned by
rank(p5a) may have its p5b end inside another rank's range): those
(p5 + strand*L) keys are routed by their own coordinate, mirroring the
reference's single shared `double_pair_indicator` bitmap.

Every exchange has a fixed capacity per (source, destination) pair, the
same on every rank; a record that does not fit sets the overflow flag
(reduced over the ranks: the caller re-runs with a larger capacity), it
is never dropped silently. The engine's keys are int64, so the JAX
package's (hi, lo) int32 split has no counterpart here.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..sortdup import engine

BIG = engine.BIG


def make_splitters(total: int, n_shards: int, device=None) -> torch.Tensor:
    """Range split points over [0, total): int64[n_shards - 1]. total =
    the doubled coordinate domain 2*L (strand offset included)."""
    return torch.tensor([(total * i) // n_shards
                         for i in range(1, n_shards)],
                        dtype=torch.int64, device=device)


def _dest_of(keys, splitters):
    """Rank index: the number of split points at or below the key."""
    return torch.searchsorted(splitters, keys, right=True)


def _route_out(cols, dest, valid, n: int, cap: int):
    """Group this rank's records into an int64[n, cap, F] send buffer,
    one row of `cap` slots per destination (stable grouping by
    destination, no serial scatter). cols: F int tensors [N]. Returns
    (send buffer, send_valid [n, cap], dest [N], slot [N], overflow)."""
    N = dest.shape[0]
    dev = dest.device
    if N == 0:
        return (torch.full((n, cap, len(cols)), BIG, device=dev),
                torch.zeros((n, cap), dtype=torch.bool, device=dev), dest,
                torch.zeros(0, dtype=torch.int64, device=dev), False)
    dest = torch.where(valid, dest, n)          # invalid -> virtual dest n
    order = torch.sort(dest, stable=True).indices
    dsorted = dest[order]
    start = torch.searchsorted(dsorted, torch.arange(n + 1, device=dev))
    pos = torch.arange(N, device=dev) - start[dsorted]
    overflow = bool(((pos >= cap) & (dsorted < n)).any())
    idx = start[:n, None] + torch.arange(cap, device=dev)[None, :]
    send_valid = idx < start[1:n + 1, None]
    take = order[idx.clamp(0, N - 1)]
    tbl = torch.stack([c.to(torch.int64) for c in cols], dim=1)  # [N, F]
    buf = torch.where(send_valid[:, :, None], tbl[take], BIG)
    slot = torch.zeros(N, dtype=torch.int64, device=dev)
    slot[order] = pos
    return buf, send_valid, dest, slot, overflow


def _exchange(x, group):
    """all_to_all over the leading (destination) dim: row i goes to rank
    i; row i of the result came from rank i."""
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x.contiguous(), group=group)
    return out


def _route(cols, dest, valid, n, cap, group):
    """_route_out + the exchange: the received records as F columns of
    [n * cap] and their valid mask, plus what the reverse trip needs."""
    buf, sv, dest, slot, ovf = _route_out(cols, dest, valid, n, cap)
    rx = _exchange(torch.cat([buf, sv[:, :, None].to(torch.int64)], 2),
                   group).reshape(n * cap, -1)
    return rx[:, :-1].unbind(1), rx[:, -1] == 1, dest, slot, ovf


def _back(flags, dest, slot, valid, n, cap, group):
    """Flags of the received records [n * cap] back to their producers,
    in the producers' input order."""
    back = _exchange(flags.reshape(n, cap).to(torch.uint8), group) == 1
    got = back[dest.clamp(0, n - 1), slot.clamp(0, cap - 1)]
    return got & valid


def _axis(mesh, axis):
    group = mesh.get_group(axis)
    return group, dist.get_world_size(group)


def _common_cap(cap: int, device, group) -> int:
    """The largest of the ranks' capacities (every rank's send buffer
    must have the same shape)."""
    t = torch.tensor([cap], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return int(t.item())


def _any(flag: bool, device, group) -> bool:
    t = torch.tensor([int(flag)], dtype=torch.int64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    return bool(t.item())


def sharded_mark_duplicates(mesh, args: dict, total: int,
                            per_dest_cap: int | None = None,
                            axis: str = "sp"):
    """Duplicate marking over the ranks of `axis`. `args` holds THIS
    rank's records under engine.mark_duplicates' argument names (5'
    positions int64, the other keys int32, *_valid masks, ref_len an
    int); total = 2 * ref_len. Returns this rank's (dup_dbl, dup_sgl) and
    the overflow flag, the same on every rank. per_dest_cap defaults to
    the largest local record count, which never overflows."""
    group, n = _axis(mesh, axis)
    a = args
    dev = a["dbl_p5a"].device
    ref_len = int(a["ref_len"])
    if per_dest_cap is None:
        per_dest_cap = max(a["dbl_p5a"].shape[0], a["sgl_p5"].shape[0], 1)
    cap = _common_cap(per_dest_cap, dev, group)
    split = make_splitters(total, n, dev)
    d_valid, s_valid = a["dbl_valid"], a["sgl_valid"]

    # ---- doubles: route by p5a ----
    d_cols = [a[k] for k in ("dbl_p5a", "dbl_orient", "dbl_p5b",
                             "dbl_score", "dbl_tile", "dbl_x", "dbl_y")]
    rx, rv, d_dest, d_slot, ovf1 = _route(
        d_cols, _dest_of(a["dbl_p5a"], split), d_valid, n, cap, group)
    p5a, orient, p5b, *rest = rx
    dup_d_local = engine.mark_doubles(
        p5a, orient.to(torch.int32), p5b,
        *(c.to(torch.int32) for c in rest), rv)

    # ---- indicator ends: route by their own (p5 + strand*L) key ----
    ind = engine.indicator_keys(a["dbl_p5a"], a["dbl_orient"],
                                a["dbl_p5b"], d_valid, ref_len)
    iv = torch.cat([d_valid, d_valid])
    (ind_rx,), ind_v, _, _, ovf2 = _route(
        [ind], _dest_of(ind, split), iv, n, 2 * cap, group)
    ind_sorted = torch.sort(torch.where(ind_v, ind_rx, BIG)).values

    # ---- singles: route by (p5 + strand*L) so the indicator lookup and
    # the (p5, rev) run key live on the same rank ----
    s_key = a["sgl_p5"] + torch.where(a["sgl_rev"] > 0, ref_len, 0)
    s_cols = [a[k] for k in ("sgl_p5", "sgl_rev", "sgl_score", "sgl_tile",
                             "sgl_x", "sgl_y")]
    rx, sv, s_dest, s_slot, ovf3 = _route(
        s_cols, _dest_of(s_key, split), s_valid, n, cap, group)
    p5, *rest = rx
    dup_s_local = engine.mark_singles(
        p5, *(c.to(torch.int32) for c in rest), sv, ind_sorted, ref_len)

    # ---- flags back to the producers ----
    dup_dbl = _back(dup_d_local, d_dest, d_slot, d_valid, n, cap, group)
    dup_sgl = _back(dup_s_local, s_dest, s_slot, s_valid, n, cap, group)
    return dup_dbl, dup_sgl, _any(ovf1 or ovf2 or ovf3, dev, group)


def sharded_coordinate_sort(mesh, ucoord, valid, total: int,
                            per_dest_cap: int | None = None,
                            axis: str = "sp"):
    """Sort records by unified coordinate across the ranks of `axis`.
    ucoord/valid: THIS rank's records; global index = the record counts
    of the lower ranks + the local index. Returns (int64 global indices
    of the valid records in this rank's coordinate range, sorted, ties
    by global index, and the overflow flag, the same on every rank).
    The ranks' outputs in rank order concatenate to the single-device
    coordinate_sort_order of all records, valid ones only."""
    group, n = _axis(mesh, axis)
    dev = ucoord.device
    N = ucoord.shape[0]
    counts = torch.zeros(n, dtype=torch.int64, device=dev)
    mine = torch.tensor([N], dtype=torch.int64, device=dev)
    dist.all_gather_into_tensor(counts, mine, group=group)
    rank = dist.get_rank(group)
    gidx = int(counts[:rank].sum()) + torch.arange(N, device=dev)
    cap = _common_cap(per_dest_cap or max(N, 1), dev, group)
    split = make_splitters(total, n, dev)
    uc = ucoord.to(torch.int64)
    (uc_rx, g_rx), rv, _, _, ovf = _route(
        [uc, gidx], _dest_of(uc, split), valid, n, cap, group)
    # received in source-rank order, each source's records in input
    # order: gidx ascends, so the stable sort breaks ties by it
    order = engine.coordinate_sort_order(uc_rx, rv)
    return g_rx[order[:int(rv.sum())]], _any(ovf, dev, group)
