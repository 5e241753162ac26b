"""Alignment over the ranks of a device mesh.

Port of the JAX package's parallel/mesh.py. The reference scales with
pthreads on one host (kt_for work stealing, src/kthread.cpp:41-115).
Here each rank is one process with one device.

Data-parallel half: read batches split along axis "dp" while the FM
index and reference are replicated (every rank loads them), each rank
runs the device program on its rows, and the packed regs are gathered
(all_gather_into_tensor).

Index-sharding half (the TP analogue): a 2-D mesh (dp, fm) range-shards
the occ checkpoint rows and the SA along "fm" (shard_index), so an index
larger than one card spreads over the axis. Where XLA partitions each
gather into a local gather plus a combine across "fm", every gather of
the two tables here goes through ops/fm.gather_rows: the rows a rank
owns, zeros elsewhere, all_reduce(SUM) over the fm group. The batch is
split on dp and replicated on fm, so every rank of an fm group runs the
same steps on the same reads and takes the same host decisions, which
keeps the collectives in lockstep.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..ops.fm import ShardedRows
from ..utils.device import resolve_device
from .distributed import _tree_map


def make_mesh(n_devices: int | None = None, axis: str = "dp", device=None):
    """1-D DeviceMesh over the ranks of the default process group (one
    device each); n_devices, when given, must equal the world size."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"{n_devices} devices asked for, {n} ranks run")
    return init_device_mesh(resolve_device(device).type, (n,),
                            mesh_dim_names=(axis,))


def _rows(mesh, axis, n_rows):
    group = mesh.get_group(axis)
    world = dist.get_world_size(group)
    rank = dist.get_rank(group)
    if n_rows % world:
        raise ValueError(f"batch of {n_rows} rows does not split over "
                         f"{world} ranks")
    per = n_rows // world
    return slice(rank * per, (rank + 1) * per)


def shard_batch(mesh, tree, axis: str = "dp"):
    """This rank's rows of batch-leading arrays (the leading dim must
    divide by the axis' size), as tensors on the mesh's device."""
    dev = torch.device(mesh.device_type)
    return _tree_map(lambda a: torch.as_tensor(
        a[_rows(mesh, axis, a.shape[0])], device=dev), tree)


def replicate(mesh, tree):
    """Every rank holds the whole of `tree` on the mesh's device (the
    index is loaded by every rank, so this only places it)."""
    dev = torch.device(mesh.device_type)
    return _tree_map(lambda a: a.to(dev) if isinstance(a, torch.Tensor)
                     else a, tree)


def shard_align_fn(fn, mesh, axis: str = "dp"):
    """Wrap `fn(dfm, dref, codes, lens, active)` (device_align_packed
    with its options bound) so each rank runs it on its rows of the
    global batch with the index replicated. The wrapped call returns the
    ranks' packed reg buffers, int32[world, n], in rank order
    (`gathered_regs` unpacks them into one batch)."""
    group = mesh.get_group(axis)
    world = dist.get_world_size(group)

    def run(dfm, dref, codes, lens, active):
        local = fn(dfm, dref, *shard_batch(mesh, (codes, lens, active),
                                           axis))
        out = local.new_empty((world * local.shape[0],)
                              + tuple(local.shape[1:]))
        dist.all_gather_into_tensor(out, local.contiguous(), group=group)
        return out.view((world,) + tuple(local.shape))

    return run


def make_mesh_2d(n_devices: int | None = None, fm_ways: int = 2,
                 axes=("dp", "fm"), device=None):
    """2-D DeviceMesh over the ranks of the default process group: a
    data-parallel axis and an index-sharding axis of fm_ways ranks (cut
    down to a divisor of the world size). Ranks r // fm_ways share a dp
    row, consecutive ranks an fm group, as the JAX package's reshape
    lays the devices out."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if n_devices is not None and n_devices != n:
        raise ValueError(f"{n_devices} devices asked for, {n} ranks run")
    fm_ways = min(fm_ways, n)
    while n % fm_ways:
        fm_ways -= 1
    return init_device_mesh(resolve_device(device).type,
                            (n // fm_ways, fm_ways), mesh_dim_names=axes)


def _pad_rows(a, ways: int):
    """a with zero rows appended up to a multiple of `ways`."""
    pad = (-a.shape[0]) % ways
    if pad == 0:
        return a
    return torch.cat([a, a.new_zeros((pad,) + tuple(a.shape[1:]))])


def shard_index(mesh, dfm, axis: str = "fm"):
    """Range-shard the big FM-index tables (occ checkpoint rows, SA)
    along `axis`: this rank keeps its contiguous block of the tables
    padded to a multiple of the axis' size; the small arrays and the
    scalars stay replicated. Gathers clamp to the global row count, so
    padded rows are never read."""
    group = mesh.get_group(axis)
    ways = dist.get_world_size(group)
    rank = dist.get_rank(group)

    def shard(a):
        per = -(-a.shape[0] // ways)
        block = _pad_rows(a, ways)[rank * per:(rank + 1) * per].clone()
        return ShardedRows(block, rank * per, a.shape[0], group)

    return dfm._replace(occ_fused=shard(dfm.occ_fused), sa=shard(dfm.sa))


def shard_align_fn_2d(fn, mesh, dp_axis: str = "dp"):
    """The align step over a (dp, fm) mesh: `fn(dfm, dref, codes, lens,
    active)` runs on this rank's dp rows with the index as the caller
    passes it (shard_index's for the fm-sharded tables); the packed regs
    are gathered along dp, as shard_align_fn gathers them."""
    return shard_align_fn(fn, mesh, dp_axis)


def gathered_regs(bufs) -> dict:
    """Packed reg buffers of consecutive row blocks (shard_align_fn's
    output) -> one regs dict over the whole batch, as unpack_regs
    gives for one buffer."""
    from ..pipeline import unpack_regs

    parts = [unpack_regs(b) for b in np.asarray(bufs.cpu())]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
