"""Data-parallel alignment over the ranks of a device mesh.

Port of the data-parallel half of the JAX package's parallel/mesh.py.
The reference scales with pthreads on one host (kt_for work stealing,
src/kthread.cpp:41-115). Here each rank is one process with one device:
read batches split along axis "dp" while the FM index and reference are
replicated (every rank loads them), each rank runs the device program on
its rows, and the packed regs are gathered (all_gather_into_tensor).

The index-sharding half (`make_mesh_2d`, `shard_index`,
`shard_align_fn_2d`) is not ported: in JAX, XLA partitions every FM
gather across the "fm" axis; in torch that is an exchange inside every
seeding step.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

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


def gathered_regs(bufs) -> dict:
    """Packed reg buffers of consecutive row blocks (shard_align_fn's
    output) -> one regs dict over the whole batch, as unpack_regs
    gives for one buffer."""
    from ..pipeline import unpack_regs

    parts = [unpack_regs(b) for b in np.asarray(bufs.cpu())]
    return {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
