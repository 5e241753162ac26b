"""Multi-process wiring: torch.distributed + process-spanning meshes.

Port of the JAX package's parallel/distributed.py. The reference is
single-host (no MPI/NCCL anywhere); here every rank is one process with
one device, a global `DeviceMesh` spans the ranks with the data-parallel
axis outermost, and batches stay sharded: each rank keeps its own rows
and a caller that needs the whole batch gathers it.

  * each rank streams its own FASTQ shard and holds it as its local
    batch (`host_local_batch_to_global`);
  * the index is loaded identically on every rank;
  * sortdup's coordinate ranges map to the ranks of one mesh axis
    (parallel/sortdup_sharded.py's all-to-all routing).

The backend follows the caller's device, never what happens to be
available: NCCL for a CUDA device, gloo for the CPU. One process is a
no-op passthrough, so the same program runs on one card or many.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..utils.device import resolve_device


def backend_for(device) -> str:
    """NCCL for a CUDA device (the card by default; raises without one),
    gloo for the CPU."""
    return "nccl" if resolve_device(device).type == "cuda" else "gloo"


def initialize(coordinator: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device=None) -> int:
    """init_process_group when running multi-process; returns the rank
    (0 when single-process, without touching torch.distributed).
    `coordinator` is an init URL (tcp://host:port, file://path) or a
    bare host:port; `device` chooses the backend (backend_for)."""
    if num_processes is None or num_processes <= 1:
        return 0
    backend = backend_for(device)
    if coordinator and "://" not in coordinator:
        coordinator = "tcp://" + coordinator
    dist.init_process_group(backend, init_method=coordinator,
                            world_size=num_processes, rank=process_id)
    return dist.get_rank()


def global_mesh(axes: dict[str, int] | None = None, device=None):
    """DeviceMesh over ALL ranks (every rank builds the same mesh).
    axes: ordered {name: size}; sizes must multiply to the world size;
    -1 once for 'the rest'. Default: {'dp': -1}. Put 'dp' first so the
    data-parallel axis is outermost."""
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size()
    if axes is None:
        axes = {"dp": -1}
    sizes = list(axes.values())
    if -1 in sizes:
        rest = n // int(np.prod([s for s in sizes if s != -1]) or 1)
        sizes[sizes.index(-1)] = rest
    if int(np.prod(sizes)) != n:
        raise ValueError(f"mesh {dict(zip(axes, sizes))} does not cover "
                         f"the {n} ranks")
    return init_device_mesh(resolve_device(device).type, tuple(sizes),
                            mesh_dim_names=tuple(axes))


class GlobalBatch:
    """One rank's rows of a batch sharded along a mesh axis: `local` is
    this rank's shard, `shape` the global one, `gather()` assembles the
    whole batch on every rank of the axis (all_gather_into_tensor)."""

    def __init__(self, local: torch.Tensor, group, world: int):
        self.local = local
        self.group = group
        self.world = world
        self.shape = (world * local.shape[0],) + tuple(local.shape[1:])

    def gather(self) -> torch.Tensor:
        if self.world == 1:
            return self.local
        out = self.local.new_empty(self.shape)
        dist.all_gather_into_tensor(out, self.local.contiguous(),
                                    group=self.group)
        return out


def host_local_batch_to_global(mesh, tree, axis: str = "dp"):
    """Per-rank local batches (equal row counts) -> GlobalBatch leaves
    sharded along `axis`; the tree is a tensor, or a list, tuple or dict
    of them. With no process group (one process) every leaf is the whole
    batch."""
    if mesh is None:
        group, world = None, 1
    else:
        group = mesh.get_group(axis)
        world = dist.get_world_size(group)
    return _tree_map(lambda a: GlobalBatch(torch.as_tensor(a), group,
                                           world), tree)


def _tree_map(fn, tree):
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_tree_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)
