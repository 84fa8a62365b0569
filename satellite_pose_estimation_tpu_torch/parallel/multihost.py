"""Multi-process (multi-host) support (counterpart of parallel/multihost.py).

The reference's DDP layer discovers ranks from env:// or SLURM
(R1/utils/misc.py:415-440, R2/src/misc/dist.py:23-51). Here:

* every process calls :func:`init_distributed` (a coordinator address, the
  world size and this rank, from the arguments or the environment), then
  builds one :func:`global_mesh` over the world;
* each process feeds only its own rows (:func:`host_sharded_batch`: no
  sampler object, the data split is the sharding);
* per-process host values merge with :func:`allgather_object`, stacked
  along a leading process axis as JAX's ``process_allgather`` stacks them,
  and :func:`replicate_global` broadcasts rank 0's.

A launched world on one host (``python -m torch.distributed.run``) is the
same thing; ``parallel.mesh`` serves it.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from .mesh import Mesh, create_mesh, is_passthrough, join_world


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None, device="cuda"):
    """``mesh.join_world`` over TCP, with env:// style discovery.

    Environment variables (torchrun's names): COORDINATOR_ADDRESS (host:port)
    or MASTER_ADDR and MASTER_PORT (29500 by default), WORLD_SIZE, RANK.
    Returns this rank's device (``mesh.rank_device(device)``)."""
    if coordinator_address is None:
        coordinator_address = os.environ.get("COORDINATOR_ADDRESS")
        if coordinator_address is None and "MASTER_ADDR" in os.environ:
            coordinator_address = (f"{os.environ['MASTER_ADDR']}:"
                                   f"{os.environ.get('MASTER_PORT', '29500')}")
    if num_processes is None and "WORLD_SIZE" in os.environ:
        num_processes = int(os.environ["WORLD_SIZE"])
    if process_id is None and "RANK" in os.environ:
        process_id = int(os.environ["RANK"])
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs a coordinator address, a world size and a "
                         "rank, as arguments or in the environment")
    return join_world(f"tcp://{coordinator_address}", num_processes, process_id, device, backend)


def global_mesh(axis: str = "data", device=None) -> Mesh:
    """1-D mesh over every process of the world."""
    return create_mesh(None, axis=axis, device=device)


def host_sharded_batch(batch: dict, mesh: Mesh, axis: str = "data") -> dict:
    """This process's rows as tensors on the mesh's device (each process
    passes only its global_batch / world rows); non-array leaves pass
    through. The global batch is never assembled: the collectives of the
    step see every rank's rows. ``axis`` is not read: it keeps the JAX
    signature, whose global array is laid out along it."""
    del axis
    out = {}
    for k, v in batch.items():
        if is_passthrough(v):
            out[k] = v
        else:
            out[k] = torch.as_tensor(np.asarray(v)).to(mesh.device)
    return out


def _stack(parts):
    first = parts[0]
    if isinstance(first, dict):
        return {k: _stack([p[k] for p in parts]) for k in first}
    if isinstance(first, (list, tuple)) and not isinstance(first, str):
        return type(first)(_stack(list(ps)) for ps in zip(*parts))
    if isinstance(first, torch.Tensor):
        return torch.stack([p.cpu() for p in parts])
    return np.stack([np.asarray(p) for p in parts])


def allgather_object(tree):
    """Gather a tree (dicts, lists, tuples) of host values or tensors from
    every process to every process, each leaf stacked along a new leading
    process axis (JAX's ``process_allgather``; tensors come back on the
    CPU). One process: the leaves with a leading axis of 1."""
    if not dist.is_initialized():
        return _stack([tree])
    parts = [None] * dist.get_world_size()
    dist.all_gather_object(parts, tree)
    return _stack(parts)


def replicate_global(tree, mesh: Optional[Mesh] = None):
    """Rank 0's tree on every process (broadcast; picklable leaves).
    ``mesh`` is not read: it keeps the JAX signature, whose replicated
    array lives on it; the broadcast covers the whole world."""
    del mesh
    if not dist.is_initialized():
        return tree
    box = [tree if dist.get_rank() == 0 else None]
    dist.broadcast_object_list(box, src=0)
    return box[0]
