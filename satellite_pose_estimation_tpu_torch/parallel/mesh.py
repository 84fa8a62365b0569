"""Data parallelism over ``torch.distributed`` (counterpart of
parallel/mesh.py).

The JAX package lays a 1-D ``data`` mesh over the devices of one process
and lets XLA's SPMD partitioner insert the gradient and batch-statistics
reductions. Here every device is a process of a launched world
(``python -m torch.distributed.run`` or an explicit
``init_process_group``), and a :class:`Mesh` is that world's process group
plus this rank's device. Collectives are explicit: the train step wraps
the model in ``DistributedDataParallel`` and enters
:func:`data_parallel`, under which the BatchNorm layers reduce their
statistics over the group, the augmentation and the denoising groups draw
the global batch's parameters and apply this rank's rows, and the
criteria average their normalisers.

A launched rank cannot idle, so where the JAX package shrinks the mesh to
the largest device count that divides the batch (``auto_mesh``), a
launched world whose size does not divide the batch raises.
"""
from __future__ import annotations

import dataclasses
import os
import threading
from contextlib import contextmanager
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist


def rank_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` for a CUDA ``device``
    without an index (``LOCAL_RANK`` 0 outside a launcher), else
    ``device``. Raises when that card does not exist."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if not torch.cuda.is_available() or local >= torch.cuda.device_count():
        raise RuntimeError(f"local rank {local} needs cuda:{local}, but this machine has "
                           f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} "
                           f"CUDA device(s)")
    return torch.device("cuda", local)


def launched() -> bool:
    """True when a launcher (``torch.distributed.run``) set this process's
    rank and world in the environment."""
    return "WORLD_SIZE" in os.environ and "RANK" in os.environ


def join_world(init_method: str, world: int, rank: int, device="cuda",
               backend: Optional[str] = None) -> torch.device:
    """``init_process_group`` at ``init_method`` as ``rank`` of ``world``
    processes, on this rank's device (``rank_device``), which it returns.
    The backend is NCCL for a CUDA device and gloo for the CPU unless
    ``backend`` names another; a missing backend or a failed rendezvous
    raises."""
    dev = rank_device(device)
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    available = {"nccl": dist.is_nccl_available(), "gloo": dist.is_gloo_available()}
    if not available.get(backend, True):
        raise RuntimeError(f"torch.distributed backend {backend!r} is not available")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=int(world),
                            rank=int(rank))
    return dev


def init_from_env(device="cuda", backend: Optional[str] = None) -> torch.device:
    """Join the world that ``torch.distributed.run`` describes
    (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``,
    ``LOCAL_RANK``) through ``join_world``, unless a process group exists
    already, and return this rank's device (``rank_device``)."""
    if dist.is_initialized():
        return rank_device(device)
    if not launched():
        raise RuntimeError("no process group and no launcher environment (WORLD_SIZE, "
                           "RANK): start under python -m torch.distributed.run")
    return join_world("env://", os.environ["WORLD_SIZE"], os.environ["RANK"], device, backend)


def shutdown():
    """Leave the process group, if one was joined (the CLIs' last step)."""
    if dist.is_initialized():
        dist.destroy_process_group()


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A grid of the launched world's ranks: ``axes`` maps each axis name to
    (its size, this rank's index on it, the process group along it, the
    global ranks of that group), in grid order; ``device`` is this rank's
    device. A 1-D data mesh has the one axis ``"data"``."""
    axes: Dict[str, Tuple[int, int, object, Tuple[int, ...]]]
    device: torch.device

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.axes)

    @property
    def shape(self) -> Dict[str, int]:
        return {name: a[0] for name, a in self.axes.items()}

    @property
    def size(self) -> int:
        return int(np.prod([a[0] for a in self.axes.values()]))

    def axis_size(self, axis: str = "data") -> int:
        return self.axes[axis][0]

    def rank(self, axis: str = "data") -> int:
        return self.axes[axis][1]

    def group(self, axis: str = "data"):
        return self.axes[axis][2]

    def ranks(self, axis: str = "data") -> Tuple[int, ...]:
        return self.axes[axis][3]

    def backend_device(self, axis: str = "data") -> torch.device:
        """The device the group's backend takes tensors on: this rank's card
        under NCCL, the CPU under gloo (whose CUDA support stops at
        broadcast and all_reduce)."""
        if dist.get_backend(self.group(axis)) == "nccl":
            return self.device
        return torch.device("cpu")


def _check_world(need: int, what: str) -> int:
    world = world_size()
    if world < need:
        raise ValueError(f"requested a {what} mesh but the launched world exposes only "
                         f"{world} process(es)")
    if world > need:
        raise ValueError(f"requested a {what} mesh in a world of {world} processes: every "
                         "launched rank takes part, so the mesh must cover the world")
    if need > 1 and not dist.is_initialized():
        raise RuntimeError("no process group: call init_from_env (or "
                           "torch.distributed.init_process_group) first")
    return world


def create_mesh(n_devices: Optional[int] = None, axis: str = "data", device=None) -> Mesh:
    """A 1-D mesh of exactly ``n_devices`` ranks (the whole launched world
    by default) on ``device`` (``rank_device()`` by default). Raises when
    the world has fewer ranks than asked for, and when it has more (a
    launched rank cannot idle)."""
    n = world_size() if n_devices is None else int(n_devices)
    _check_world(n, f"{n}-device")
    dev = rank_device() if device is None else torch.device(device)
    rank = dist.get_rank() if dist.is_initialized() else 0
    group = dist.group.WORLD if dist.is_initialized() else None
    return Mesh({axis: (n, rank, group, tuple(range(n)))}, dev)


def auto_mesh_size(n_devices: int, *batch_sizes: int) -> int:
    """The JAX ``auto_mesh`` arithmetic: the largest device count up to
    ``n_devices`` that divides every batch size (1 when only one does)."""
    n = int(n_devices)
    while n > 1 and any(int(b) % n for b in batch_sizes):
        n -= 1
    return max(n, 1)


def auto_mesh(*batch_sizes: int, axis: str = "data", device="cuda") -> Optional[Mesh]:
    """The launched world as a data mesh, or None outside a launcher (one
    device, as today). Joins the world from the environment
    (``init_from_env``) if no process group exists yet. Where the JAX
    package shrinks the mesh to ``auto_mesh_size``, a world whose size does
    not divide every batch size raises, naming both."""
    if not dist.is_initialized() and not launched():
        return None
    dev = init_from_env(device)
    world = world_size()
    for b in batch_sizes:
        if int(b) % world:
            raise ValueError(f"the batch size {b} does not divide over the {world} launched "
                             "ranks; give a batch size that the world size divides")
    return create_mesh(world, axis=axis, device=dev)


def shard_rows(n: int, mesh: Mesh, axis: str = "data") -> slice:
    """This rank's contiguous rows of an ``n``-row batch (the layout of
    ``P("data")``); raises when the axis size does not divide ``n``."""
    size = mesh.axis_size(axis)
    if n % size:
        raise ValueError(f"a batch of {n} rows does not divide over the {size}-rank "
                         f"{axis!r} axis")
    per = n // size
    r = mesh.rank(axis)
    return slice(r * per, (r + 1) * per)


def is_passthrough(v) -> bool:
    """True for the batch entries that are not arrays (file names, pad
    counts), which sharding and device copies leave as they are."""
    return isinstance(v, (str, list, int, float))


def shard_batch(batch: dict, mesh: Mesh, axis: str = "data") -> dict:
    """This rank's rows of every array of ``batch`` (numpy arrays stay on the
    host, tensors keep their device); strings, lists and numbers pass
    through."""
    out = {}
    for k, v in batch.items():
        if is_passthrough(v):
            out[k] = v
        else:
            out[k] = v[shard_rows(len(v), mesh, axis)]
    return out


@torch.no_grad()
def replicate_tree(module_or_tensors, mesh: Mesh, axis: str = "data"):
    """Broadcast every parameter and buffer of a module (or every tensor of a
    dict or list) from the axis's first rank, in place; returns its
    argument."""
    if isinstance(module_or_tensors, torch.nn.Module):
        tensors = list(module_or_tensors.parameters()) + list(module_or_tensors.buffers())
    elif isinstance(module_or_tensors, dict):
        tensors = list(module_or_tensors.values())
    else:
        tensors = list(module_or_tensors)
    if mesh.axis_size(axis) > 1:
        src = mesh.ranks(axis)[0]
        for t in tensors:
            _on_backend(t, mesh, axis, lambda x: dist.broadcast(x, src, group=mesh.group(axis)))
    return module_or_tensors


def _on_backend(t: torch.Tensor, mesh: Mesh, axis: str, collective) -> torch.Tensor:
    """Run ``collective`` in place on ``t`` where the backend takes it,
    copying through that device when ``t`` lives elsewhere."""
    dev = mesh.backend_device(axis)
    if t.device == dev:
        collective(t)
        return t
    buf = t.detach().to(dev)
    collective(buf)
    t.copy_(buf)
    return t


def all_mean(t: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """The mean of ``t`` over the axis's ranks (a new tensor, no gradient)."""
    out = t.detach().clone()
    if mesh.axis_size(axis) > 1:
        _on_backend(out, mesh, axis, lambda x: dist.all_reduce(x, group=mesh.group(axis)))
        out = out / mesh.axis_size(axis)
    return out


def all_gather_rows(t: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated along dim 0 in rank
    order, on the group's backend device."""
    size = mesh.axis_size(axis)
    if size == 1:
        return t
    x = t.detach().to(mesh.backend_device(axis))
    x = (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()
    parts = [torch.empty_like(x) for _ in range(size)]
    dist.all_gather(parts, x, group=mesh.group(axis))
    return torch.cat(parts).to(t.dtype)


def gather_objects(obj, mesh: Mesh, axis: str = "data") -> list:
    """Every rank's picklable ``obj``, in rank order."""
    if mesh.axis_size(axis) == 1:
        return [obj]
    out = [None] * mesh.axis_size(axis)
    dist.all_gather_object(out, obj, group=mesh.group(axis))
    return out


def barrier(mesh: Optional[Mesh]):
    """Wait for every rank of the mesh's world (no-op without one)."""
    if mesh is not None and mesh.size > 1:
        dist.barrier()


def is_main(mesh: Optional[Mesh]) -> bool:
    """True on the rank that writes files: rank 0, or without a mesh."""
    return mesh is None or not dist.is_initialized() or dist.get_rank() == 0


# -- the data-parallel context --------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataParallel:
    """The active data-parallel step: the mesh and axis, and this rank's
    rows [offset, offset + local) of a ``total``-row global batch."""
    mesh: Mesh
    axis: str
    offset: int
    local: int
    total: int

    @property
    def size(self) -> int:
        return self.mesh.axis_size(self.axis)


_dp = threading.local()


@contextmanager
def data_parallel(mesh: Optional[Mesh], local_batch: int, axis: str = "data"):
    """Within the block, BatchNorm layers in training reduce their batch
    statistics over the axis (``models.layers.BatchNorm2d``), and the
    augmentation and CDN draws take the global batch's parameters and
    apply this rank's rows of it (``global_rows``). A ``mesh`` of None
    changes nothing (one device)."""
    if mesh is None:
        yield None
        return
    if axis not in mesh.axes:
        raise ValueError(f"mesh has axes {mesh.axis_names}, no {axis!r}")
    size, rank = mesh.axis_size(axis), mesh.rank(axis)
    prev = getattr(_dp, "ctx", None)
    _dp.ctx = DataParallel(mesh, axis, rank * local_batch, local_batch, size * local_batch)
    try:
        yield _dp.ctx
    finally:
        _dp.ctx = prev


def active_data_parallel() -> Optional[DataParallel]:
    return getattr(_dp, "ctx", None)


def global_rows(local: int) -> Tuple[int, int]:
    """(global batch size, this rank's first row) for a ``local``-row batch:
    (local, 0) outside ``data_parallel``."""
    ctx = active_data_parallel()
    if ctx is None:
        return local, 0
    if local != ctx.local:
        raise ValueError(f"a {local}-row batch inside a data-parallel step of {ctx.local} "
                         "rows a rank")
    return ctx.total, ctx.offset


class _AllReduceMean(torch.autograd.Function):
    """The mean over a group, differentiable: the cotangent is averaged the
    same way (the transpose of a mean over replicas is that mean)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return all_mean(x, mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return all_mean(g.contiguous(), ctx.mesh, ctx.axis), None, None


def all_mean_differentiable(x: torch.Tensor, mesh: Mesh, axis: str = "data") -> torch.Tensor:
    """``all_mean`` that gradients pass through."""
    return _AllReduceMean.apply(x, mesh, axis)


def group_mean_losses(losses: Dict[str, torch.Tensor], mesh: Mesh,
                      axis: str = "data") -> Dict[str, torch.Tensor]:
    """Each loss averaged over the axis in one collective (JAX's ``pmean``
    of the loss dict)."""
    keys = list(losses)
    dtype = torch.float32
    for v in losses.values():
        dtype = torch.promote_types(dtype, v.dtype)
    stacked = torch.stack([losses[k].detach().to(dtype).reshape(()) for k in keys])
    mean = all_mean(stacked, mesh, axis)
    return {k: mean[i] for i, k in enumerate(keys)}


def ddp_module(model: torch.nn.Module, mesh: Mesh, cache: dict,
               find_unused_parameters: bool = False):
    """``model`` wrapped in ``DistributedDataParallel`` over the mesh's data
    group (built once per model and kept in ``cache``): gradients are
    averaged over the group while the backward runs. Buffers are not
    broadcast each step: the BatchNorm statistics are reduced over the
    group already, so every rank holds the same.

    A model with parameters that no loss reads (an RT-DETR's sigma heads
    under any point loss but the Laplace one) asks for
    ``find_unused_parameters``: DDP then marks them ready after each
    backward, at the cost of a walk over the autograd graph every step.
    (``static_graph`` does not serve: the heads' outputs reach the
    forward's outputs, so it waits for their gradients from the second
    step on.)"""
    from torch.nn.parallel import DistributedDataParallel

    key = id(model)
    entry = cache.get(key)
    if entry is None or entry[0] is not model:
        dev = next(model.parameters()).device
        entry = cache[key] = (model, DistributedDataParallel(
            model, device_ids=[dev] if dev.type == "cuda" else None,
            process_group=mesh.group("data"), broadcast_buffers=False,
            find_unused_parameters=find_unused_parameters))
    return entry[1]


def split_uneven(n: int, mesh: Mesh, axis: str = "data") -> Sequence[int]:
    """This rank's indices of ``range(n)`` under ``np.array_split`` (a
    ragged batch split as evenly as it goes)."""
    return np.array_split(np.arange(n), mesh.axis_size(axis))[mesh.rank(axis)].tolist()
