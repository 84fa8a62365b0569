"""Sequence parallelism: the encoder's activations split along the token
axis (counterpart of parallel/sp.py).

Complements parallel/tp.py (which splits parameters): inside
``sequence_sharding(mesh, axis)`` the DETR encoder (``models.transformer``)
takes this rank's T / n tokens at its entry, runs the LayerNorm, FFN and
residual segments of every block on them, all-gathers the tokens before
each attention (whose core needs the whole sequence) and keeps its own
rows of the attention's output, and all-gathers the memory at its end.
The JAX package writes the same layout as GSPMD sharding constraints.
Inside an encoder block the gather's backward sums the cotangent over the
group and keeps this rank's tokens (an ``all_reduce`` and a slice, as gloo
has no ``reduce_scatter`` on every build); the parameters up to the
encoder's end then hold the gradient of their rank's tokens, which sums
over the group to the whole.

No reference counterpart: R1/R2 scale by DDP only (R2/src/misc/dist.py:
23-51).
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh

_state = threading.local()


@contextmanager
def sequence_sharding(mesh: Mesh, axis: str = "model"):
    """Split the encoder's tokens over ``axis`` of ``mesh`` within the
    block."""
    if axis not in mesh.axes:
        raise ValueError(f"mesh has axes {mesh.axis_names}, no '{axis}'")
    prev = getattr(_state, "ctx", None)
    _state.ctx = (mesh, axis)
    try:
        yield
    finally:
        _state.ctx = prev


def active() -> Optional[Tuple[Mesh, str]]:
    return getattr(_state, "ctx", None)


def _tokens(T: int, mesh: Mesh, axis: str) -> slice:
    n = mesh.axis_size(axis)
    if T % n:
        raise ValueError(f"{T} tokens do not split over the {n}-rank {axis!r} axis")
    r = mesh.rank(axis)
    return slice(r * (T // n), (r + 1) * (T // n))


def shard_tokens(x: torch.Tensor) -> torch.Tensor:
    """This rank's tokens of a (B, T, C) activation when a sequence_sharding
    context is active; ``x`` otherwise."""
    ctx = active()
    if ctx is None:
        return x
    return x[:, _tokens(x.shape[1], *ctx)]


class _GatherTokens(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, axis, replicated):
        ctx.mesh, ctx.axis, ctx.n, ctx.replicated = mesh, axis, x.shape[1], replicated
        dev = mesh.backend_device(axis)
        local = x.detach().to(dev).contiguous()
        parts = [torch.empty_like(local) for _ in range(mesh.axis_size(axis))]
        dist.all_gather(parts, local, group=mesh.group(axis))
        return torch.cat(parts, dim=1).to(x.device)

    @staticmethod
    def backward(ctx, g):
        mesh, axis, r = ctx.mesh, ctx.axis, ctx.mesh.rank(ctx.axis)
        mine = slice(r * ctx.n, (r + 1) * ctx.n)
        if ctx.replicated:
            return g[:, mine], None, None, None
        total = g.detach().to(mesh.backend_device(axis), copy=True).contiguous()
        dist.all_reduce(total, group=mesh.group(axis))
        return total[:, mine].to(g.device), None, None, None


def gather_tokens(x: torch.Tensor, replicated: bool = False) -> torch.Tensor:
    """Every rank's tokens of a (B, T / n, C) activation, in rank order, when
    a sequence_sharding context is active; ``x`` otherwise. The backward
    sums the cotangent over the group and keeps this rank's tokens (each
    rank's consumer covers its own tokens' paths, as the attention of an
    encoder block does); with ``replicated`` (a consumer that every rank
    runs whole, as the decoder) it keeps this rank's tokens of its own."""
    ctx = active()
    if ctx is None or ctx[0].axis_size(ctx[1]) == 1:
        return x
    return _GatherTokens.apply(x, *ctx, replicated)
