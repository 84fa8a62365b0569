"""Pipeline parallelism (counterpart of parallel/pp.py): a GPipe microbatch
pipeline over homogeneous layers, one stage a rank, the activations passed
between neighbours with ``isend`` / ``irecv``.

The reference scales by DDP only (R2/src/misc/dist.py:23-51); this is the
pipeline axis for when a stack's layers outgrow one card. Each rank of the
mesh's ``pipe`` axis holds one layer's parameters; microbatches stream
through, one hop per step, for n_micro + n_stages - 1 steps (bubble
fraction (n_stages - 1) / (n_micro + n_stages - 1)), and the last stage's
output is replicated to every stage.
"""
from __future__ import annotations

from typing import Callable, List

import torch
import torch.distributed as dist

from .mesh import Mesh


def stack_layer_params(layer_params_list: List[dict]) -> dict:
    """Stack per-layer parameter dicts along a new leading stage axis."""
    keys = list(layer_params_list[0])
    return {k: torch.stack([p[k] for p in layer_params_list]) for k in keys}


def pipeline_apply(layer_fn: Callable, stacked_params: dict, x: torch.Tensor, mesh: Mesh,
                   axis: str = "pipe", n_micro: int | None = None) -> torch.Tensor:
    """Apply the ``n_stages`` stacked layers in sequence as a microbatch
    pipeline.

    ``layer_fn(params, x) -> x`` of the same shape (a homogeneous layer, e.g.
    one transformer encoder block, through ``torch.func.functional_call``).
    ``stacked_params`` has a leading dim equal to the mesh's ``axis`` size;
    stage s uses its slice s. ``x`` is the full batch, the same on every
    stage; it is split into ``n_micro`` microbatches (default: one per
    stage). Returns the n_stages layers composed over ``x`` on every rank,
    the sequential loop's arithmetic. Raises when ``n_micro`` does not
    divide the batch."""
    n_stages = mesh.axis_size(axis)
    n_micro = n_micro or n_stages
    B = x.shape[0]
    if B % n_micro:
        raise ValueError(f"batch {B} not divisible into {n_micro} microbatches")
    lead = next(iter(stacked_params.values())).shape[0]
    if lead != n_stages:
        raise ValueError(f"{lead} stacked layers for a {n_stages}-stage pipeline")
    stage, ranks, group = mesh.rank(axis), mesh.ranks(axis), mesh.group(axis)
    params = {k: v[stage] for k, v in stacked_params.items()}
    xs = x.chunk(n_micro)
    comm = mesh.backend_device(axis)
    outs = [torch.zeros_like(xs[0]) for _ in range(n_micro)]
    sends = []
    for t in range(n_micro + n_stages - 1):
        m = t - stage  # the microbatch this stage holds at step t
        if not 0 <= m < n_micro:
            continue
        if stage == 0:
            inp = xs[m]
        else:
            buf = torch.empty(xs[0].shape, dtype=x.dtype, device=comm)
            dist.irecv(buf, ranks[stage - 1], group=group).wait()
            inp = buf.to(x.device)
        out = layer_fn(params, inp)
        if stage < n_stages - 1:
            send = out.detach().to(comm).contiguous()
            sends.append((dist.isend(send, ranks[stage + 1], group=group), send))
        else:
            outs[m] = out
    for work, _ in sends:
        work.wait()
    y = torch.cat(outs).to(comm)
    dist.broadcast(y, ranks[-1], group=group)  # replicate the last stage's output
    return y.to(x.device)
