"""Tensor parallelism over a 2-D (data, model) grid of ranks (counterpart of
parallel/tp.py).

The reference scales by DDP only (R1/utils/misc.py:415-440,
R2/src/misc/dist.py:23-51). This is a Megatron-style split of every
transformer block: attention heads and FFN hidden units split along the
``model`` axis, the batch along ``data``. The JAX package writes it as
GSPMD annotations; here the collectives are explicit. Inside
``tp_activation_sharding(mesh)`` each ``models.transformer`` attention runs
its H / n local heads (K1 at H / n heads on the card) and each FFN its f / n
local hidden units, and one ``all_reduce`` over the model group follows
``mha_out`` and ``linear2`` (the row-parallel halves), the bias added once
after it. The layers take either whole weights, of which they use their
rows or columns, or the shards ``shard_tree_tp`` cuts (``shard_module_tp``
puts them in a model).

Sharding map, on the port's parameter names (``nn.Linear`` keeps its
weight as (out, in)); "model" marks the split dim:

  mha_{query,key,value}.weight  (H*Dh, d) -> ("model", None)
  mha_{query,key,value}.bias       (H*Dh,) -> ("model",)
  mha_out.weight                (d, H*Dh) -> (None, "model")
  linear1.weight                    (f, d) -> ("model", None)
  linear1.bias                        (f,) -> ("model",)
  linear2.weight                    (f, d) -> (None, "model")
  everything else                           -> () replicated

The backbone's convolutions stay replicated (data-parallel).
"""
from __future__ import annotations

import re
import threading
from contextlib import contextmanager
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from .mesh import Mesh, _check_world, rank_device

# (trailing-name regex, expected ndim, spec builder)
_TP_RULES = (
    (re.compile(r"mha_(query|key|value)\.weight$"), 2, lambda ax: (ax, None)),
    (re.compile(r"mha_(query|key|value)\.bias$"), 1, lambda ax: (ax,)),
    (re.compile(r"mha_out\.weight$"), 2, lambda ax: (None, ax)),
    (re.compile(r"linear1\.weight$"), 2, lambda ax: (ax, None)),
    (re.compile(r"linear1\.bias$"), 1, lambda ax: (ax,)),
    (re.compile(r"linear2\.weight$"), 2, lambda ax: (None, ax)),
)


def create_mesh_2d(n_data: int, n_model: int, data_axis: str = "data",
                   model_axis: str = "model", device=None) -> Mesh:
    """A (data x model) mesh over the n_data * n_model ranks of the launched
    world, rank = d * n_model + m: the model groups are consecutive ranks,
    the data groups strided. Raises when the world has fewer ranks than the
    mesh needs (or more: a launched rank cannot idle)."""
    need = n_data * n_model
    _check_world(need, f"{n_data}x{n_model}")
    rank = dist.get_rank() if dist.is_initialized() else 0
    d, m = divmod(rank, n_model)
    data_ranks = model_ranks = None
    data_group = model_group = None
    # every rank creates every group, in the same order
    for i in range(n_data):
        ranks = tuple(range(i * n_model, (i + 1) * n_model))
        group = dist.new_group(list(ranks)) if need > 1 else None
        if i == d:
            model_ranks, model_group = ranks, group
    for j in range(n_model):
        ranks = tuple(range(j, need, n_model))
        group = dist.new_group(list(ranks)) if need > 1 else None
        if j == m:
            data_ranks, data_group = ranks, group
    dev = rank_device() if device is None else torch.device(device)
    return Mesh({data_axis: (n_data, d, data_group, data_ranks),
                 model_axis: (n_model, m, model_group, model_ranks)}, dev)


def tp_spec(name: str, tensor, model_axis: str = "model") -> tuple:
    """The split of one parameter, matched on its trailing name: a tuple with
    ``model_axis`` at the split dim, or () for a replicated one (also where
    the ndim does not match the rule)."""
    for rx, ndim, build in _TP_RULES:
        if rx.search(name) and getattr(tensor, "ndim", None) == ndim:
            return build(model_axis)
    return ()


def _split_dim(spec: tuple) -> Optional[int]:
    return next((i for i, ax in enumerate(spec) if ax is not None), None)


def shard_tree_tp(state_dict: dict, mesh: Mesh, model_axis: str = "model") -> dict:
    """This rank's shard of every matched tensor of a state dict (the rows or
    columns of its model index), the others whole: works on parameters,
    optimizer moments and EMA copies keyed by the same names."""
    n, r = mesh.axis_size(model_axis), mesh.rank(model_axis)
    out = {}
    for name, t in state_dict.items():
        dim = _split_dim(tp_spec(name, t, model_axis))
        out[name] = t if dim is None else t.chunk(n, dim=dim)[r].clone()
    return out


def shard_module_tp(model: torch.nn.Module, mesh: Mesh, model_axis: str = "model"):
    """Replace every matched parameter of ``model`` by this rank's shard
    (``shard_tree_tp``), in place; returns ``model``. Its layers then hold
    1 / n of the split weights, which ``tp_activation_sharding`` uses as
    they are."""
    params = dict(model.named_parameters())
    shards = shard_tree_tp(params, mesh, model_axis)
    for name, p in params.items():
        if shards[name] is not p:
            owner, _, attr = name.rpartition(".")
            setattr(model.get_submodule(owner), attr,
                    torch.nn.Parameter(shards[name].detach(), requires_grad=p.requires_grad))
    return model


def tp_param_fraction(named_tensors, model_axis: str = "model") -> float:
    """Fraction of parameters (by element count) that the map splits, over
    (name, tensor) pairs or a dict: a probe that the rules hit a model."""
    items = named_tensors.items() if isinstance(named_tensors, dict) else named_tensors
    tot = hit = 0
    for name, t in items:
        tot += t.numel()
        if tp_spec(name, t, model_axis):
            hit += t.numel()
    return hit / max(tot, 1)


_act_state = threading.local()


@contextmanager
def tp_activation_sharding(mesh: Mesh, data_axis: str = "data", model_axis: str = "model"):
    """Within the block, every ``models.transformer`` attention runs its
    local heads and every FFN its local hidden units over ``model_axis``
    (see the module docstring); each rank passes its rows of the batch along
    ``data_axis``."""
    for ax in (data_axis, model_axis):
        if ax not in mesh.axes:
            raise ValueError(f"mesh has axes {mesh.axis_names}, no '{ax}'")
    prev = getattr(_act_state, "ctx", None)
    _act_state.ctx = (mesh, data_axis, model_axis)
    try:
        yield
    finally:
        _act_state.ctx = prev


def activation_ctx() -> Optional[Tuple[Mesh, str, str]]:
    return getattr(_act_state, "ctx", None)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the cotangent summed over the model group (the
    input of a column-parallel product feeds every rank's shard)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        ctx.mesh, ctx.axis = mesh, axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce_sum(g.contiguous(), ctx.mesh, ctx.axis), None, None


class _ReduceFromModel(torch.autograd.Function):
    """Sum over the model group forward (a row-parallel product's partial
    sums); identity backward (every rank holds the same cotangent)."""

    @staticmethod
    def forward(ctx, x, mesh, axis):
        return _all_reduce_sum(x.contiguous(), mesh, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def _all_reduce_sum(x, mesh: Mesh, axis: str):
    out = x.detach().to(mesh.backend_device(axis), copy=True)
    if mesh.axis_size(axis) > 1:
        dist.all_reduce(out, group=mesh.group(axis))
    return out.to(x.device)


def _local(weight: torch.Tensor, dim: int, full: int, n: int, r: int) -> torch.Tensor:
    """The rank's part of ``weight`` along ``dim``: sliced from a whole
    weight, or the weight itself when it is a shard already."""
    if weight.shape[dim] == full:
        return weight.narrow(dim, r * (full // n), full // n)
    if weight.shape[dim] * n == full:
        return weight
    raise ValueError(f"a weight of {tuple(weight.shape)} is neither whole ({full}) nor a "
                     f"1/{n} shard along dim {dim}")


def column_parallel(x, linear: torch.nn.Linear, full_out: int, ctx):
    """``linear`` over this rank's output rows (x replicated over the model
    group)."""
    mesh, _, axis = ctx
    n, r = mesh.axis_size(axis), mesh.rank(axis)
    x = _CopyToModel.apply(x, mesh, axis)
    w = _local(linear.weight, 0, full_out, n, r)
    b = _local(linear.bias, 0, full_out, n, r) if linear.bias is not None else None
    return torch.nn.functional.linear(x, w, b)


def row_parallel(x, linear: torch.nn.Linear, full_in: int, ctx):
    """``linear`` over this rank's input columns, the partial products summed
    over the model group, then the bias."""
    mesh, _, axis = ctx
    n, r = mesh.axis_size(axis), mesh.rank(axis)
    w = _local(linear.weight, 1, full_in, n, r)
    y = _ReduceFromModel.apply(torch.nn.functional.linear(x, w), mesh, axis)
    return y + linear.bias if linear.bias is not None else y


def split_ctx(count: int):
    """The active TP context when ``count`` heads or hidden units split over
    its model axis, else None (a count that the axis does not divide runs
    whole, as JAX's ``constrain_heads`` leaves it)."""
    ctx = activation_ctx()
    if ctx is None or count % ctx[0].axis_size(ctx[2]):
        return None
    return ctx
