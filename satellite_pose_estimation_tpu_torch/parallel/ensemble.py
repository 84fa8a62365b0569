"""Checkpoint-ensemble parallelism: one model per device (counterpart of
parallel/ensemble.py).

The reference loops its checkpoints serially on one GPU
(R1/gen_submission_multi.py:256-265). The JAX package stacks the K
checkpoints' trees along a leading axis and runs the K forwards as one
vmapped program sharded over the mesh. Here the K state dicts are stacked
the same way; ``ensemble_apply`` runs model k with ``torch.func.
functional_call`` on its slice. With devices, each device holds K / n of
the models and one copy of the module (``place_ensemble``, made once for
a whole split), and every forward is enqueued before any result is read,
so the devices run side by side.
"""
from __future__ import annotations

import copy
from typing import List, Optional, Sequence

import torch


def stack_variable_trees(variable_trees: List[dict]) -> dict:
    """Stack K compatible state dicts along a new leading axis."""
    keys = list(variable_trees[0])
    for tree in variable_trees[1:]:
        if list(tree) != keys:
            raise ValueError("the state dicts do not hold the same tensors")
    return {k: torch.stack([tree[k] for tree in variable_trees]) for k in keys}


def _outputs_stack(outputs: list):
    """A list of K output dicts (tensors, or lists of dicts of tensors for
    the auxiliary layers) -> one such structure with a leading K axis."""
    first = outputs[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(outputs)
    if isinstance(first, dict):
        return {k: _outputs_stack([o[k] for o in outputs]) for k in first}
    if isinstance(first, (list, tuple)):
        return type(first)(_outputs_stack(list(parts)) for parts in zip(*outputs))
    return first


def place_ensemble(model: torch.nn.Module, stacked_variables: dict, devices: Sequence):
    """Each device's share of the K stacked models, built once for many
    batches: ``[(device, module, its K / n stacked state dict)]``, model k
    on ``devices[k // (K / n)]``. The module is ``model`` on its own device
    and a copy of it on any other. Raises when the n devices do not divide
    K, as the JAX mesh does."""
    K = next(iter(stacked_variables.values())).shape[0]
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    if K % n:
        raise ValueError(f"ensemble size {K} must divide the {n}-device mesh; pad the "
                         "checkpoint list or run without devices")
    per = K // n
    home = next(model.parameters()).device
    placement = []
    for d, dev in enumerate(devices):
        replica = model if dev == home else copy.deepcopy(model).to(dev)
        local = {k: v[d * per:(d + 1) * per].to(dev, non_blocking=True)
                 for k, v in stacked_variables.items()}
        placement.append((dev, replica, local))
    return placement


def ensemble_apply(model: torch.nn.Module, stacked_variables: dict, images: torch.Tensor,
                   devices: Optional[Sequence] = None, placement: Optional[list] = None,
                   **kwargs):
    """Run all K stacked models on the same image batch.

    Args:
        model: the module the state dicts belong to (its own tensors are
            not used).
        stacked_variables: ``stack_variable_trees`` of K state dicts.
        images: the batch, on ``model``'s device without ``devices``.
        devices: None runs the K forwards one after another on ``model``'s
            device; else the models are spread over the devices as
            ``place_ensemble`` spreads them, the images copied to each, and
            every forward enqueued before any result is read.
        placement: ``place_ensemble(model, stacked_variables, devices)``,
            made once by a caller that runs many batches (``devices`` is
            then not read).
        kwargs: passed to the model's forward.
    Returns:
        the model's output structure with a leading K axis, on the first
        device (``model``'s without ``devices``).
    """
    if placement is None and devices is None:
        K = next(iter(stacked_variables.values())).shape[0]
        return _outputs_stack([
            torch.func.functional_call(model, {k: v[i] for k, v in stacked_variables.items()},
                                       (images,), kwargs) for i in range(K)])
    if placement is None:
        placement = place_ensemble(model, stacked_variables, devices)
    outputs = []
    for dev, replica, local in placement:
        x = images.to(dev, non_blocking=True)
        per = next(iter(local.values())).shape[0]
        outputs += [torch.func.functional_call(replica, {k: v[i] for k, v in local.items()},
                                               (x,), kwargs) for i in range(per)]
    first = placement[0][0]
    return _outputs_stack([_to(o, first) for o in outputs])


def _to(tree, device):
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return tree


@torch.inference_mode()
def ensemble_predictions(model, variable_trees: List[dict], images, devices=None):
    """Convenience: (K state dicts, one batch) -> outputs with a leading K
    axis, in eval mode, on the CPU."""
    was_training = model.training
    model.eval()
    try:
        out = ensemble_apply(model, stack_variable_trees(list(variable_trees)), images,
                             devices=devices)
    finally:
        model.train(was_training)
    return _to(out, "cpu")
