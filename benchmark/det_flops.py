"""FLOPs an image of a detection configuration, counted as ``flops.py``
counts the others (``torch.utils.flop_counter.FlopCounterMode`` over the
plain reference's model on the meta device, the backward of a scalar of
every output), with what ``flops.count`` cannot give a det train step: the
targets its CDN groups are built from (``max_targets`` of them an image,
so that the decoder runs its 2 x num_denoising dn queries beside the
matching ones) and the published multi-scale list. Eval: the forward at
``input_size``. Train: the mean over the ``multi_scale`` entries (duplicates
weigh as often as they appear) of each size's forward and backward, so
that ``mfu.train`` reads true for a window that takes every size in its
published share.

    python3 benchmark/det_flops.py rtdetr_r50vd_6x_coco

prints the counts; ``configs/<name>.json`` keeps them under
``flops_per_image``.
"""
from __future__ import annotations

import sys

import det_recipe
import flops
import harness


def count_at(torch, recipe, size: int, train: bool, batch: int = 2) -> float:
    """FLOPs an image of ``recipe``'s model at ``size``: the forward in eval
    mode, or in training mode with a full padded target set and its
    backward."""
    from torch.utils.flop_counter import FlopCounterMode

    cfg = recipe.module.model_config(recipe.pkg, recipe.spec)
    T = recipe.spec["max_targets"]
    with torch.device("meta"):
        model = recipe.module.model_class(recipe.pkg)(cfg)
        model.train(train)
        x = torch.empty(batch, size, size, 3)
        targets = {"labels": torch.zeros(batch, T, dtype=torch.int32),
                   "points": torch.full((batch, T, 4), 0.25)}
    counter = FlopCounterMode(display=False)
    with counter:
        if train:
            outputs = model(x, targets) if recipe.module.denoising(recipe.spec) else model(x)
            sum(t.float().sum() for t in flops._tensors(outputs)).backward()
        else:
            model(x)
    return counter.get_total_flops() / batch


def count(torch, name: str, spec: dict | None = None, batch: int = 2) -> dict:
    """{"eval": FLOPs an image at ``input_size``, "train": the mean over
    ``multi_scale`` of a train step's FLOPs an image}."""
    recipe = det_recipe.DetRecipe(torch, name, "reference", spec)
    sizes = recipe.spec["multi_scale"]
    per_size = {s: count_at(torch, recipe, s, True, batch) for s in set(sizes)}
    return {"eval": count_at(torch, recipe, recipe.spec["input_size"], False, batch),
            "train": sum(per_size[s] for s in sizes) / len(sizes)}


def main(argv=None) -> int:
    harness.prepare_paths()
    import torch
    for name in (argv or sys.argv[1:]):
        print(name, count(torch, name))
    return 0


if __name__ == "__main__":
    sys.exit(main())
