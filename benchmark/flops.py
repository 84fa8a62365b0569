"""FLOPs an image of a configuration, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference's
model on the meta device (shapes only, nothing is computed), so that the
attention products are counted whatever kernel the program runs them in.
Eval: the forward in eval mode. Train: the forward in training mode and the
backward of a scalar of every output (the criterion's own FLOPs are
negligible beside the model's).

    python3 benchmark/flops.py

prints each configuration's counts; ``configs/<name>.json`` keeps them under
``flops_per_image``.
"""
from __future__ import annotations

import sys

import harness


def count(torch, name: str, spec: dict | None = None, batch: int = 2) -> dict:
    """{"eval": FLOPs an image, "train": FLOPs an image} of configuration
    ``name`` at its input size, counted at ``batch`` images."""
    from torch.utils.flop_counter import FlopCounterMode

    import sides
    ref = sides.Recipe(torch, name, "reference", spec)
    module = ref.module
    cfg = module.model_config(ref.pkg, ref.spec)
    size = ref.spec["input_size"]
    out = {}
    for mode in ("eval", "train"):
        with torch.device("meta"):
            model = module.model_class(ref.pkg)(cfg)
            model.train(mode == "train")
            x = torch.empty(batch, size, size, 3)
        counter = FlopCounterMode(display=False)
        with counter:
            outputs = model(x)
            if mode == "train":
                total = sum(t.float().sum() for t in _tensors(outputs))
                total.backward()
        out[mode] = counter.get_total_flops() / batch
    return out


def _tensors(tree):
    if hasattr(tree, "requires_grad"):
        if tree.requires_grad:
            yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def main() -> int:
    harness.prepare_paths()
    import torch
    for cfg in harness.benchmark_spec()["configs"]:
        print(cfg["name"], count(torch, cfg["name"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
