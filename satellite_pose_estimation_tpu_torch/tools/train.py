"""R2-style config-driven train CLI (R2/tools/train.py:16-68 surface;
counterpart of tools/train.py). Runs on the card; ``--device cpu`` runs on
the CPU:

    python -m satellite_pose_estimation_tpu_torch.tools.train \
        -c configs/speed/rtdetr_r50vd_kl_1_512.yml [-r ckpt | -t ckpt] [--test-only]

``-u key=value ...`` overrides config entries (dotted keys reach into
sections; a value is read as JSON where it parses, else as a string), e.g.
``-u epoches=1 output_dir=out/run train_dataloader.batch_size=8``.
"""
from __future__ import annotations

import argparse
import json

from ..core.yaml_config import YAMLConfig
from ..train.solver import TASKS


def parse_updates(items) -> dict:
    """["a.b=1", "c=x"] -> {"a": {"b": 1}, "c": "x"}."""
    out: dict = {}
    for item in items or []:
        key, sep, raw = item.partition("=")
        if not sep:
            raise ValueError(f"an update is key=value, not {item!r}")
        try:
            value = json.loads(raw)
        except json.JSONDecodeError:
            value = raw
        node = out
        *parents, leaf = key.split(".")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def main(args):
    """``args.config`` is a YAML path or an already merged config dict."""
    if args.tuning and args.resume:
        raise ValueError("Only support from_scrach or resume or tuning at one time")
    updates = parse_updates(getattr(args, "update", None))
    if isinstance(args.config, dict):
        cfg = YAMLConfig(cfg=args.config, **updates)
    else:
        cfg = YAMLConfig(args.config, **updates)
    solver = TASKS[cfg.task](cfg, data_root=args.data_root, seed=args.seed,
                             device=args.device)
    if args.resume:
        solver.resume(args.resume)
    if args.tuning:
        solver.tuning(args.tuning)
    if args.test_only:
        stats, _ = solver.val()
        print(stats)
    else:
        solver.fit()
    return solver


def get_args_parser():
    parser = argparse.ArgumentParser("SPEED RT-DETR train/eval")
    parser.add_argument("--config", "-c", type=str, required=True)
    parser.add_argument("--resume", "-r", type=str, default=None)
    parser.add_argument("--tuning", "-t", type=str, default=None)
    parser.add_argument("--test-only", action="store_true", default=False)
    parser.add_argument("--update", "-u", nargs="+", default=None,
                        help="config overrides, key=value (dotted keys reach into sections)")
    parser.add_argument("--data_root", default="./data/speed")
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    return parser


if __name__ == "__main__":
    main(get_args_parser().parse_args())
