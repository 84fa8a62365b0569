"""R1-style train/eval CLI (counterpart of tools/main.py).

Mirrors the argparse surface of R1/main.py:90-187 (model flags, optimizer
schedule, dataset files, --eval, --resume, --repro) on top of the config
system: flags are translated into a YAMLConfig dict and handed to
SpeedSolver. Runs on the card; ``--device cpu`` runs on the CPU:

    python -m satellite_pose_estimation_tpu_torch.tools.main \
        --backbone resnet50s8 --enc_layers 4 --dec_layers 4 \
        --num_queries 20 --input_size 224 --output_dir output/r1

Data-parallel over N cards: ``python -m torch.distributed.run
--nproc_per_node=N -m satellite_pose_estimation_tpu_torch.tools.main ...``
(``--batch_size`` is the global batch, which N must divide; rank 0 writes
the logs and checkpoints).

``--resume`` takes, as the reference does (R1/main.py:265-271), the public
``detr-r50-e632da11.pth`` through surgery; any other ``.pth`` is a whole R1
model; anything else is a checkpoint of this package to resume.
"""
from __future__ import annotations

import argparse
import os

from ..core.yaml_config import YAMLConfig
from ..parallel.mesh import shutdown
from ..train.solver import SpeedSolver


def get_args_parser():
    parser = argparse.ArgumentParser("SPEED keypoint DETR", add_help=False)
    parser.add_argument("--lr", default=1e-4, type=float)
    parser.add_argument("--lr_backbone", default=1e-5, type=float)
    parser.add_argument("--batch_size", default=32, type=int)
    parser.add_argument("--weight_decay", default=1e-4, type=float)
    parser.add_argument("--epochs", default=150, type=int)
    parser.add_argument("--lr_drop", default=[80, 120], type=int, nargs="+")
    parser.add_argument("--clip_max_norm", default=0.1, type=float)
    parser.add_argument("--input_size", type=int, default=512)
    # model
    parser.add_argument("--backbone", default="resnet50", type=str)
    parser.add_argument("--dilation", action="store_true")
    parser.add_argument("--position_embedding", default="sine",
                        choices=("sine", "learned"))
    parser.add_argument("--bn", type=str, default="frozen_bn",
                        choices=("frozen_bn", "sync_bn", "group_bn", "bn"))
    parser.add_argument("--enc_layers", default=6, type=int)
    parser.add_argument("--dec_layers", default=6, type=int)
    parser.add_argument("--dim_feedforward", default=2048, type=int)
    parser.add_argument("--hidden_dim", default=256, type=int)
    parser.add_argument("--dropout", default=0.1, type=float)
    parser.add_argument("--nheads", default=8, type=int)
    parser.add_argument("--num_queries", default=100, type=int)
    parser.add_argument("--pre_norm", action="store_true")
    parser.add_argument("--no_aux_loss", dest="aux_loss", action="store_false")
    # matcher / loss
    parser.add_argument("--set_cost_class", default=1, type=float)
    parser.add_argument("--set_cost_pts", default=5, type=float)
    parser.add_argument("--pts_loss_coef", default=5.0, type=float)
    parser.add_argument("--eos_coef", default=0.1, type=float)
    # dataset
    parser.add_argument("--data_root", default="./data/speed")
    parser.add_argument("--train_ann_file", default="wz_train.json")
    parser.add_argument("--train_index_file", default="train_1.txt")
    parser.add_argument("--train_img_dir", default="images/train")
    parser.add_argument("--val_ann_file", default="wz_train.json")
    parser.add_argument("--val_index_file", default="val_1.txt")
    parser.add_argument("--val_img_dir", default="images/train")
    parser.add_argument("--output_dir", default="output/r1")
    parser.add_argument("--seed", default=42, type=int)
    parser.add_argument("--resume", default="")
    parser.add_argument("--eval", action="store_true")
    parser.add_argument("--repro", type=int, default=20)
    parser.add_argument("--compute_dtype", default="float32",
                        choices=("float32", "bfloat16"))
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    return parser


def args_to_config(args) -> YAMLConfig:
    cfg = {
        "model": "DETR",
        "task": "landmarker",
        "num_classes": 11,
        "epoches": args.epochs,
        "checkpoint_step": 1,
        "output_dir": args.output_dir,
        "clip_max_norm": args.clip_max_norm,
        "compute_dtype": args.compute_dtype,
        "DETR": {
            "backbone": args.backbone,
            "bn": args.bn,
            "position_embedding": args.position_embedding,
            "hidden_dim": args.hidden_dim,
            "nheads": args.nheads,
            "enc_layers": args.enc_layers,
            "dec_layers": args.dec_layers,
            "dim_feedforward": args.dim_feedforward,
            "dropout": args.dropout,
            "pre_norm": args.pre_norm,
            "num_queries": args.num_queries,
            "aux_loss": args.aux_loss,
        },
        "SetCriterion": {
            "eos_coef": args.eos_coef,
            "losses": ["labels", "points"],
            "weight_dict": {"loss_ce": 1, "loss_points": args.pts_loss_coef},
            "matcher": {
                "weight_dict": {
                    "cost_class": args.set_cost_class,
                    "cost_pts": args.set_cost_pts,
                }
            },
        },
        "optimizer": {
            "lr": args.lr,
            "weight_decay": args.weight_decay,
            "params": [{"params": "backbone", "lr": args.lr_backbone}],
        },
        "lr_scheduler": {"milestones": args.lr_drop, "gamma": 0.1},
        "train_dataloader": {
            "batch_size": args.batch_size,
            "dataset": {
                "ann_file": args.train_ann_file,
                "index_file": args.train_index_file,
                "img_dir": args.train_img_dir,
                "resize": args.input_size,
            },
        },
        "val_dataloader": {
            "batch_size": args.batch_size,
            "dataset": {
                "ann_file": args.val_ann_file,
                "index_file": args.val_index_file,
                "img_dir": args.val_img_dir,
                "resize": args.input_size,
                "train": False,
            },
        },
    }
    return YAMLConfig(cfg=cfg)


PUBLIC_DETR_R50 = "detr-r50-e632da11.pth"


def attach_checkpoint(solver, path: str) -> str:
    """Hand ``path`` to the solver by its file name, as the reference does
    (R1/main.py:265-271): the public DETR-R50 file goes through surgery
    (backbone / transformer / input_proj / query_embed with slice
    adaptation, the keypoint heads kept at init), any other ``.pth`` is a
    whole R1 model, anything else a checkpoint of this package to resume.
    Returns which of "surgery", "r1", "resume" it chose."""
    name = os.path.basename(path.rstrip("/"))
    if name == PUBLIC_DETR_R50:
        solver.surgery(path)
        return "surgery"
    if name.endswith(".pth"):
        solver.load_r1(path)
        return "r1"
    solver.resume(path)
    return "resume"


def main(args):
    cfg = args_to_config(args)
    solver = SpeedSolver(cfg, data_root=args.data_root, seed=args.seed, device=args.device)
    if args.resume:
        attach_checkpoint(solver, args.resume)
    if args.eval:
        stats, _ = solver.val()
        print(stats)
    else:
        solver.fit()
    return solver


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        "SPEED DETR train/eval", parents=[get_args_parser()]
    )
    main(parser.parse_args())
    shutdown()
