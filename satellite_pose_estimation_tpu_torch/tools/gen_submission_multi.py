"""Checkpoint-ensemble submission (R1/gen_submission_multi.py:122-291;
counterpart of tools/gen_submission_multi.py).

For each checkpoint, keypoint inference over both SPEED test splits
(``gen_prediction``: the crop warp and the model on the device, per image
{points in original pixels, probabilities}); the raw predictions go to
``points_logits_{real,synt}_<ts>.json``; then each image's pose is solved
from the per-label means of all checkpoints' points (the 3-sigma filter,
``solve_pose_multi_mean_batch``, one batched call over images x models x
queries) and written through ``SubmissionWriter``. Runs on the card;
``--device cpu`` runs on the CPU:

    python -m satellite_pose_estimation_tpu_torch.tools.gen_submission_multi \\
        --backbone resnet50s8 --enc_layers 4 --dec_layers 4 --num_queries 20 \\
        --input_size 224 --data_root D --checkpoints A/state.pt B/state.pt

The checkpoints are ``SpeedSolver``'s (``<output_dir>/<name>``).
``--parallel_ensemble`` runs every checkpoint's forward at once per batch
(``gen_prediction_parallel``, ``parallel.ensemble.ensemble_apply``): one
model per card when the number of cards divides the number of
checkpoints, every model on the one card of a one-card machine, and one
after another on one device otherwise (as the JAX package falls back to
its unsharded vmap); the predictions and the CSV are the serial route's.
"""
from __future__ import annotations

import argparse
import json
from collections import defaultdict
from datetime import datetime

import numpy as np
import torch

from ..data.dataset import SpeedSubmissionDataset
from ..data.prefetch import prefetch_to_device
from ..geometry.camera import WORLD_POINTS
from ..geometry.multi_mean import solve_pose_multi_mean_batch
from ..ops.image_warp import crop_resize_cubic_mxu
from ..parallel.ensemble import ensemble_apply, place_ensemble, stack_variable_trees
from ..train.solver import SpeedSolver
from ..utils.submission import SubmissionWriter
from .main import args_to_config, get_args_parser


@torch.inference_mode()
def gen_prediction(solver, dataset, batch_size, out_size):
    """One checkpoint over one split -> {filename: {"points", "logits"}}:
    the (Q, 2) points in original-image pixels and the (Q, K + 1) softmax
    probabilities (named ``logits`` as in the reference's file), numpy."""
    model = solver.state.model
    autocast = solver._autocast
    model.eval()
    preds = {}
    for batch in prefetch_to_device(dataset.batches(batch_size), size=2, device=solver.device):
        pad = batch.pop("pad", 0)
        filenames = batch.pop("filename")
        images = crop_resize_cubic_mxu(batch["image"], batch["clip_bbox_buf"], out_size, True)
        with torch.autocast(images.device.type, dtype=autocast, enabled=autocast is not None):
            outputs = model(images)
        probs = torch.softmax(outputs["pred_logits"].float(), dim=-1)
        clip = batch["clip_bbox"].float()
        wh = clip[:, 2:4] - clip[:, 0:2]
        pts_pix = outputs["pred_points"].float() * wh[:, None, :] + clip[:, None, 0:2]
        probs, pts_pix = probs.cpu().numpy(), pts_pix.cpu().numpy()
        for i in range(len(filenames) - pad):
            preds[filenames[i]] = {"points": pts_pix[i], "logits": probs[i]}
    return preds


@torch.inference_mode()
def gen_prediction_parallel(model, variable_trees, dataset, batch_size, out_size, autocast,
                            device, devices=None):
    """Every checkpoint over one split at once: the K state dicts stacked
    and run by ``ensemble_apply`` (on ``devices``, or one after another on
    ``device``) -> {filename: [{"points", "logits"} per checkpoint]}, as
    ``gen_prediction`` gives each."""
    stacked = stack_variable_trees(variable_trees)
    model.eval()
    # each device's replica and weights, once for the whole split
    placement = None if devices is None else place_ensemble(model, stacked, devices)
    preds = defaultdict(list)
    for batch in prefetch_to_device(dataset.batches(batch_size), size=2, device=device):
        pad = batch.pop("pad", 0)
        filenames = batch.pop("filename")
        images = crop_resize_cubic_mxu(batch["image"], batch["clip_bbox_buf"], out_size, True)
        dev = images.device if devices is None else torch.device(devices[0])
        with torch.autocast(dev.type, dtype=autocast, enabled=autocast is not None):
            outputs = ensemble_apply(model, stacked, images, placement=placement)
        probs = torch.softmax(outputs["pred_logits"].float(), dim=-1)  # (K, B, Q, C)
        clip = batch["clip_bbox"].float().to(dev)
        wh = clip[:, 2:4] - clip[:, 0:2]
        pts_pix = outputs["pred_points"].float() * wh[None, :, None, :] + clip[None, :, None, 0:2]
        probs, pts_pix = probs.cpu().numpy(), pts_pix.cpu().numpy()
        for i in range(len(filenames) - pad):
            for m in range(pts_pix.shape[0]):
                preds[filenames[i]].append({"points": pts_pix[m, i], "logits": probs[m, i]})
    return preds


def ensemble_devices(device, K: int):
    """The cards of the one-model-per-device route: every card of the
    machine when their number divides K (one card takes every model), else
    None (one after another on ``device``, said on stdout); None on the
    CPU."""
    if torch.device(device).type != "cuda":
        return None
    n = torch.cuda.device_count()
    if K % n:
        print(f"--parallel_ensemble: {K} checkpoints do not divide over {n} cards; running "
              f"them one after another on {device}")
        return None
    return [torch.device("cuda", i) for i in range(n)]


def ensemble_solve(all_preds, writer_fn, device="cuda"):
    """``all_preds``: {filename: [{"points", "logits"} per model]}. Solves
    every image's pose on ``device`` (the card unless ``"cpu"`` is asked
    for) in one batched call and hands each to ``writer_fn(filename, quat,
    tvec)`` in filename order."""
    filenames = sorted(all_preds)
    if not filenames:
        return
    pts = np.stack([np.stack([m["points"] for m in all_preds[f]]) for f in filenames])
    probs = np.stack([np.stack([m["logits"] for m in all_preds[f]]) for f in filenames])
    world = torch.as_tensor(WORLD_POINTS, dtype=torch.float32, device=device)
    quat, tvec, _ = solve_pose_multi_mean_batch(
        world, torch.as_tensor(pts, dtype=torch.float32, device=device),
        torch.as_tensor(probs, dtype=torch.float32, device=device))
    quat, tvec = quat.cpu().tolist(), tvec.cpu().tolist()
    for i, f in enumerate(filenames):
        writer_fn(f, quat[i], tvec[i])


def main(args):
    """Returns the CSV's path."""
    cfg = args_to_config(args)
    ts = datetime.now().strftime("%Y%m%d-%H%M")
    real_ds = SpeedSubmissionDataset(args.data_root, args.real_ann_file, args.real_img_dir,
                                     resize=args.input_size)
    synt_ds = SpeedSubmissionDataset(args.data_root, args.synt_ann_file, args.synt_img_dir,
                                     resize=args.input_size)
    all_real, all_synt = defaultdict(list), defaultdict(list)
    trees = []
    for ckpt in args.checkpoints:
        solver = SpeedSolver(cfg, data_root=args.data_root, seed=args.seed, device=args.device)
        solver.resume(ckpt)
        solver._build()
        if args.parallel_ensemble:
            model, autocast = solver.state.model, solver._autocast
            trees.append({k: v.detach().clone() for k, v in model.state_dict().items()})
            continue
        for preds, ds in ((all_real, real_ds), (all_synt, synt_ds)):
            for f, p in gen_prediction(solver, ds, args.batch_size, args.input_size).items():
                preds[f].append(p)
    if args.parallel_ensemble:
        devices = ensemble_devices(solver.device, len(trees))
        all_real, all_synt = (
            gen_prediction_parallel(model, trees, ds, args.batch_size, args.input_size,
                                    autocast, solver.device, devices)
            for ds in (real_ds, synt_ds))

    for name, preds in (("real", all_real), ("synt", all_synt)):
        dump = {f: [{"points": m["points"].tolist(), "logits": m["logits"].tolist()}
                    for m in models] for f, models in preds.items()}
        with open(f"points_logits_{name}_{ts}.json", "w") as fh:
            json.dump(dump, fh)

    writer = SubmissionWriter()
    ensemble_solve(all_real, writer.append_real_test, args.device)
    ensemble_solve(all_synt, writer.append_test, args.device)
    return writer.export(args.submission_dir, suffix=ts)


def get_submission_parser():
    parser = argparse.ArgumentParser("gen submission (checkpoint ensemble)",
                                     parents=[get_args_parser()])
    parser.add_argument("--checkpoints", nargs="+", required=True)
    parser.add_argument("--real_ann_file", default="wz_real_test.json")
    parser.add_argument("--real_img_dir", default="images/real_test")
    parser.add_argument("--synt_ann_file", default="wz_synt_test.json")
    parser.add_argument("--synt_img_dir", default="images/test")
    parser.add_argument("--submission_dir", default="./submission")
    parser.add_argument("--parallel_ensemble", action="store_true",
                        help="run every checkpoint's forward at once per batch, one model "
                             "per card when the cards divide the checkpoints")
    return parser


if __name__ == "__main__":
    main(get_submission_parser().parse_args())
