"""PnP point-count ablation (counterpart of tools/val_p_which_p.py;
R2/utils/val_p_which_p.py:361-495): re-solve the poses of a cached eval
log with only N of the 11 keypoints, N = 4..11.

Two subset policies, matching the reference's experiments:
* ``random`` — a random N-subset of the 11 landmarks per image
  (R2/utils/val_p_which_p.py:419-424), drawn as the JAX tool draws it (per
  N, then per image, ``rng.choice(11, n, replace=False)``), so one seed
  picks the same subsets in both packages;
* ``topn`` — the N most confident keypoints.

The refine is the sigma-weighted Huber LM when the log carries ``sigma``,
the Gauss-Newton refine otherwise. Reads the ``eval_{epoch:04d}_log.json``
that ``train.solver.SpeedSolver`` writes and solves the images of each N
together on the device in float64 (in chunks of
``simple_test_result.CHUNK``; the JAX tool makes one float32 call per
image: simple_test_result.py says why float64), on the card unless
``--device cpu`` is asked for:

    python -m satellite_pose_estimation_tpu_torch.tools.val_p_which_p \
        --eval_log output/run/eval_0009_log.json --mode topn
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..geometry.camera import WORLD_POINTS, Camera
from ..geometry.ransac import ransac_p3p
from ..geometry.refine import gauss_newton_pnp, huber_weighted_pnp
from ..geometry.rotations import inverse_rodrigues, rodrigues, rotmat_to_quat
from ..geometry.scoring import speed_score
from ..geometry.solvers import select_keypoints
from ..ops.precision import highest_precision
from .simple_test_result import CHUNK, as_tensor, zero_invalid


def make_solver(repro: float, use_sigma: bool):
    """solve(points (B, Q, 2), probs (B, Q, C), sigmas (B, Q, 2), keep
    (B, 11) bool) -> (quat, tvec, valid): P3P-RANSAC on the kept selected
    keypoints, then the refine on its inliers."""

    @highest_precision()
    def solve(points, probs, sigmas, keep):
        world = torch.as_tensor(WORLD_POINTS, dtype=points.dtype, device=points.device)
        K = Camera.K_torch(points.dtype, points.device)
        kp, mask, sig = select_keypoints(points, probs, sigmas)
        r = ransac_p3p(world, kp, K, mask & keep, repro)
        rv0, tv0 = inverse_rodrigues(r["R"]), r["t"]
        if use_sigma:
            rv, tv = huber_weighted_pnp(world, kp, K, sig, rv0, tv0, r["inliers"])
        else:
            rv, tv = gauss_newton_pnp(world, kp, K, rv0, tv0, r["inliers"])
        return rotmat_to_quat(rodrigues(rv)), tv, r["valid"]

    return solve


def confidence_topn_mask(probs, n):
    """(..., 11) bool: the ``n`` keypoints whose best foreground query is the
    most confident, from (..., Q, 12) probabilities (ties to the lower
    index, as JAX's stable argsort)."""
    scores = probs.amax(dim=-1)
    labels = torch.argmax(probs, dim=-1)  # the first maximum, as jnp.argmax
    ids = torch.arange(11, device=probs.device)[:, None]
    per_label = torch.where((labels[..., None, :] == ids) & (labels[..., None, :] != 11),
                            scores[..., None, :], 0.0)
    order = torch.argsort(-per_label.amax(dim=-1), dim=-1, stable=True)
    keep = torch.zeros(order.shape, dtype=torch.bool, device=probs.device)
    return keep.scatter(-1, order[..., :n], True)


def random_keep(rng, n_images, n):
    """(n_images, 11) bool: a random ``n``-subset an image, drawn in order."""
    keep = np.zeros((n_images, 11), bool)
    for i in range(n_images):
        keep[i, rng.choice(11, n, replace=False)] = True
    return keep


def main(args):
    device = torch.device(args.device)
    with open(args.eval_log) as f:
        log = json.load(f)
    rng = np.random.RandomState(args.seed)

    items = [it for it in log.values() if "quat_gt" in it]
    if not items:
        print("eval log has no ground truth entries")
        return

    has_sigma = "sigma" in items[0]
    solve = make_solver(float(args.repro), has_sigma)
    points = as_tensor([it["points"] for it in items], device)
    probs = as_tensor([it["logits"] for it in items], device)
    sigmas = (as_tensor([it["sigma"] for it in items], device) if has_sigma
              else torch.ones_like(points))
    q_gt = as_tensor([it["quat_gt"] for it in items], device)
    t_gt = as_tensor([it["tvec_gt"] for it in items], device)

    results = {}
    for n in range(4, 12):
        if args.mode == "random":
            keep = torch.as_tensor(random_keep(rng, len(items), n), device=device)
        else:
            keep = confidence_topn_mask(probs, n)
        scores = []
        for s in range(0, len(items), CHUNK):
            part = slice(s, s + CHUNK)
            quat, tvec, valid = solve(points[part], probs[part], sigmas[part], keep[part])
            quat, tvec = zero_invalid(quat, tvec, valid)
            s_t, s_q = speed_score(quat, tvec, q_gt[part], t_gt[part])
            scores.append(s_t + s_q)
        results[n] = float(torch.cat(scores).double().mean())
        print(f"{args.mode} N={n}: mean score {results[n]:.6f} "
              f"over {len(items)} images"
              + (" (sigma-weighted)" if has_sigma else ""))
    return results


def get_args_parser():
    parser = argparse.ArgumentParser("PnP point-count ablation")
    parser.add_argument("--eval_log", required=True)
    parser.add_argument("--repro", type=int, default=25)
    parser.add_argument("--mode", choices=("random", "topn"), default="random")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    return parser


if __name__ == "__main__":
    main(get_args_parser().parse_args())
