"""Offline re-scoring of cached predictions (counterpart of
tools/simple_test_result.py; R1/simple_test_result.py:84-169).

Reads a cached predictions JSON ({filename: {points, logits}} over train
images), selects the per-label max-score point, solves P3P-RANSAC (no
iterative refinement, matching the reference script), and averages the
SPEED score against the train ground truth; an invalid pose scores as the
zero pose. The images are solved together on the device, in chunks of
``CHUNK`` (the JAX tool makes one call per image), in float64, on the card
unless ``--device cpu`` is asked for. float64, where the JAX tool casts to
float32: P3P on a few noisy points is ill-conditioned in float32 (on some
4-point samples a candidate misses its own 3 points by 10-26 px), so
float32 answers depend on how the operations round (JAX's jitted, eager
and x64 runs differ among themselves); in float64 the port and JAX's tool
under x64 agree to 1e-5.

    python -m satellite_pose_estimation_tpu_torch.tools.simple_test_result \
        --ret_file all_ret.json --gt_file data/speed/train.json
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from ..data.annotations import load_ground_truth
from ..geometry.camera import WORLD_POINTS, Camera
from ..geometry.ransac import ransac_p3p
from ..geometry.rotations import rotmat_to_quat
from ..geometry.scoring import speed_score
from ..geometry.solvers import select_keypoints
from ..ops.precision import highest_precision

CHUNK = 1024  # images a device solve; P3P-RANSAC holds ~0.2 MB of float64 candidates an image


def as_tensor(rows, device):
    """Cached values as one float64 tensor on ``device``."""
    return torch.as_tensor(np.asarray(rows), dtype=torch.float64, device=device)


def zero_invalid(quat, tvec, valid):
    """The zero pose where ``valid`` is False, as the JAX tools score it."""
    return (torch.where(valid[:, None], quat, torch.zeros_like(quat)),
            torch.where(valid[:, None], tvec, torch.zeros_like(tvec)))


@highest_precision()
def solve(points, probs, repro):
    """(quat (B, 4), tvec (B, 3), valid (B,)) of P3P-RANSAC on the selected
    keypoints of (B, Q, 2) pixels and (B, Q, C) probabilities."""
    world = torch.as_tensor(WORLD_POINTS, dtype=points.dtype, device=points.device)
    kp, mask, _ = select_keypoints(points, probs)
    r = ransac_p3p(world, kp, Camera.K_torch(points.dtype, points.device), mask, repro)
    return rotmat_to_quat(r["R"]), r["t"], r["valid"]


def main(args):
    device = torch.device(args.device)
    with open(args.ret_file) as f:
        all_ret = json.load(f)
    gt = load_ground_truth(args.gt_file)
    names = [fn for fn in all_ret if fn in gt]

    scores = []
    for s in range(0, len(names), CHUNK):
        chunk = names[s:s + CHUNK]
        quat, tvec, valid = solve(as_tensor([all_ret[fn]["points"] for fn in chunk], device),
                                  as_tensor([all_ret[fn]["logits"] for fn in chunk], device),
                                  float(args.repro))
        quat, tvec = zero_invalid(quat, tvec, valid)
        s_t, s_q = speed_score(quat, tvec, as_tensor([gt[fn]["quat"] for fn in chunk], device),
                               as_tensor([gt[fn]["tvec"] for fn in chunk], device))
        scores.extend((s_t + s_q).cpu().tolist())
    for n in range(500, len(scores) + 1, 500):
        print(f"{n} images, running mean {np.mean(scores[:n]):.6f}")
    print(f"mean speed score over {len(scores)} images: {np.mean(scores):.6f}")
    return float(np.mean(scores))


def get_args_parser():
    parser = argparse.ArgumentParser("re-score cached predictions")
    parser.add_argument("--ret_file", default="./all_ret.json")
    parser.add_argument("--gt_file", default="./data/speed/train.json")
    parser.add_argument("--repro", type=int, default=20)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card)")
    return parser


if __name__ == "__main__":
    main(get_args_parser().parse_args())
