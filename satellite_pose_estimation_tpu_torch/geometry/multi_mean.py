"""Checkpoint-ensemble pose solving (counterpart of geometry/multi_mean.py;
the reference's Multi_Mean_PoseSolver, R1/utils/speed_eval.py:42-140).

Every foreground prediction of M models is pooled by keypoint label and
averaged; where a label has at least 3 points, those farther from the mean
than 3 standard deviations of the distances to it are dropped (all of them
kept if that would drop every one); then the P3P-RANSAC and the pixel LM
refine run on the per-label means. Fixed shapes (M * Q candidate slots a
label, masked), batched over images, no host sync.
"""
from __future__ import annotations

import torch

from ..ops.precision import highest_precision
from .camera import Camera
from .ransac import ransac_p3p
from .refine import gauss_newton_pnp
from .rotations import inverse_rodrigues, rodrigues
from .solvers import SolverConfig, _finalize


@highest_precision()
def solve_pose_multi_mean_batch(world, points, probs, config: SolverConfig = SolverConfig()):
    """Args: world (K, 3), points (B, M, Q, 2) per-model query points in
    original-image pixels, probs (B, M, Q, K + 1) per-model softmax
    probabilities. Returns (quat (B, 4), tvec (B, 3), valid (B,))."""
    B = points.shape[0]
    K = config.num_keypoints
    dtype = world.dtype
    pts = points.reshape(B, -1, 2).to(dtype)
    flat_probs = probs.reshape(B, pts.shape[1], -1)
    labels = torch.argmax(flat_probs, dim=-1)
    fg = labels != flat_probs.shape[-1] - 1

    label_ids = torch.arange(K, device=points.device)
    assigned = (labels[:, None, :] == label_ids[None, :, None]) & fg[:, None, :]  # (B, K, MQ)
    counts = torch.sum(assigned, dim=-1)
    w = assigned.to(dtype)
    denom = torch.clamp(counts.to(dtype), min=1.0)[..., None]
    mean0 = (w @ pts) / denom  # (B, K, 2)

    # 3-sigma filter on the distance to the mean, only where count >= 3
    d = torch.linalg.norm(pts[:, None, :, :] - mean0[:, :, None, :], dim=-1)  # (B, K, MQ)
    d_mean = torch.sum(d * w, dim=-1) / denom[..., 0]
    d_var = torch.sum(w * (d - d_mean[..., None]) ** 2, dim=-1) / denom[..., 0]
    d_std = torch.sqrt(torch.clamp(d_var, min=0.0))
    keep = assigned & (d < (3.0 * d_std)[..., None])
    keep = torch.where((counts >= 3)[..., None], keep, assigned)
    # the guard: a filter that removes every point falls back to the plain mean
    keep = torch.where((torch.sum(keep, dim=-1) == 0)[..., None], assigned, keep)

    wk = keep.to(dtype)
    kp = (wk @ pts) / torch.clamp(torch.sum(wk, dim=-1), min=1.0)[..., None]
    mask = counts > 0

    Kmat = Camera.K_torch(dtype, world.device)
    ransac = ransac_p3p(world, kp, Kmat, mask, config.reproj_threshold, max_points=K)
    rvec, tvec = gauss_newton_pnp(world, kp, Kmat, inverse_rodrigues(ransac["R"]), ransac["t"],
                                  ransac["inliers"], iters=config.refine_iters)
    quat, tvec = _finalize(rodrigues(rvec), tvec, ransac["valid"])
    return quat, tvec, ransac["valid"]


def solve_pose_multi_mean(world, points, probs, config: SolverConfig = SolverConfig()):
    """One image: points (M, Q, 2), probs (M, Q, K + 1) -> (quat (4,),
    tvec (3,), valid ())."""
    quat, tvec, valid = solve_pose_multi_mean_batch(world, points[None], probs[None], config)
    return quat[0], tvec[0], valid[0]
