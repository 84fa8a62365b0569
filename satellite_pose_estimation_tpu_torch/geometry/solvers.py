"""Batched pose solvers (counterpart of geometry/solvers.py). Each takes a
batch of images and runs without a branch on data or a host round trip:

* ``solve_pose_simple`` (R1): per-label best-query selection, exhaustive
  P3P-RANSAC init, pixel-space Gauss-Newton refine on the inliers;
* ``solve_pose_sigma`` (R2): the same init at the sigma threshold, then
  the sigma-weighted Huber refine;
* ``solve_pose_self_assessed`` (R2's headline): EPnP on every selected
  point, inliers at a threshold from the detection box's area, the Huber
  refine on them, and the EPnP pose kept where the refine does not lower
  the total reprojection error.

An unsolvable image yields the zero pose with ``valid = False`` instead of
raising.

Each solver runs as stages: the keypoint selection, the pose init (span
``solver.init``), the refine (span ``solver.refine``) and the
finalisation. On a card each stage but EPnP's init replays a CUDA graph
(``utils/graphs.py``); EPnP's ``eigh`` / ``svd`` / ``pinv`` check their
status on the host, which a graph cannot capture, so that init runs
eagerly.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.precision import highest_precision
from ..utils.graphs import graphed
from ..utils.profiling import span
from .camera import Camera
from .epnp import epnp
from .projection import project_points
from .ransac import ransac_p3p
from .refine import gauss_newton_pnp, huber_weighted_pnp
from .rotations import inverse_rodrigues, rodrigues, rotmat_to_quat


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    num_keypoints: int = 11
    reproj_threshold: float = 20.0  # R1 --repro default
    sigma_reproj_threshold: float = 25.0  # R2 SimplePoseSolverSigma
    huber_delta: float = 0.005
    refine_iters: int = 15
    input_size: int = 256  # for the adaptive threshold of the self-assessed path


def select_keypoints(points, probs, sigmas=None, num_keypoints=11):
    """Per-label best-query selection.

    label = argmax prob; background queries (label == num_keypoints) are
    dropped; per label the query with the highest probability is kept.

    Args:
        points: (B, Q, 2) predicted points (original-image pixels).
        probs: (B, Q, num_keypoints + 1) softmax probabilities.
        sigmas: optional (B, Q, 2) per-point variances.
    Returns:
        kp (B, K, 2), mask (B, K) bool and sig (B, K, 2) (ones without
        sigmas).
    """
    labels = torch.argmax(probs, dim=-1)  # first maximum, as jnp.argmax
    scores = torch.amax(probs, dim=-1)
    fg = labels != probs.shape[-1] - 1

    label_ids = torch.arange(num_keypoints, device=probs.device)
    assigned = (labels[:, None, :] == label_ids[None, :, None]) & fg[:, None, :]
    table = torch.where(assigned, scores[:, None, :], -torch.inf)  # (B, K, Q)
    best_q = torch.argmax(table, dim=-1)  # (B, K); all -inf -> 0
    mask = torch.any(assigned, dim=-1)
    rows = best_q[..., None].expand(*best_q.shape, 2)
    kp = torch.gather(points, 1, rows)
    sig = torch.ones_like(kp) if sigmas is None else torch.gather(sigmas, 1, rows)
    return kp, mask, sig


def _finalize(R, t, valid):
    quat = rotmat_to_quat(R)
    quat = torch.where(valid[:, None], quat, torch.zeros_like(quat))
    tvec = torch.where(valid[:, None], t, torch.zeros_like(t))
    return quat, tvec


def _p3p_init(world, kp, K, mask, threshold, max_points):
    ransac = ransac_p3p(world, kp, K, mask, threshold, max_points=max_points)
    return inverse_rodrigues(ransac["R"]), ransac["t"], ransac["inliers"], ransac["valid"]


def _gauss_newton_refine(world, kp, K, rvec0, t0, inliers, iters):
    rvec, tvec = gauss_newton_pnp(world, kp, K, rvec0, t0, inliers, iters=iters)
    return rodrigues(rvec), tvec


def _huber_refine(world, kp, K, sig, rvec0, t0, inliers, huber_delta):
    rvec, tvec = huber_weighted_pnp(world, kp, K, sig, rvec0, t0, inliers,
                                    huber_delta=huber_delta)
    return rodrigues(rvec), tvec


def _total_err(world, K, kp, mask, R, t):
    proj, _ = project_points(world, K, R, t)
    err = torch.linalg.norm(proj - kp, dim=-1)
    return err, torch.sum(torch.where(mask, err, 0.0), dim=-1)


def _epnp_init(world, kp, K, mask, bbox_area, input_size):
    th = torch.clamp(torch.floor(bbox_area.to(world.dtype) / input_size * 10.0), 1.5, 20.0)
    R0, t0 = epnp(world, kp, K, mask)
    err0, rep_err_init = _total_err(world, K, kp, mask, R0, t0)
    inliers = (err0 < th[:, None]) & mask
    valid = torch.sum(mask, dim=-1) >= 4
    return inverse_rodrigues(R0), R0, t0, rep_err_init, inliers, valid


def _self_assessed_refine(world, kp, K, sig, mask, rvec0, R0, t0, rep_err_init, inliers):
    rvec, tvec = huber_weighted_pnp(world, kp, K, sig, rvec0, t0, inliers, huber_delta=0.001)
    R1 = rodrigues(rvec)
    _, rep_err_ref = _total_err(world, K, kp, mask, R1, tvec)
    use_refined = rep_err_ref <= rep_err_init
    return (torch.where(use_refined[:, None, None], R1, R0),
            torch.where(use_refined[:, None], tvec, t0))


def _solve(solver, world, points, probs, sigmas, bbox_area, config):
    """The stages of ``solver`` ("simple", "sigma" or "self_assessed")."""
    K = Camera.K_torch(world.dtype, world.device)
    kp, mask, sig = graphed("solver.select", select_keypoints, points, probs, sigmas,
                            config.num_keypoints)
    if solver == "self_assessed":
        with span("solver.init"):
            rvec0, R0, t0, rep_err_init, inliers, valid = _epnp_init(
                world, kp, K, mask, bbox_area, config.input_size)
        with span("solver.refine"):
            R, t = graphed("solver.refine", _self_assessed_refine, world, kp, K, sig, mask,
                           rvec0, R0, t0, rep_err_init, inliers)
    else:
        threshold = (config.reproj_threshold if solver == "simple"
                     else config.sigma_reproj_threshold)
        with span("solver.init"):
            rvec0, t0, inliers, valid = graphed("solver.init", _p3p_init, world, kp, K, mask,
                                                threshold, config.num_keypoints)
        with span("solver.refine"):
            if solver == "simple":
                R, t = graphed("solver.refine", _gauss_newton_refine, world, kp, K, rvec0, t0,
                               inliers, config.refine_iters)
            else:
                R, t = graphed("solver.refine", _huber_refine, world, kp, K, sig, rvec0, t0,
                               inliers, config.huber_delta)
    quat, tvec = graphed("solver.finalize", _finalize, R, t, valid)
    return quat, tvec, valid


@highest_precision()
def solve_pose_simple(world, points, probs, config: SolverConfig = SolverConfig()):
    """P3P-RANSAC init + pixel LM refine on the inliers, for a batch.

    Args: world (N, 3), points (B, Q, 2) pixels, probs (B, Q, C).
    Returns (quat (B, 4), tvec (B, 3), valid (B,)).
    """
    return _solve("simple", world, points, probs, None, None, config)


@highest_precision()
def solve_pose_sigma(world, points, probs, sigmas, config: SolverConfig = SolverConfig()):
    """P3P-RANSAC init at ``sigma_reproj_threshold``, then the
    sigma-weighted Huber refine on the inliers, for a batch. As in JAX, the
    init is the exhaustive minimal-sample P3P RANSAC in place of the
    reference's sampled EPnP RANSAC.

    Args: world (N, 3), points (B, Q, 2) pixels, probs (B, Q, C), sigmas
    (B, Q, 2) variances in pixel^2. Returns (quat (B, 4), tvec (B, 3),
    valid (B,)).
    """
    return _solve("sigma", world, points, probs, sigmas, None, config)


@highest_precision()
def solve_pose_self_assessed(world, points, probs, sigmas, bbox_area,
                             config: SolverConfig = SolverConfig()):
    """EPnP on every selected point; inliers within
    clamp(floor(bbox_area / input_size * 10), 1.5, 20) px of its
    projection; the Huber refine (delta 0.001) on them; and the EPnP pose
    kept where the refined one has a larger total reprojection error.

    Args: as ``solve_pose_sigma``, plus bbox_area (B,). Returns (quat
    (B, 4), tvec (B, 3), valid (B,): at least 4 selected points).
    """
    return _solve("self_assessed", world, points, probs, sigmas, bbox_area, config)
