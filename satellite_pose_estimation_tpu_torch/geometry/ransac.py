"""Exhaustive minimal-sample RANSAC over P3P, batched (counterpart of
geometry/ransac.py).

Every 3-point minimal sample of the <= 11 keypoints is solved at once
(C(11,3) = 165 triples x <= 4 P3P solutions = 660 candidate poses per
image), every candidate is scored by inlier count and inlier error against
the full masked point set, and the best one is kept. The JAX version vmaps
one image; here the image batch is an explicit leading dimension.
"""
from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

from ..utils.constants import device_constant
from .p3p import p3p_solutions
from .projection import project_points


def _all_triples(n: int) -> np.ndarray:
    return np.asarray(list(combinations(range(n), 3)), dtype=np.int64)


def ransac_p3p(world, image_pix, K, mask, reproj_threshold, max_points=11):
    """Exhaustive-minimal-sample robust pose for a batch of images.

    Args:
        world: (N, 3) world points (N = max_points).
        image_pix: (B, N, 2) observed pixels.
        K: (3, 3) intrinsics.
        mask: (B, N) bool validity of each correspondence.
        reproj_threshold: pixel threshold for inliers.
    Returns:
        dict with R (B, 3, 3), t (B, 3), inliers (B, N) bool and
        valid (B,) bool (False with < 4 valid points or no candidate).
    """
    B = image_pix.shape[0]
    triples = device_constant(f"ransac.triples.{max_points}",
                              lambda: _all_triples(max_points), world.device)
    n_tri = triples.shape[0]

    w3 = world[triples]  # (T, 3, 3)
    p3 = image_pix[:, triples]  # (B, T, 3, 2)
    sample_ok = torch.all(mask[:, triples], dim=-1)  # (B, T)

    Rs, ts, cand_valid = p3p_solutions(w3.expand(B, n_tri, 3, 3), p3, K)
    cand_valid = cand_valid & sample_ok[..., None]  # (B, T, 4)

    Rs_f = Rs.reshape(B, n_tri * 4, 3, 3)
    ts_f = ts.reshape(B, n_tri * 4, 3)
    valid_f = cand_valid.reshape(B, n_tri * 4)

    proj, depth = project_points(world, K, Rs_f, ts_f)  # (B, C, N, 2), (B, C, N)
    err = torch.linalg.norm(proj - image_pix[:, None], dim=-1)  # (B, C, N)
    inl = (err < reproj_threshold) & (depth > 0) & mask[:, None, :]
    n_inl = torch.sum(inl, dim=-1)
    inl_err = torch.sum(torch.where(inl, err, 0.0), dim=-1)

    # Rank: maximise inliers, tie-break on low inlier error; invalid -> -1.
    score = torch.where(valid_f, n_inl.to(world.dtype) - inl_err * 1e-6, -1.0)
    best = torch.argmax(score, dim=-1)  # (B,)

    rows = torch.arange(B, device=world.device)
    ok = (valid_f[rows, best] & (n_inl[rows, best] >= 4)
          & (torch.sum(mask, dim=-1) >= 4))
    return {
        "R": Rs_f[rows, best],
        "t": ts_f[rows, best],
        "inliers": inl[rows, best],
        "valid": ok,
    }
