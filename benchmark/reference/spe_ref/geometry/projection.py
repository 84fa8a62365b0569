"""Pinhole projection helpers (counterpart of geometry/projection.py)."""
from __future__ import annotations

import torch

from .rotations import quat_to_rotmat, rodrigues


def project_points(pts, K, R, t):
    """Project world points through [R|t] and intrinsics K.

    Args:
        pts: (..., N, 3) world points (broadcast against R's batch dims).
        K: (3, 3) intrinsics.
        R: (..., 3, 3) rotation.
        t: (..., 3) translation.
    Returns:
        (..., N, 2) pixel coordinates, (..., N) camera-frame depth.
    """
    pc = pts @ R.transpose(-1, -2) + t[..., None, :]
    z = pc[..., 2]
    zs = torch.where(torch.abs(z) < 1e-12, 1e-12, z)[..., None]
    xy = pc[..., :2] / zs
    u = K[0, 0] * xy[..., 0] + K[0, 2]
    v = K[1, 1] * xy[..., 1] + K[1, 2]
    return torch.stack([u, v], dim=-1), z


def project_points_rvec(pts, K, rvec, tvec):
    return project_points(pts, K, rodrigues(rvec), tvec)


def project_points_quat(pts, K, quat, tvec):
    """Project with a scalar-first quaternion (standard R(q) convention)."""
    return project_points(pts, K, quat_to_rotmat(quat), tvec)


def normalize_points(pix, K):
    """Pixel -> normalized camera coordinates (zero distortion)."""
    x = (pix[..., 0] - K[0, 2]) / K[0, 0]
    y = (pix[..., 1] - K[1, 2]) / K[1, 1]
    return torch.stack([x, y], dim=-1)
