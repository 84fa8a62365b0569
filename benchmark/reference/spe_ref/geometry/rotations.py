"""Rotation parameterisations: quaternions, rotation matrices, axis-angle
(counterpart of geometry/rotations.py).

Every function takes arbitrary leading batch dimensions and uses the
scalar-first (w, x, y, z) quaternion convention of the SPEED dataset.
``quat_to_rotmat(q)`` acts on column vectors; ``quat_to_dcm(q)`` is its
transpose (the SPEED direction cosine matrix).
"""
from __future__ import annotations

import torch


def quat_normalize(q):
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_to_rotmat(q):
    """Quaternion (w,x,y,z) -> 3x3 rotation matrix (column-vector convention)."""
    q = quat_normalize(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    rows = [
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ]
    return torch.stack([torch.stack(r, dim=-1) for r in rows], dim=-2)


def rotmat_to_quat(R):
    """3x3 rotation matrix -> quaternion (w,x,y,z), Shepperd's method.

    Branch-free: all four pivots are computed and the one with the largest
    trace term is taken. The global sign is arbitrary; SPEED scoring
    canonicalises via ``q[0] >= 0``.
    """
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]

    tr = m00 + m11 + m22
    tw = 1.0 + tr
    tx = 1.0 + m00 - m11 - m22
    ty = 1.0 - m00 + m11 - m22
    tz = 1.0 - m00 - m11 + m22

    sw = torch.sqrt(torch.clamp(tw, min=1e-12)) * 2.0  # 4w
    sx = torch.sqrt(torch.clamp(tx, min=1e-12)) * 2.0  # 4x
    sy = torch.sqrt(torch.clamp(ty, min=1e-12)) * 2.0  # 4y
    sz = torch.sqrt(torch.clamp(tz, min=1e-12)) * 2.0  # 4z
    cand = torch.stack(
        [
            torch.stack([0.25 * sw, (m21 - m12) / sw, (m02 - m20) / sw,
                         (m10 - m01) / sw], dim=-1),
            torch.stack([(m21 - m12) / sx, 0.25 * sx, (m01 + m10) / sx,
                         (m02 + m20) / sx], dim=-1),
            torch.stack([(m02 - m20) / sy, (m01 + m10) / sy, 0.25 * sy,
                         (m12 + m21) / sy], dim=-1),
            torch.stack([(m10 - m01) / sz, (m02 + m20) / sz,
                         (m12 + m21) / sz, 0.25 * sz], dim=-1),
        ],
        dim=-2,
    )  # (..., 4 cases, 4)
    best = torch.argmax(torch.stack([tw, tx, ty, tz], dim=-1), dim=-1)
    idx = best[..., None, None].expand(*best.shape, 1, 4)
    q = torch.gather(cand, -2, idx).squeeze(-2)
    return quat_normalize(q)


def quat_to_dcm(q):
    """SPEED quat2dcm: returns R(q)^T (inertial->body direction cosine matrix)."""
    return quat_to_rotmat(q).transpose(-1, -2)


def dcm_to_quat(dcm):
    return rotmat_to_quat(dcm.transpose(-1, -2))


def rodrigues(rvec):
    """Axis-angle (..., 3) -> rotation matrix (..., 3, 3), Taylor-safe near 0."""
    theta2 = torch.sum(rvec * rvec, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    small = theta2 < 1e-12
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-24))

    x, y, z = rvec[..., 0], rvec[..., 1], rvec[..., 2]
    zeros = torch.zeros_like(x)
    K = torch.stack(
        [
            torch.stack([zeros, -z, y], dim=-1),
            torch.stack([z, zeros, -x], dim=-1),
            torch.stack([-y, x, zeros], dim=-1),
        ],
        dim=-2,
    )
    eye = torch.eye(3, dtype=rvec.dtype, device=rvec.device).expand(K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * (K @ K)


def inverse_rodrigues(R):
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3) via the quaternion
    (robust near theta = 0 and pi)."""
    q = rotmat_to_quat(R)
    q = q * torch.where(q[..., :1] < 0, -1.0, 1.0)  # w >= 0: theta in [0, pi]
    w = torch.clamp(q[..., 0], -1.0, 1.0)
    v = q[..., 1:]
    vnorm = torch.linalg.norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vnorm, w)
    scale = torch.where(vnorm < 1e-9, 2.0, theta / torch.clamp(vnorm, min=1e-24))
    return v * scale[..., None]


def quat_multiply(q1, q2):
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ],
        dim=-1,
    )
