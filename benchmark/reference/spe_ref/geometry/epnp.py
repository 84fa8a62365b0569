"""EPnP (Lepetit et al.), masked, fixed-shape and batched (counterpart of
geometry/epnp.py).

The N = 1 and N = 2 beta cases with a least-squares scale fit and a
positive-depth sign; the case with the lower reprojection error is kept.
The result is a basin-accurate initialisation for the Huber refine
(refine.py). Fixed-size linear algebra only (a 3x3 eigh and solve per
image for the control points, a 12x12 eigh, 3x3 SVDs, a 6x3 least
squares), every operation batched over the images; no branch on data.
``torch.linalg.eigh`` may pick other eigenvector signs than JAX's, which
moves the PCA control points but not the pose they lead to, so the tests
compare poses.
"""
from __future__ import annotations

import torch

from .projection import normalize_points

_PAIRS = [(0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)]


def _wmean(x, w, wsum):
    """Weighted mean over the points of x (..., N, 3) with w (B, N) -> (B, 3)."""
    return torch.sum(x * w[..., None], dim=-2) / wsum[:, None]


def _kabsch(pw, pc, w):
    """Weighted rigid alignment of world points pw (N, 3) to camera points
    pc (B, N, 3): R (B, 3, 3), t (B, 3) with pc ~= R pw + t."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    cw = _wmean(pw, w, wsum)
    cc = _wmean(pc, w, wsum)
    A = (pw - cw[:, None]) * w[..., None]
    H = A.transpose(-1, -2) @ (pc - cc[:, None])
    U, _, Vt = torch.linalg.svd(H)
    d = torch.sign(torch.linalg.det(Vt.transpose(-1, -2) @ U.transpose(-1, -2)))
    D = torch.diag_embed(torch.stack([torch.ones_like(d), torch.ones_like(d), d], dim=-1))
    R = Vt.transpose(-1, -2) @ D @ U.transpose(-1, -2)
    t = cc - (R @ cw[..., None])[..., 0]
    return R, t


def _control_points(world, w):
    """Centroid + PCA-scaled control points of the masked world points:
    (B, 4, 3)."""
    wsum = torch.clamp(torch.sum(w, dim=-1), min=1e-9)
    c0 = _wmean(world, w, wsum)
    d = world - c0[:, None]
    cov = (d * w[..., None]).transpose(-1, -2) @ d
    eigval, eigvec = torch.linalg.eigh(cov)
    # Degenerate directions are floored so the barycentric solve stays
    # invertible.
    scale = torch.sqrt(torch.clamp(eigval / wsum[:, None], min=1e-8))
    cs = c0[:, None, :] + (eigvec * scale[:, None, :]).transpose(-1, -2)
    return torch.cat([c0[:, None], cs], dim=1)


def _barycentric(world, ctrl):
    """alphas (B, N, 4) with world_i = sum_j alpha_ij ctrl_j, sum_j alpha = 1."""
    basis = (ctrl[:, 1:] - ctrl[:, 0:1]).transpose(-1, -2)  # columns c_j - c_0
    rhs = (world - ctrl[:, 0:1]).transpose(-1, -2)  # (B, 3, N)
    a123 = torch.linalg.solve_ex(basis, rhs)[0].transpose(-1, -2)
    return torch.cat([1.0 - a123.sum(-1, keepdim=True), a123], dim=-1)


def _pair_dist(p, i, j):
    return torch.linalg.norm(p[:, i] - p[:, j], dim=-1)


def _scale_and_sign(ccs, ctrl, alphas, w):
    """Least-squares scale between the camera and world control-point
    distances, then the sign that gives a positive mean depth."""
    num = sum(_pair_dist(ccs, i, j) * _pair_dist(ctrl, i, j) for i, j in _PAIRS)
    den = sum(_pair_dist(ccs, i, j) ** 2 for i, j in _PAIRS)
    ccs = ccs * (num / torch.clamp(den, min=1e-12))[:, None, None]
    depth = torch.sum((alphas @ ccs)[..., 2] * w, dim=-1)
    return torch.where((depth < 0)[:, None, None], -ccs, ccs)


def _reproj_err(world, obs_norm, R, t, w):
    pc = world @ R.transpose(-1, -2) + t[:, None, :]
    z = torch.where(torch.abs(pc[..., 2:3]) < 1e-9, 1e-9, pc[..., 2:3])
    err = torch.linalg.norm(pc[..., :2] / z - obs_norm, dim=-1)
    return torch.sum(err * w, dim=-1)


def epnp(world, image_pix, K, mask=None):
    """Masked EPnP for a batch.

    Args:
        world: (N, 3) world points.
        image_pix: (B, N, 2) observed pixels.
        K: (3, 3) intrinsics.
        mask: optional (B, N) validity (>= 4 valid points for a pose).
    Returns:
        R (B, 3, 3), t (B, 3): world -> camera. An image with fewer than 4
        valid points has no EPnP pose; it is solved on all its points
        instead, a pose that means nothing (the solvers mark the image
        invalid). That keeps every matrix decomposed here well-formed: on
        the card such images once made the 12 x 12 normal matrix NaN, and
        its ``eigh`` raised.
    """
    B, n = image_pix.shape[:2]
    w = (torch.ones((B, n), dtype=world.dtype, device=world.device) if mask is None
         else mask.to(world.dtype))
    w = torch.where((w.sum(-1) >= 4)[:, None], w, 1.0)
    obs = normalize_points(image_pix, K)
    ctrl = _control_points(world, w)
    alphas = _barycentric(world, ctrl)

    # M^T M of the 2N x 12 system; a masked point's rows are zero. Row pair
    # of point i: [a_j, 0, -a_j x_i], [0, a_j, -a_j y_i] per control point j.
    a = alphas * w[..., None]
    zeros = torch.zeros_like(a)
    row_x = torch.stack([a, zeros, -a * obs[..., 0:1]], dim=-1).reshape(B, n, 12)
    row_y = torch.stack([zeros, a, -a * obs[..., 1:2]], dim=-1).reshape(B, n, 12)
    M = torch.cat([row_x, row_y], dim=1)
    _, eigvec = torch.linalg.eigh(M.transpose(-1, -2) @ M)  # ascending

    # N = 1: the smallest eigenvector.
    v1 = eigvec[..., 0].reshape(B, 4, 3)
    R1, t1 = _kabsch(world, alphas @ _scale_and_sign(v1, ctrl, alphas, w), w)

    # N = 2: the two smallest; [b11, b12, b22] from the distance system in
    # the minimum-norm least-squares sense (an SVD, as JAX's lstsq), then
    # (b1, b2).
    v2 = eigvec[..., 1].reshape(B, 4, 3)
    rows, rho = [], []
    for i, j in _PAIRS:
        dv1, dv2 = v1[:, i] - v1[:, j], v2[:, i] - v2[:, j]
        rows.append(torch.stack([(dv1 * dv1).sum(-1), 2.0 * (dv1 * dv2).sum(-1),
                                 (dv2 * dv2).sum(-1)], dim=-1))
        dw = ctrl[:, i] - ctrl[:, j]
        rho.append((dw * dw).sum(-1))
    L = torch.stack(rows, dim=1)  # (B, 6, 3)
    sol = (torch.linalg.pinv(L) @ torch.stack(rho, dim=1)[..., None])[..., 0]
    b11, b12 = sol[:, 0], sol[:, 1]
    b1 = torch.sqrt(torch.clamp(torch.abs(b11), min=1e-12))
    b1 = torch.where(b11 < 0, 0.0, b1)
    b2 = torch.where(b11 < 0, 0.0, b12 / torch.clamp(b1, min=1e-12))
    ccs2 = _scale_and_sign(b1[:, None, None] * v1 + b2[:, None, None] * v2, ctrl, alphas, w)
    R2, t2 = _kabsch(world, alphas @ ccs2, w)

    use1 = _reproj_err(world, obs, R1, t1, w) <= _reproj_err(world, obs, R2, t2, w)
    return (torch.where(use1[:, None, None], R1, R2), torch.where(use1[:, None], t1, t2))
