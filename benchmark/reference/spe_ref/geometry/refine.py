"""Gauss-Newton / Levenberg-Marquardt PnP refinement, batched (counterpart
of geometry/refine.py): ``gauss_newton_pnp``, the pixel-space LM refine of
the R1 solver, and ``huber_weighted_pnp``, the sigma-weighted Huber LM on
normalised coordinates of the R2 solvers (the reference's Ceres refine).

Fixed iteration count, analytic Jacobians, 6x6 damped normal equations
solved by an unrolled Cholesky. Every operation carries the image batch as
its leading dimension; the JAX ``fori_loop`` is a Python loop.
"""
from __future__ import annotations

import torch

from .projection import normalize_points
from .rotations import inverse_rodrigues, rodrigues


def _residual_and_jacobian(world, obs, K_diag, R, t, mask):
    """Residuals (B, N, 2) and per-point Jacobians (B, N, 2, 6).

    Parameterisation: R' = exp(dw) R, t' = t + dt. ``obs`` is already in
    the frame of K_diag = (fx, fy) (pixels minus the principal point).
    """
    fx, fy = K_diag
    pc = world @ R.transpose(-1, -2) + t[:, None, :]  # (B, N, 3)
    z = pc[..., 2]
    z_safe = torch.where(torch.abs(z) < 1e-9, 1e-9, z)
    u = fx * pc[..., 0] / z_safe
    v = fy * pc[..., 1] / z_safe
    res = torch.stack([u, v], dim=-1) - obs

    inv_z = 1.0 / z_safe
    zeros = torch.zeros_like(inv_z)
    J_proj = torch.stack(
        [
            torch.stack([fx * inv_z, zeros, -fx * pc[..., 0] * inv_z * inv_z], -1),
            torch.stack([zeros, fy * inv_z, -fy * pc[..., 1] * inv_z * inv_z], -1),
        ],
        dim=-2,
    )  # (B, N, 2, 3)

    # d(pc)/d(dw) = -[R p]_x ; d(pc)/d(dt) = I
    rp = pc - t[:, None, :]
    rx, ry, rz = rp[..., 0], rp[..., 1], rp[..., 2]
    z0 = torch.zeros_like(rx)
    skew = torch.stack(
        [
            torch.stack([z0, rz, -ry], -1),
            torch.stack([-rz, z0, rx], -1),
            torch.stack([ry, -rx, z0], -1),
        ],
        dim=-2,
    )  # (B, N, 3, 3)
    J = torch.cat([J_proj @ skew, J_proj], dim=-1)  # (B, N, 2, 6)

    m = mask[..., None]
    return res * m, J * m[..., None]


def _chol_solve6(A, b):
    """Unrolled Cholesky solve of the damped SPD 6x6 systems A (B, 6, 6)
    x = b (B, 6). Elementwise over the batch, with the same
    ``max(s, 1e-30)`` pivot clamp as the JAX version (no host sync, no
    raise on a non-PD matrix)."""
    n = 6
    L = [[None] * n for _ in range(n)]
    for j in range(n):
        s = A[:, j, j]
        for k in range(j):
            s = s - L[j][k] * L[j][k]
        L[j][j] = torch.sqrt(torch.clamp(s, min=1e-30))
        inv = 1.0 / L[j][j]
        for i in range(j + 1, n):
            s = A[:, i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k]
            L[i][j] = s * inv
    y = [None] * n
    for i in range(n):
        s = b[:, i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s / L[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s / L[i][i]
    return torch.stack(x, dim=-1)


def _solve_step(res, J, lm_lambda):
    """Damped normal-equation step: (J^T J + lambda diag) dx = -J^T r."""
    B = J.shape[0]
    Jf = J.reshape(B, -1, 6)
    rf = res.reshape(B, -1)
    JtJ = Jf.transpose(1, 2) @ Jf
    Jtr = (Jf.transpose(1, 2) @ rf[..., None])[..., 0]
    eye = torch.eye(6, dtype=J.dtype, device=J.device)
    damp = (lm_lambda[:, None, None] * torch.diag_embed(torch.diagonal(JtJ, dim1=-2, dim2=-1))
            + 1e-9 * eye)
    return _chol_solve6(JtJ + damp, -Jtr)


def gauss_newton_pnp(world, image_pix, K, rvec0, tvec0, mask, iters=15):
    """Pixel-space LM refinement from initial poses (SOLVEPNP_ITERATIVE
    equivalent), masked.

    Args: world (N, 3), image_pix (B, N, 2), K (3, 3), rvec0 (B, 3),
    tvec0 (B, 3), mask (B, N). Returns (rvec (B, 3), tvec (B, 3)).
    """
    fx, fy = K[0, 0], K[1, 1]
    obs = torch.stack(
        [image_pix[..., 0] - K[0, 2], image_pix[..., 1] - K[1, 2]], dim=-1
    )
    m = mask.to(world.dtype)

    R = rodrigues(rvec0)
    t = tvec0
    lam = torch.full(t.shape[:1], 1e-3, dtype=world.dtype, device=world.device)
    for _ in range(iters):
        res, J = _residual_and_jacobian(world, obs, (fx, fy), R, t, m)
        cost0 = torch.sum(res * res, dim=(-2, -1))
        dx = _solve_step(res, J, lam)
        R_new = rodrigues(dx[:, :3]) @ R
        t_new = t + dx[:, 3:]
        res_new, _ = _residual_and_jacobian(world, obs, (fx, fy), R_new, t_new, m)
        cost1 = torch.sum(res_new * res_new, dim=(-2, -1))
        improved = cost1 < cost0
        R = torch.where(improved[:, None, None], R_new, R)
        t = torch.where(improved[:, None], t_new, t)
        lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-9, 1e6)
    return inverse_rodrigues(R), t


def _huber_block_weights(res, delta):
    """Ceres-style Huber IRLS weight of each residual block (a point's
    2-vector): sqrt(rho'(s)) with s = ||r||^2. res (B, N, 2) -> (B, N, 1)."""
    s = torch.sum(res * res, dim=-1)
    w2 = torch.where(s <= delta * delta, 1.0, delta / torch.sqrt(torch.clamp(s, min=1e-24)))
    return torch.sqrt(w2)[..., None]


def huber_weighted_pnp(world, image_pix, K, sigmas, rvec0, tvec0, mask, huber_delta=0.005,
                       iters=20):
    """Sigma-weighted Huber LM on normalised camera coordinates from initial
    poses, masked. Per point and axis the weight is
    (1 / (sqrt(sigma) + 1e-6)) / sum over the valid points of the same, the
    residual w * (projection - observation), robustified by Huber(delta)
    on each point's residual block.

    Args: world (N, 3), image_pix (B, N, 2), K (3, 3), sigmas (B, N, 2)
    variances in pixel^2, rvec0 / tvec0 (B, 3), mask (B, N).
    Returns (rvec (B, 3), tvec (B, 3)).
    """
    obs = normalize_points(image_pix, K)
    m = mask.to(world.dtype)
    w1 = 1.0 / (torch.sqrt(torch.clamp(sigmas, min=0.0)) + 1e-6) * m[..., None]
    w = w1 / torch.clamp(torch.sum(w1, dim=-2, keepdim=True), min=1e-12)  # (B, N, 2)
    unit = (1.0, 1.0)

    def robust(R, t):
        res, J = _residual_and_jacobian(world, obs, unit, R, t, m)
        res, J = res * w, J * w[..., None]
        hw = _huber_block_weights(res, huber_delta)
        return res * hw, J * hw[..., None]

    R = rodrigues(rvec0)
    t = tvec0
    lam = torch.full(t.shape[:1], 1e-3, dtype=world.dtype, device=world.device)
    for _ in range(iters):
        res_h, J_h = robust(R, t)
        cost0 = torch.sum(res_h * res_h, dim=(-2, -1))
        dx = _solve_step(res_h, J_h, lam)
        R_new = rodrigues(dx[:, :3]) @ R
        t_new = t + dx[:, 3:]
        res_new, _ = robust(R_new, t_new)
        cost1 = torch.sum(res_new * res_new, dim=(-2, -1))
        improved = cost1 < cost0
        R = torch.where(improved[:, None, None], R_new, R)
        t = torch.where(improved[:, None], t_new, t)
        lam = torch.clamp(torch.where(improved, lam * 0.5, lam * 4.0), 1e-9, 1e6)
    return inverse_rodrigues(R), t
