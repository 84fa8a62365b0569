"""Closed-form P3P (Grunert formulation), batched (counterpart of
geometry/p3p.py).

Branch-free arithmetic over any leading batch dims: the quartic in v comes
from the law-of-cosines elimination, its roots from Ferrari's closed form
in complex arithmetic (complex64 for float32 input), polished by Newton
steps, and each candidate pose from orthonormal triads.

    s1^2 (u^2 + v^2 - 2 u v cos_a) = a^2      a = |P2-P3|, cos_a = f2.f3
    s1^2 (1 + v^2 - 2 v cos_b)     = b^2      b = |P1-P3|, cos_b = f1.f3
    s1^2 (1 + u^2 - 2 u cos_c)     = c^2      c = |P1-P2|, cos_c = f1.f2
"""
from __future__ import annotations

import torch


def _poly_mul(p, q):
    """Multiply polynomial coefficient lists (lowest degree first)."""
    res = [0.0] * (len(p) + len(q) - 1)
    for i, pi in enumerate(p):
        for j, qj in enumerate(q):
            res[i + j] = res[i + j] + pi * qj
    return res


def _quartic_coeffs(a2, b2, c2, cos_a, cos_b, cos_c):
    """Quartic in v, lowest degree first, shape (..., 5).

    Q(v) = v^2 + k*(v^2 - 2 v cos_b + 1) - 1,  k = (c^2 - a^2)/b^2
    D(v) = 2 (v cos_a - cos_c)
    m(v) = (c^2/b^2) (v^2 - 2 v cos_b + 1)
    quartic: Q^2 - 2 cos_c * Q * D + (1 - m) * D^2 = 0
    """
    k = (c2 - a2) / b2
    kc = c2 / b2
    Q = [k - 1.0, -2.0 * cos_b * k, 1.0 + k]
    D = [-2.0 * cos_c, 2.0 * cos_a]
    one_minus_m = [1.0 - kc, 2.0 * cos_b * kc, -kc]

    t1 = _poly_mul(Q, Q)
    t2 = _poly_mul(Q, D)
    t3 = _poly_mul(one_minus_m, _poly_mul(D, D))

    coeffs = []
    for deg in range(5):
        c_val = t1[deg] + t3[deg]
        if deg < len(t2):
            c_val = c_val - 2.0 * cos_c * t2[deg]
        coeffs.append(c_val)
    return torch.stack(coeffs, dim=-1)


def _quartic_roots_ferrari(coeffs):
    """Closed-form quartic roots (Ferrari + complex Cardano resolvent).

    coeffs lowest-degree first, shape (..., 5); returns complex roots
    (..., 4), complex128 for float64 input and complex64 otherwise. The
    principal branches of ``sqrt`` and of the cube root are the ones the
    JAX version takes; degenerate cases (leading coefficient ~0,
    biquadratic q ~ 0, double resolvent root) are guarded arithmetically.
    """
    ctype = torch.complex128 if coeffs.dtype == torch.float64 else torch.complex64
    lead = coeffs[..., 4]
    lead = torch.where(torch.abs(lead) < 1e-12, 1e-12, lead)
    a = (coeffs[..., 3] / lead).to(ctype)
    b = (coeffs[..., 2] / lead).to(ctype)
    c = (coeffs[..., 1] / lead).to(ctype)
    d = (coeffs[..., 0] / lead).to(ctype)

    # Depressed quartic y^4 + p y^2 + q y + r, v = y - a/4.
    a2 = a * a
    p = b - 3.0 * a2 / 8.0
    q = c - a * b / 2.0 + a2 * a / 8.0
    r = d - a * c / 4.0 + a2 * b / 16.0 - 3.0 * a2 * a2 / 256.0

    # Resolvent cubic m^3 + p m^2 + (p^2/4 - r) m - q^2/8 = 0 (Cardano).
    A, B, C = p, p * p / 4.0 - r, -q * q / 8.0
    P = B - A * A / 3.0
    Q = 2.0 * A * A * A / 27.0 - A * B / 3.0 + C
    disc = torch.sqrt(Q * Q / 4.0 + P * P * P / 27.0)
    # The larger-magnitude branch for S avoids cancellation.
    s1 = -Q / 2.0 + disc
    s2 = -Q / 2.0 - disc
    Sc = torch.where(torch.abs(s1) >= torch.abs(s2), s1, s2)
    S = Sc ** (1.0 / 3.0)
    small_S = torch.abs(S) < 1e-12
    S_safe = torch.where(small_S, 1e-12, S)
    T = torch.where(small_S, 0.0, -P / (3.0 * S_safe))
    m = S + T - A / 3.0

    s = torch.sqrt(2.0 * m)
    biquad = torch.abs(s) < 1e-6
    s_safe = torch.where(biquad, 1.0, s)
    qo2s = torch.where(biquad, 0.0, q / (2.0 * s_safe))

    # Factored quadratics: y^2 -+ s y + (p/2 + m +- q/(2s)).
    c1q = p / 2.0 + m + qo2s
    c2q = p / 2.0 + m - qo2s
    d1 = torch.sqrt(s * s - 4.0 * c1q)
    d2 = torch.sqrt(s * s - 4.0 * c2q)
    y = torch.stack([(s + d1) / 2.0, (s - d1) / 2.0,
                     (-s + d2) / 2.0, (-s - d2) / 2.0], dim=-1)

    # Biquadratic fallback (q ~ 0): y^2 = (-p +- sqrt(p^2 - 4 r)) / 2.
    db = torch.sqrt(p * p - 4.0 * r)
    yb1 = torch.sqrt((-p + db) / 2.0)
    yb2 = torch.sqrt((-p - db) / 2.0)
    yb = torch.stack([yb1, -yb1, yb2, -yb2], dim=-1)
    y = torch.where(biquad[..., None], yb, y)
    return y - (a / 4.0)[..., None]


def _newton_polish_real(coeffs, v, iters=3):
    """Polish real roots v (..., R) with Newton steps on the quartic
    coeffs (..., 5), lowest first."""
    c0, c1, c2, c3, c4 = (coeffs[..., i, None] for i in range(5))
    for _ in range(iters):
        f = (((c4 * v + c3) * v + c2) * v + c1) * v + c0
        fp = ((4.0 * c4 * v + 3.0 * c3) * v + 2.0 * c2) * v + c1
        fp = torch.where(torch.abs(fp) < 1e-12, 1e-12, fp)
        v = v - f / fp
    return v


def _triad(p):
    """Orthonormal frame (columns) of three points p (..., 3, 3)."""
    e1 = p[..., 1, :] - p[..., 0, :]
    e2 = p[..., 2, :] - p[..., 0, :]
    u1 = e1 / torch.clamp(torch.linalg.norm(e1, dim=-1, keepdim=True), min=1e-12)
    e2p = e2 - torch.sum(e2 * u1, dim=-1, keepdim=True) * u1
    u2 = e2p / torch.clamp(torch.linalg.norm(e2p, dim=-1, keepdim=True), min=1e-12)
    u3 = torch.linalg.cross(u1, u2, dim=-1)
    return torch.stack([u1, u2, u3], dim=-1)


def p3p_solutions(world3, image_pix3, K):
    """All P3P pose candidates for 3-point correspondence sets.

    Args:
        world3: (..., 3, 3) world points.
        image_pix3: (..., 3, 2) pixel observations.
        K: (3, 3) intrinsics.
    Returns:
        Rs (..., 4, 3, 3), ts (..., 4, 3), valid (..., 4). Invalid slots
        hold the identity pose.
    """
    x = (image_pix3[..., 0] - K[0, 2]) / K[0, 0]
    y = (image_pix3[..., 1] - K[1, 2]) / K[1, 1]
    f = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    f = f / torch.linalg.norm(f, dim=-1, keepdim=True)  # (..., 3, 3)

    P1, P2, P3 = world3[..., 0, :], world3[..., 1, :], world3[..., 2, :]
    a2 = torch.sum((P2 - P3) ** 2, dim=-1)
    b2 = torch.sum((P1 - P3) ** 2, dim=-1)
    c2 = torch.sum((P1 - P2) ** 2, dim=-1)
    cos_a = torch.sum(f[..., 1, :] * f[..., 2, :], dim=-1)
    cos_b = torch.sum(f[..., 0, :] * f[..., 2, :], dim=-1)
    cos_c = torch.sum(f[..., 0, :] * f[..., 1, :], dim=-1)

    b2_safe = torch.where(b2 < 1e-12, 1e-12, b2)
    coeffs = _quartic_coeffs(a2, b2_safe, c2, cos_a, cos_b, cos_c)  # (..., 5)

    roots = _quartic_roots_ferrari(coeffs)
    v = roots.real
    real_ok = torch.abs(roots.imag) < 1e-3
    v = _newton_polish_real(coeffs, v)

    # Residual check after the polish.
    c0, c1, c2q, c3, c4 = (coeffs[..., i, None] for i in range(5))
    fval = (((c4 * v + c3) * v + c2q) * v + c1) * v + c0
    scale = torch.clamp(torch.amax(torch.abs(coeffs), dim=-1), min=1e-12)
    root_ok = torch.abs(fval) / scale[..., None] < 1e-3

    # u from the linear elimination.
    cos_a_, cos_b_, cos_c_ = cos_a[..., None], cos_b[..., None], cos_c[..., None]
    g = v * v - 2.0 * v * cos_b_ + 1.0
    m = (c2 / b2_safe)[..., None] * g
    n = (a2 / b2_safe)[..., None] * g
    denom = 2.0 * (v * cos_a_ - cos_c_)
    denom = torch.where(torch.abs(denom) < 1e-9, 1e-9, denom)
    u = (v * v + m - n - 1.0) / denom

    s1 = torch.sqrt(b2_safe[..., None] / torch.clamp(g, min=1e-12))
    s2 = u * s1
    s3 = v * s1
    pos = (s1 > 0) & (s2 > 0) & (s3 > 0) & (v > 0)
    valid = real_ok & root_ok & pos  # (..., 4)

    # Camera-frame points (..., 4 candidates, 3 points, 3).
    pc = torch.stack(
        [s1[..., None] * f[..., None, 0, :],
         s2[..., None] * f[..., None, 1, :],
         s3[..., None] * f[..., None, 2, :]],
        dim=-2,
    )

    # P3P camera points have exactly the world points' pairwise distances,
    # so R = camera_frame @ world_frame^T (no SVD alignment needed).
    Fw = _triad(world3)  # (..., 3, 3)
    Fc = _triad(pc)  # (..., 4, 3, 3)
    Rs = Fc @ Fw.transpose(-1, -2)[..., None, :, :]
    cw = world3.mean(dim=-2)  # (..., 3)
    cc = pc.mean(dim=-2)  # (..., 4, 3)
    ts = cc - (Rs @ cw[..., None, :, None]).squeeze(-1)
    eye = torch.eye(3, dtype=Rs.dtype, device=Rs.device).expand(Rs.shape)
    Rs = torch.where(valid[..., None, None], Rs, eye)
    ts = torch.where(valid[..., None], ts, torch.zeros_like(ts))
    return Rs, ts, valid
