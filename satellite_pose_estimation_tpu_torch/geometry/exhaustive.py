"""Exhaustive minimal-set EPnP (counterpart of geometry/exhaustive.py; the
reference's "exhausive_pnp", R2/utils/speed_eval_ceres.py:326-399): every
C(n, 4) four-point EPnP sample, ranked by the masked total reprojection
error over all points, the best refined by the pixel LM.

All C(11, 4) = 330 samples of every image solve as one batch through
``epnp``, each as the masked EPnP of the whole point set with only its four
points kept (the same system as EPnP on the four points alone); the image
batch is an explicit leading dimension, shapes are fixed and nothing
syncs with the host.
"""
from __future__ import annotations

from itertools import combinations

import numpy as np
import torch

from ..ops.precision import highest_precision
from ..utils.constants import device_constant
from .camera import Camera
from .epnp import epnp
from .projection import project_points
from .refine import gauss_newton_pnp
from .rotations import inverse_rodrigues, rodrigues, rotmat_to_quat


def _all_quads(n: int) -> np.ndarray:
    return np.asarray(list(combinations(range(n), 4)), dtype=np.int64)


@highest_precision()
def exhaustive_pnp(world, image_pix, mask, max_points=11, refine_iters=15):
    """The pose from the best minimal EPnP candidate, for a batch.

    Args: world (N, 3), image_pix (B, N, 2) pixels, mask (B, N) validity.
    Returns (quat (B, 4), tvec (B, 3), valid (B,)); an image without a
    sample of four valid points in front of the camera, or with fewer than
    4 valid points, gets the zero pose and ``valid = False``.
    """
    B, N = image_pix.shape[:2]
    mask = mask.bool()
    K = Camera.K_torch(world.dtype, world.device)
    quads = device_constant(f"exhaustive.quads.{max_points}", lambda: _all_quads(max_points),
                            world.device)  # (S, 4)
    S = quads.shape[0]
    sample_ok = torch.all(mask[:, quads], dim=-1)  # (B, S)
    keep = torch.zeros(S, N, dtype=torch.bool, device=world.device).scatter_(1, quads, True)

    Rs, ts = epnp(world, image_pix[:, None].expand(B, S, N, 2).reshape(B * S, N, 2), K,
                  keep.expand(B, S, N).reshape(B * S, N))
    Rs, ts = Rs.reshape(B, S, 3, 3), ts.reshape(B, S, 3)
    proj, depth = project_points(world, K, Rs, ts)  # (B, S, N, 2), (B, S, N)
    err = torch.linalg.norm(proj - image_pix[:, None], dim=-1)
    total = torch.sum(torch.where(mask[:, None, :], err, 0.0), dim=-1)
    total = torch.where(sample_ok & torch.all(depth > 0, dim=-1), total, torch.inf)

    best = torch.argmin(total, dim=-1)
    rows = torch.arange(B, device=world.device)
    rvec, tvec = gauss_newton_pnp(world, image_pix, K, inverse_rodrigues(Rs[rows, best]),
                                  ts[rows, best], mask, iters=refine_iters)
    valid = torch.isfinite(total[rows, best]) & (torch.sum(mask, dim=-1) >= 4)
    quat = torch.where(valid[:, None], rotmat_to_quat(rodrigues(rvec)), 0.0)
    tvec = torch.where(valid[:, None], tvec, 0.0)
    return quat, tvec, valid
