"""Multi-scale deformable attention sampling (counterpart of
ops/deform_attn.py).

The JAX package writes the reference's ``F.grid_sample`` core as a gather
(``deformable_attention_core``) or as separable one-hot matmuls
(``deformable_attention_core_matmul``), because XLA has no grid_sample;
both compute bilinear sampling with zeros padding and
``align_corners=False``. Here it is that call, one per level: location
``loc`` in [0, 1] samples pixel ``loc * size - 0.5``, and taps outside the
map contribute zero. The sampling runs in float32 (the JAX cores keep the
locations in float32 and accumulate in float32) and the result takes the
values' dtype.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F


def deformable_attention_core(value: torch.Tensor, spatial_shapes: Sequence[Tuple[int, int]],
                              sampling_locations: torch.Tensor,
                              attention_weights: torch.Tensor) -> torch.Tensor:
    """
    Args:
        value: (B, L_total, H, C) flattened multi-level values, levels in
            ``spatial_shapes`` order, each h-major.
        spatial_shapes: (h, w) per level.
        sampling_locations: (B, Q, H, n_levels, n_points, 2) (x, y) in [0, 1].
        attention_weights: (B, Q, H, n_levels, n_points), softmaxed.
    Returns:
        (B, Q, H * C) in value's dtype.
    """
    B, _, H, C = value.shape
    _, Q, _, n_levels, n_points, _ = sampling_locations.shape
    grids = (2.0 * sampling_locations.float() - 1.0).transpose(1, 2)  # (B, H, Q, Lv, P, 2)
    sampled = []
    start = 0
    for lvl, (h, w) in enumerate(spatial_shapes):
        v = value[:, start:start + h * w].float()  # (B, hw, H, C)
        start += h * w
        v = v.permute(0, 2, 3, 1).reshape(B * H, C, h, w)
        g = grids[:, :, :, lvl].reshape(B * H, Q, n_points, 2)
        sampled.append(F.grid_sample(v, g, mode="bilinear", padding_mode="zeros",
                                     align_corners=False))  # (B*H, C, Q, P)
    stacked = torch.stack(sampled, dim=3).reshape(B, H, C, Q, n_levels * n_points)
    attw = attention_weights.float().permute(0, 2, 1, 3, 4).reshape(B, H, 1, Q, -1)
    out = (stacked * attw).sum(-1)  # (B, H, C, Q)
    return out.permute(0, 3, 1, 2).reshape(B, Q, H * C).to(value.dtype)
