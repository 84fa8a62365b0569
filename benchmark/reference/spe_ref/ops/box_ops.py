"""Box arithmetic of the detection cell's reference, written for aligned
pairs and for one image's (Q, n) cost: cxcywh -> xyxy, and the IoU and
generalized IoU of Rezatofighi et al. (CVPR 2019). The divisions keep the
program's floors (a union or an enclosing area of at least 1e-9), which
only a degenerate box ever reaches."""
from __future__ import annotations

import torch

FLOOR = 1e-9


def cxcywh_to_xyxy(b):
    half = b[..., 2:] / 2
    return torch.cat([b[..., :2] - half, b[..., :2] + half], dim=-1)


def _area(b):
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def giou(a, b):
    """The generalized IoU of boxes ``a`` and ``b`` (xyxy), broadcast
    against each other element by element."""
    inter_wh = (torch.minimum(a[..., 2:], b[..., 2:])
                - torch.maximum(a[..., :2], b[..., :2])).clamp(min=0.0)
    inter = inter_wh[..., 0] * inter_wh[..., 1]
    union = _area(a) + _area(b) - inter
    hull_wh = (torch.maximum(a[..., 2:], b[..., 2:])
               - torch.minimum(a[..., :2], b[..., :2])).clamp(min=0.0)
    hull = hull_wh[..., 0] * hull_wh[..., 1]
    return inter / union.clamp(min=FLOOR) - (hull - union) / hull.clamp(min=FLOOR)


def pairwise_giou(a, b):
    """(N, M) generalized IoU of every box of ``a`` (N, 4) with every box of
    ``b`` (M, 4), xyxy."""
    return giou(a[:, None, :], b[None, :, :])
