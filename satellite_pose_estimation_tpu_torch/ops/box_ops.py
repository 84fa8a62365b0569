"""Box utilities of the detection task (counterpart of ops/box_ops.py):
cxcywh <-> xyxy conversion, area, IoU and generalized IoU on tensors."""
from __future__ import annotations

import torch


def box_cxcywh_to_xyxy(b):
    cx, cy, w, h = b.unbind(-1)
    return torch.stack([cx - 0.5 * w, cy - 0.5 * h, cx + 0.5 * w, cy + 0.5 * h], dim=-1)


def box_xyxy_to_cxcywh(b):
    x1, y1, x2, y2 = b.unbind(-1)
    return torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1, y2 - y1], dim=-1)


def box_area(b):
    return (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])


def box_iou(a, b):
    """a (..., N, 4), b (..., M, 4) xyxy -> (iou (..., N, M), union)."""
    area_a = box_area(a)[..., :, None]
    area_b = box_area(b)[..., None, :]
    lt = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    union = area_a + area_b - inter
    return inter / union.clamp(min=1e-9), union


def generalized_box_iou(a, b):
    iou, union = box_iou(a, b)
    lt = torch.minimum(a[..., :, None, :2], b[..., None, :, :2])
    rb = torch.maximum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (rb - lt).clamp(min=0.0)
    enclosing = wh[..., 0] * wh[..., 1]
    return iou - (enclosing - union) / enclosing.clamp(min=1e-9)
