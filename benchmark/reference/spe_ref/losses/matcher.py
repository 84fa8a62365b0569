"""Hungarian matching of query predictions to keypoint targets, on the
tensors' device (counterpart of losses/matcher.py).

    C[q, t] = cost_pts * L1(points_q, landmarks_t) + cost_class * (-prob_q[label_t])

solved exactly per image by ``ops.hungarian.hungarian``, batched.
"""
from __future__ import annotations

import torch

from ..ops.hungarian import hungarian
from ..ops.precision import to_loss_dtype


@torch.no_grad()
def hungarian_match(pred_logits, pred_points, tgt_labels, tgt_points,
                    cost_class=1.0, cost_pts=5.0, use_focal=False):
    """Batched optimal matching, not differentiated through.

    Args:
        pred_logits: (B, Q, C) raw logits.
        pred_points: (B, Q, 2) normalised points.
        tgt_labels: (B, T) integer class ids.
        tgt_points: (B, T, 2) normalised target landmarks.
        use_focal: sigmoid instead of softmax probabilities (the R2 matcher's
            ``use_focal_loss``; the cost stays -prob[target]).
    Returns:
        (B, T) int64: the matched query of each target.
    """
    logits = to_loss_dtype(pred_logits)
    prob = torch.sigmoid(logits) if use_focal else torch.softmax(logits, dim=-1)
    Q = prob.shape[1]
    cclass = -prob.gather(2, tgt_labels[:, None, :].expand(-1, Q, -1).to(torch.int64))
    cpts = (to_loss_dtype(pred_points)[:, :, None, :]
            - to_loss_dtype(tgt_points)[:, None, :, :]).abs().sum(dim=-1)  # (B, Q, T)
    return hungarian(cost_pts * cpts + cost_class * cclass)
