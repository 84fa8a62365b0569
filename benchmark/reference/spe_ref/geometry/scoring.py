"""SPEED pose score, batched (counterpart of geometry/scoring.py).

    s_t = ||t_pr - t_gt|| / ||t_gt||
    s_q = 2 * arccos(min(|q_pr . q_gt|, 1))   after canonicalising q[0] >= 0
    total = s_t + s_q
"""
from __future__ import annotations

import torch


def speed_score(q_pr, t_pr, q_gt, t_gt):
    """SPEED score over the leading dims. Returns (s_t, s_q)."""
    q_pr = torch.where(q_pr[..., :1] < 0, -q_pr, q_pr)
    q_gt = torch.where(q_gt[..., :1] < 0, -q_gt, q_gt)
    s_t = (torch.linalg.norm(t_pr - t_gt, dim=-1)
           / torch.linalg.norm(t_gt, dim=-1))
    dot = torch.abs(torch.sum(q_pr * q_gt, dim=-1))
    s_q = 2.0 * torch.arccos(torch.clamp(dot, max=1.0))
    return s_t, s_q


def speed_score_batch(q_pr, t_pr, q_gt, t_gt):
    """Batched scores; shapes (B,4)/(B,3). Returns dict of (B,) tensors."""
    s_t, s_q = speed_score(q_pr, t_pr, q_gt, t_gt)
    return {"score_tvec": s_t, "score_quat": s_q, "score": s_t + s_q}
