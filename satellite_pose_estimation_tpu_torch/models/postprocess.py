"""Model outputs -> original-image predictions (counterpart of
models/postprocess.py), batched:

* softmax over the class logits (float32);
* points de-normalised into original-image pixels through each image's
  ``clip_bbox``: pt * (x2 - x1, y2 - y1) + (x1, y1);
* with sigmas: exp(pred_sigmas) scaled to pixel^2 by the squared crop
  extent.
"""
from __future__ import annotations

import torch


def postprocess(outputs, clip_bbox):
    """pred_logits (B, Q, C), pred_points (B, Q, 2) and clip_bbox (B, 4) ->
    {"probs" (B, Q, C), "points" (B, Q, 2) in original pixels}."""
    probs = torch.softmax(outputs["pred_logits"].float(), dim=-1)
    wh = clip_bbox[:, 2:4] - clip_bbox[:, 0:2]
    points = outputs["pred_points"].float() * wh[:, None, :] + clip_bbox[:, None, 0:2]
    return {"probs": probs, "points": points}


def postprocess_sigma(outputs, clip_bbox):
    """``postprocess`` plus "sigmas" = exp(pred_sigmas) * (crop extent)^2,
    variances in original pixel^2."""
    out = postprocess(outputs, clip_bbox)
    wh = clip_bbox[:, 2:4] - clip_bbox[:, 0:2]
    out["sigmas"] = torch.exp(outputs["pred_sigmas"].float()) * wh[:, None, :] ** 2
    return out


def collect_aux_points(outputs, clip_bbox=None):
    """``[(layer index, float32 raw logits), ...]`` of the aux layers that
    carry pred_logits. The reference's eval log stores the aux layers' RAW
    logits under keys named aux_points_<i>; the JAX package and the port
    keep that contract. ``clip_bbox`` is unused, as there."""
    del clip_bbox
    return [(i, aux["pred_logits"].float())
            for i, aux in enumerate(outputs.get("aux_outputs", []))
            if "pred_logits" in aux]
