"""The detection cell's criterion, written for one image at a time over
its real targets: the matching cost (focal class cost + L1 + GIoU, as
upstream RT-DETR's HungarianMatcher with cost_class 2, cost_bbox 5,
cost_giou 2), the optimal match of every matched level by
``det_matcher.assign`` (scipy), the CDN levels' fixed assignment, and the
varifocal, L1 and GIoU losses (weights 1, 5, 2), summed over the last
decoder layer, the earlier layers, the encoder's top-k and the CDN levels.

Where the program (and the JAX package it was ported from) departs from
upstream RT-DETR (rtdetr_criterion.py), this follows the program, since it
checks the program's step:

* the varifocal target score of a matched query is its box's GIoU with the
  target clamped to [0, 1], not the IoU, and it is not detached, so the
  class loss sends a gradient into the box head;
* the binary cross entropy is taken on sigmoid probabilities clamped to
  [1e-8, 1 - 1e-8] (the log of the clamp), not on the logits, and its
  weight's prob ** gamma is not detached;
* the matching cost's logs are clamped at 1e-8 as well;
* the aux levels report loss_vfl_<i> and loss_bbox_<i> (their GIoU term
  counts in the total only), as the program's loss dict does.

Padded targets (label -1) are not costed and not matched; each image's
padded targets take queries its real ones left free (``det_matcher``), and
no loss reads them.
"""
from __future__ import annotations

import dataclasses

import torch

from ..ops.box_ops import cxcywh_to_xyxy, giou, pairwise_giou
from . import det_matcher

LOG_FLOOR = 1e-8


@dataclasses.dataclass(frozen=True)
class DetCriterionConfig:
    num_classes: int = 80
    cost_class: float = 2.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    weight_vfl: float = 1.0
    weight_bbox: float = 5.0
    weight_giou: float = 2.0
    focal_alpha: float = 0.75  # the varifocal loss's negative weight
    focal_gamma: float = 2.0
    matcher_alpha: float = 0.25  # the matching cost's focal alpha / gamma
    matcher_gamma: float = 2.0
    aux_loss: bool = True


def _log(x):
    return torch.log(x.clamp(min=LOG_FLOOR))


def image_cost(logits, boxes, labels, tgt_boxes, cfg: DetCriterionConfig):
    """(Q, n) float64 cost of one image's queries (``logits`` (Q, C),
    ``boxes`` (Q, 4) cxcywh) against its n real targets."""
    logits, boxes = logits.detach().double(), boxes.detach().double()
    p = torch.sigmoid(logits)[:, labels.long()]  # (Q, n)
    a, g = cfg.matcher_alpha, cfg.matcher_gamma
    c_class = a * (1 - p) ** g * -_log(p) - (1 - a) * p ** g * -_log(1 - p)
    c_l1 = torch.cdist(boxes, tgt_boxes.double(), p=1)
    c_giou = 1.0 - pairwise_giou(cxcywh_to_xyxy(boxes), cxcywh_to_xyxy(tgt_boxes.double()))
    return cfg.cost_class * c_class + cfg.cost_bbox * c_l1 + cfg.cost_giou * c_giou


@torch.no_grad()
def match_levels(levels, targets, cfg: DetCriterionConfig):
    """The (B, T) query of each target of every level of ``levels``."""
    mask = targets["labels"] >= 0
    costs = [[image_cost(lv["pred_logits"][b], lv["pred_points"][b],
                         targets["labels"][b][mask[b]], targets["boxes"][b][mask[b]], cfg)
              for b in range(mask.shape[0])] for lv in levels]
    return list(det_matcher.assign(costs, mask))


def level_losses(outputs, targets, cfg: DetCriterionConfig, num_boxes, q4t):
    """loss_vfl, loss_bbox and loss_giou of one level when target t of
    image b is matched to query q4t[b, t]."""
    logits, boxes = outputs["pred_logits"].float(), outputs["pred_points"].float()
    C = logits.shape[-1]
    vfl = l1 = gl = logits.new_zeros(())
    for b in range(logits.shape[0]):
        real = targets["labels"][b] >= 0
        q = q4t[b][real].long()
        cls = targets["labels"][b][real].long()
        tgt = targets["boxes"][b][real].float()
        pred = boxes[b, q]
        l1 = l1 + (pred - tgt).abs().sum()
        g = giou(cxcywh_to_xyxy(pred), cxcywh_to_xyxy(tgt))
        gl = gl + (1.0 - g).sum()
        onehot = logits.new_zeros(logits.shape[1], C).index_put((q, cls), torch.ones_like(g))
        score = logits.new_zeros(logits.shape[1], C).index_put((q, cls), g.clamp(0.0, 1.0))
        prob = torch.sigmoid(logits[b])
        weight = cfg.focal_alpha * prob ** cfg.focal_gamma * (1 - onehot) + score
        bce = -(score * _log(prob) + (1 - score) * _log(1 - prob))
        vfl = vfl + (bce * weight).sum()
    return {"loss_vfl": vfl / num_boxes, "loss_bbox": l1 / num_boxes,
            "loss_giou": gl / num_boxes}


def set_criterion_boxes(outputs, targets, cfg: DetCriterionConfig = DetCriterionConfig(),
                        on_match=None):
    """(total, losses) as the program's ``set_criterion_boxes`` names them:
    loss_vfl / loss_bbox / loss_giou of the last layer, loss_vfl_<i> /
    loss_bbox_<i> of each aux level, loss_vfl_dn_<i> / loss_bbox_dn_<i> of
    each CDN level, loss_total."""
    labels = targets["labels"]
    B, T = labels.shape
    num_boxes = (labels >= 0).sum().float().clamp(min=1.0)

    def weighted(lv):
        return (cfg.weight_vfl * lv["loss_vfl"] + cfg.weight_bbox * lv["loss_bbox"]
                + cfg.weight_giou * lv["loss_giou"])

    aux = list(outputs["aux_outputs"]) if cfg.aux_loss and "aux_outputs" in outputs else []
    q4ts = match_levels([outputs] + aux, targets, cfg)
    if on_match is not None:
        on_match()
    losses = level_losses(outputs, targets, cfg, num_boxes, q4ts[0])
    total = weighted(losses)
    for i, (lv, q4t) in enumerate(zip(aux, q4ts[1:])):
        al = level_losses(lv, targets, cfg, num_boxes, q4t)
        total = total + weighted(al)
        losses[f"loss_vfl_{i}"], losses[f"loss_bbox_{i}"] = al["loss_vfl"], al["loss_bbox"]

    if "dn_aux_outputs" in outputs and "dn_meta" in outputs:
        # CDN: group g holds T positives then T negatives; positive g * 2T + t
        # is target t's noised copy, so it is matched to target t.
        G = int(outputs["dn_meta"]["dn_num_group"])
        t = torch.arange(T, device=labels.device)
        q4t = torch.cat([t + 2 * T * g for g in range(G)])[None].expand(B, -1)
        dn_targets = {"labels": labels.repeat(1, G), "boxes": targets["boxes"].repeat(1, G, 1)}
        for i, lv in enumerate(outputs["dn_aux_outputs"]):
            dl = level_losses(lv, dn_targets, cfg, num_boxes * G, q4t)
            total = total + weighted(dl)
            losses[f"loss_vfl_dn_{i}"], losses[f"loss_bbox_dn_{i}"] = (dl["loss_vfl"],
                                                                       dl["loss_bbox"])
    losses["loss_total"] = total
    return total, losses
