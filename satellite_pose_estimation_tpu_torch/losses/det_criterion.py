"""Detection (box) criterion of the COCO task (counterpart of
losses/det_criterion.py): Hungarian matching on the focal class cost plus
L1 and GIoU box costs, the varifocal classification loss, and L1 + GIoU box
losses, as the upstream RT-DETR that the reference's det configs name
(losses ['vfl', 'boxes'], matcher cost_class 2 + cost_bbox 5 +
cost_giou 2).

Targets are padded to a fixed count: boxes (B, T, 4) normalised cxcywh,
labels (B, T) with -1 for padding. Padded targets cost 0 in the match and
are masked out of every loss. Any cost constant over the queries leaves the
real targets' optimal assignment as it is; JAX pads with 1e6, but in a
float32 Hungarian the potentials near 1e6 move in steps of 0.0625, enough
to miss the real targets' optimum. The levels that are matched (the last
layer, the earlier layers and the encoder's top-k) share one shape, so
their cost matrices go through ``ops.hungarian`` as one (levels * B, Q, T)
batch; each image's search is independent, so the assignments are those of
one call per level. The CDN levels take the fixed assignment of each positive dn query
to its source target.

While spans record (``utils/profiling.py``) the match is the span
``loss.match``, and each call of ``match_levels`` reads the counter
``match.fill``: T_max (T_max + 1) / (T (T + 1)), the share of the
Hungarian's fixed loop iterations (T (T + 1) for T padded targets) that
the call's largest real target count T_max needs, kept on the device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from ..ops.box_ops import box_cxcywh_to_xyxy, generalized_box_iou
from ..ops.hungarian import hungarian
from ..parallel.mesh import all_mean
from ..utils.profiling import record_value, span


@dataclasses.dataclass(frozen=True)
class DetCriterionConfig:
    num_classes: int = 80
    cost_class: float = 2.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0
    weight_vfl: float = 1.0
    weight_bbox: float = 5.0
    weight_giou: float = 2.0
    focal_alpha: float = 0.75  # the varifocal loss's weight (criterion alpha)
    focal_gamma: float = 2.0
    # The matching cost takes upstream RT-DETR's focal-cost alpha / gamma
    # (its matcher's alpha 0.25), distinct from the varifocal alpha above.
    matcher_alpha: float = 0.25
    matcher_gamma: float = 2.0
    aux_loss: bool = True


def _cost(logits, boxes, tgt_labels, tgt_boxes, tgt_mask, cfg: DetCriterionConfig):
    """The (B, Q, T) float32 matching cost; padded targets cost 0."""
    B, Q, _ = logits.shape
    T = tgt_labels.shape[1]
    prob = torch.sigmoid(logits)
    safe = tgt_labels.clamp(min=0).to(torch.int64)
    taken = prob.gather(-1, safe[:, None, :].expand(B, Q, T))
    neg = (1 - cfg.matcher_alpha) * taken ** cfg.matcher_gamma * (
        -torch.log((1 - taken).clamp(min=1e-8)))
    pos = cfg.matcher_alpha * (1 - taken) ** cfg.matcher_gamma * (
        -torch.log(taken.clamp(min=1e-8)))
    c_bbox = (boxes[:, :, None, :] - tgt_boxes[:, None, :, :]).abs().sum(-1)
    giou = generalized_box_iou(box_cxcywh_to_xyxy(boxes), box_cxcywh_to_xyxy(tgt_boxes))
    C = cfg.cost_class * (pos - neg) + cfg.cost_bbox * c_bbox + cfg.cost_giou * (1.0 - giou)
    C = torch.where(tgt_mask[:, None, :], C, torch.zeros_like(C))
    return C.to(torch.float32)


def _fill(mask):
    """T_max (T_max + 1) / (T (T + 1)) of the (B, T) real-target ``mask``,
    a float32 tensor on its device."""
    T = mask.shape[1]
    t_max = mask.sum(1).amax().to(torch.float32)
    return t_max * (t_max + 1) / (T * (T + 1))


@torch.no_grad()
def match_levels(levels, targets, cfg: DetCriterionConfig):
    """The (B, T) query of each target for every level of ``levels`` (dicts
    with ``pred_logits`` and ``pred_points`` of one shape), from one batched
    Hungarian over the stacked costs."""
    labels, boxes = targets["labels"], targets["boxes"]
    mask = labels >= 0
    record_value("match.fill", lambda: _fill(mask))
    costs = torch.cat([_cost(lv["pred_logits"], lv["pred_points"], labels, boxes, mask, cfg)
                       for lv in levels])
    return list(hungarian(costs).split(labels.shape[0]))


def _one_level(outputs, targets, cfg: DetCriterionConfig, num_boxes, q4t):
    """Varifocal, L1 and GIoU losses of one level under the assignment
    ``q4t`` (B, T): target t is matched to query q4t[b, t]."""
    logits = outputs["pred_logits"]  # (B, Q, C): sigmoid classes, no background
    boxes = outputs["pred_points"]  # (B, Q, 4) cxcywh
    tgt_labels, tgt_boxes = targets["labels"], targets["boxes"]
    tgt_mask = tgt_labels >= 0
    B, Q, C = logits.shape
    q4t = q4t.to(torch.int64)

    matched = boxes.gather(1, q4t[..., None].expand(-1, -1, 4))
    m = tgt_mask.to(torch.float32)
    loss_bbox = ((matched - tgt_boxes).abs().sum(-1) * m).sum() / num_boxes
    giou = generalized_box_iou(box_cxcywh_to_xyxy(matched),
                               box_cxcywh_to_xyxy(tgt_boxes)).diagonal(dim1=-2, dim2=-1)
    loss_giou = ((1.0 - giou) * m).sum() / num_boxes

    # Varifocal loss: the matched queries' IoU-aware class targets. Each
    # target has its own query, so a scatter places the (non-negative) IoUs.
    iou_val = torch.where(tgt_mask, giou, 0.0).clamp(0.0, 1.0)
    iou_q = iou_val.new_zeros(B, Q).scatter(1, q4t, iou_val)
    cls_q = torch.full((B, Q), -1, dtype=torch.int64, device=logits.device).scatter(
        1, q4t, torch.where(tgt_mask, tgt_labels.to(torch.int64), -1))
    onehot = (torch.nn.functional.one_hot(cls_q.clamp(min=0), C).to(iou_q.dtype)
              * (cls_q >= 0)[..., None])
    target_score = onehot * iou_q[..., None]
    prob = torch.sigmoid(logits.to(torch.float32))
    weight = cfg.focal_alpha * prob ** cfg.focal_gamma * (1 - onehot) + target_score
    bce = -(target_score * torch.log(prob.clamp(min=1e-8))
            + (1 - target_score) * torch.log((1 - prob).clamp(min=1e-8)))
    loss_vfl = (bce * weight).sum() / num_boxes
    return {"loss_vfl": loss_vfl, "loss_bbox": loss_bbox, "loss_giou": loss_giou}


def set_criterion_boxes(outputs, targets, cfg: DetCriterionConfig = DetCriterionConfig(),
                        on_match=None, axis_name=None) -> Tuple[torch.Tensor, dict]:
    """(total, losses) of the model's outputs against ``targets``
    {"labels" (B, T), "boxes" (B, T, 4)}: the last layer's loss_vfl /
    loss_bbox / loss_giou, each aux level's loss_vfl_i / loss_bbox_i, each
    CDN level's loss_vfl_dn_i / loss_bbox_dn_i, and loss_total.
    ``on_match()``, if given, is called once the levels are matched.
    ``axis_name``: a data ``parallel.mesh.Mesh`` whose ranks each hold a
    shard of the batch: the box count is then the global batch's (at least
    one) over the number of ranks, so that the group's mean loss is the
    global batch's."""
    count = (targets["labels"] >= 0).sum().to(torch.float32)
    if axis_name is None:
        num_boxes = count.clamp(min=1.0)
    else:
        n = axis_name.axis_size("data")
        num_boxes = (all_mean(count, axis_name) * n).clamp(min=1.0) / n

    def weighted(lv):
        return (cfg.weight_vfl * lv["loss_vfl"] + cfg.weight_bbox * lv["loss_bbox"]
                + cfg.weight_giou * lv["loss_giou"])

    aux = outputs["aux_outputs"] if cfg.aux_loss and "aux_outputs" in outputs else []
    with span("loss.match"):
        q4ts = match_levels([outputs] + list(aux), targets, cfg)
    if on_match is not None:
        on_match()
    losses = _one_level(outputs, targets, cfg, num_boxes, q4ts[0])
    total = weighted(losses)
    for i, (lv, q4t) in enumerate(zip(aux, q4ts[1:])):
        al = _one_level(lv, targets, cfg, num_boxes, q4t)
        total = total + weighted(al)
        losses[f"loss_vfl_{i}"] = al["loss_vfl"]
        losses[f"loss_bbox_{i}"] = al["loss_bbox"]

    # CDN levels: positive dn query g * 2T + t matches target t, and
    # num_boxes scales with the group count (padded targets stay masked by
    # their -1 labels).
    if "dn_aux_outputs" in outputs and "dn_meta" in outputs:
        B, T = targets["labels"].shape
        G = int(outputs["dn_meta"]["dn_num_group"])
        dev = targets["labels"].device
        q4t_dn = (torch.arange(T, device=dev)[None, :]
                  + 2 * T * torch.arange(G, device=dev)[:, None]).reshape(1, G * T).expand(B, -1)
        dn_targets = {"labels": targets["labels"].repeat(1, G),
                      "boxes": targets["boxes"].repeat(1, G, 1)}
        for i, lv in enumerate(outputs["dn_aux_outputs"]):
            dl = _one_level(lv, dn_targets, cfg, num_boxes * G, q4t_dn)
            total = total + weighted(dl)
            losses[f"loss_vfl_dn_{i}"] = dl["loss_vfl"]
            losses[f"loss_bbox_dn_{i}"] = dl["loss_bbox"]

    losses["loss_total"] = total
    return total, losses
