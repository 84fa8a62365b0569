"""Set-prediction criterion (counterpart of losses/criterion.py): weighted
cross entropy with ``eos_coef`` on the background class, a smooth-L1
(beta = 1/200), L1 or Laplace-KL point loss over matched pairs divided by
the number of points, the cardinality and class-error metrics, and the same
terms for every auxiliary decoder layer, and RT-DETR's denoising (CDN)
branch.

The Hungarian matchings of all decoder layers are solved in one batched
call; the CDN levels need none (their positives are matched to their
targets by construction). ``nf_point_loss`` is the normalizing-flow point
loss over a ``models.real_nvp.RealNVP``.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from ..ops.precision import to_loss_dtype
from ..parallel.mesh import all_mean
from ..utils.profiling import span
from .matcher import hungarian_match


@dataclasses.dataclass(frozen=True)
class CriterionConfig:
    num_classes: int = 11
    eos_coef: float = 0.1
    cost_class: float = 1.0
    cost_pts: float = 5.0
    point_loss: str = "smooth_l1"  # smooth_l1 | l1 | uncert
    smooth_l1_beta: float = 1.0 / 200.0
    weight_ce: float = 1.0
    weight_points: float = 5.0
    use_focal: bool = False
    aux_loss: bool = True


def _smooth_l1(diff, beta):
    """mmdetection-style smooth L1."""
    ad = diff.abs()
    return torch.where(ad < beta, 0.5 * ad * ad / beta, ad - 0.5 * beta)


def _point_term(pred_pts, tgt_pts, sigmas, kind, beta):
    diff = pred_pts - tgt_pts
    if kind == "smooth_l1":
        return _smooth_l1(diff, beta)
    if kind == "l1":
        return diff.abs()
    if kind == "uncert":  # Laplace KL
        return diff.abs() * torch.exp(-sigmas) + 0.5 * sigmas
    raise ValueError(kind)


def _one_level(outputs, targets, cfg: CriterionConfig, num_points, log: bool, q4t):
    """Losses of one decoder layer for the (B, T) matching ``q4t``."""
    logits = outputs["pred_logits"]  # (B, Q, C+1)
    points = outputs["pred_points"]  # (B, Q, 2)
    sigmas = outputs.get("pred_sigmas")
    labels = targets["labels"].to(torch.int64)  # (B, T)
    landmarks = targets["landmarks"]  # (B, T, 2)
    B, Q, C1 = logits.shape
    T = labels.shape[1]

    tgt_classes = torch.full((B, Q), cfg.num_classes, dtype=torch.int64, device=logits.device)
    tgt_classes = tgt_classes.scatter(1, q4t, labels)
    logp = torch.log_softmax(to_loss_dtype(logits), dim=-1)
    nll = -logp.gather(2, tgt_classes[..., None])[..., 0]
    class_w = torch.ones(cfg.num_classes + 1, dtype=logp.dtype, device=logp.device)
    class_w[-1] = cfg.eos_coef
    w = class_w[tgt_classes]
    loss_ce = (nll * w).sum() / torch.clamp_min(w.sum(), 1e-9)

    idx2 = q4t[..., None].expand(-1, -1, 2)
    matched_pts = points.gather(1, idx2)
    matched_sig = sigmas.gather(1, idx2) if sigmas is not None else torch.zeros_like(matched_pts)
    pt_loss = _point_term(to_loss_dtype(matched_pts), to_loss_dtype(landmarks),
                          to_loss_dtype(matched_sig), cfg.point_loss, cfg.smooth_l1_beta)
    out = {"loss_ce": loss_ce, "loss_points": pt_loss.sum() / num_points}
    if log:
        with torch.no_grad():
            card_pred = (logits.argmax(-1) != C1 - 1).sum(-1).to(torch.float32)
            out["cardinality_error"] = (card_pred - T).abs().mean()
            matched_logits = logits.gather(1, q4t[..., None].expand(-1, -1, C1))
            acc = (matched_logits.argmax(-1) == labels).to(torch.float32).mean()
            out["class_error"] = 100.0 * (1.0 - acc)
    return out


def set_criterion(outputs, targets, cfg: CriterionConfig = CriterionConfig(), axis_name=None):
    """The weighted total loss and the loss dict.

    Args:
        outputs: model dict with pred_logits / pred_points [/ pred_sigmas]
            and optionally aux_outputs.
        targets: dict with labels (B, T) and landmarks (B, T, 2) normalised.
    Returns:
        (total, losses): losses holds loss_ce, loss_points,
        cardinality_error, class_error, loss_ce_<i> / loss_points_<i> per
        auxiliary layer, loss_ce_dn_<i> / loss_points_dn_<i> per CDN level,
        and loss_total.

    With ``dn_aux_outputs`` and ``dn_meta`` (an RT-DETR trained with
    ``num_denoising > 0``), each decoder layer's dn queries add a level:
    group g's positives (queries g * 2T + [0, T)) are matched to the T
    targets, tiled G times, over G times the number of points.

    ``axis_name``: a data ``parallel.mesh.Mesh``; the number of points is
    then averaged over its ranks.
    """
    B, T = targets["labels"].shape
    num_points = max(float(B * T), 1.0)
    if axis_name is not None:
        # the replicas' mean (JAX's pmean), so that the group's mean loss is
        # the global batch's
        num_points = all_mean(torch.tensor(num_points, device=targets["labels"].device),
                              axis_name)

    levels = [outputs]
    if cfg.aux_loss and "aux_outputs" in outputs:
        levels += list(outputs["aux_outputs"])
    L = len(levels)
    with span("loss.match"):
        q4t = hungarian_match(
            torch.cat([lv["pred_logits"] for lv in levels]),
            torch.cat([lv["pred_points"] for lv in levels]),
            targets["labels"].repeat(L, 1), targets["landmarks"].repeat(L, 1, 1),
            cost_class=cfg.cost_class, cost_pts=cfg.cost_pts, use_focal=cfg.use_focal,
        ).reshape(L, B, T)

    losses = _one_level(outputs, targets, cfg, num_points, log=True, q4t=q4t[0])
    total = cfg.weight_ce * losses["loss_ce"] + cfg.weight_points * losses["loss_points"]
    for i, aux in enumerate(levels[1:]):
        aux_losses = _one_level(aux, targets, cfg, num_points, log=False, q4t=q4t[i + 1])
        total = total + (cfg.weight_ce * aux_losses["loss_ce"]
                         + cfg.weight_points * aux_losses["loss_points"])
        losses[f"loss_ce_{i}"] = aux_losses["loss_ce"]
        losses[f"loss_points_{i}"] = aux_losses["loss_points"]

    if "dn_aux_outputs" in outputs and "dn_meta" in outputs:
        G = int(outputs["dn_meta"]["dn_num_group"])
        device = targets["labels"].device
        q4t_dn = (torch.arange(T, device=device)[None, :]
                  + 2 * T * torch.arange(G, device=device)[:, None]).reshape(1, G * T).repeat(B, 1)
        dn_targets = {"labels": targets["labels"].repeat(1, G),
                      "landmarks": targets["landmarks"].repeat(1, G, 1)}
        for i, aux in enumerate(outputs["dn_aux_outputs"]):
            dn_losses = _one_level(aux, dn_targets, cfg, num_points * G, log=False, q4t=q4t_dn)
            total = total + (cfg.weight_ce * dn_losses["loss_ce"]
                             + cfg.weight_points * dn_losses["loss_points"])
            losses[f"loss_ce_dn_{i}"] = dn_losses["loss_ce"]
            losses[f"loss_points_dn_{i}"] = dn_losses["loss_points"]
    losses["loss_total"] = total
    return total, losses


def nf_point_loss(flow, pred_pts, tgt_pts, pred_sigmas):
    """The normalizing-flow residual-density point loss, per element:

        sigma = sigmoid(pred_sigmas); bar_mu = (pred - gt) / sigma
        loss  = log(sigma) - flow.log_prob(bar_mu)
                + log(sigma / amp) + |gt - pred| / (sqrt(2) sigma + 1e-9)

    with amp = 1 / sqrt(2 pi); ``flow`` a ``models.real_nvp.RealNVP``.
    Callers reduce and normalise it as the other point losses."""
    amp = 1.0 / math.sqrt(2.0 * math.pi)
    sigma = torch.sigmoid(pred_sigmas)
    bar_mu = (pred_pts - tgt_pts) / sigma
    nf = torch.log(sigma) - flow.log_prob(bar_mu)[..., None]
    log_q = torch.log(sigma / amp) + (tgt_pts - pred_pts).abs() / (math.sqrt(2.0) * sigma + 1e-9)
    return nf + log_q
