"""Train and eval steps (counterpart of train/steps.py).

Train: augment -> model (training mode) -> set criterion -> backward ->
global-norm clip -> optimizer step and schedule -> EMA (parameters and
buffers, the BatchNorm running statistics the forward updated included). Eval: warp -> model ->
softmax / pixel de-normalisation -> batched PnP -> SPEED scores (and, with a
criterion, the eval losses). Everything runs on the tensors' device with no
host round trip.
"""
from __future__ import annotations

import contextlib
import weakref
from typing import Optional

import torch

from ..data.augment import AugmentConfig, augment_batch, augment_batch_pallas
from ..geometry.camera import world_points
from ..geometry.scoring import speed_score_batch
from ..geometry.solvers import (
    SolverConfig,
    solve_pose_self_assessed,
    solve_pose_sigma,
    solve_pose_simple,
)
from ..losses.criterion import CriterionConfig, set_criterion
from ..models.layers import site_scales, static_scales
from ..models.postprocess import collect_aux_points
from ..ops.image_warp import crop_resize_cubic_mxu
from ..parallel.mesh import data_parallel, ddp_module, group_mean_losses
from ..utils.graphs import graphed
from ..utils.profiling import Stages, span
from .ema import ema_update
from .state import TrainConfig, TrainState, clip_by_global_norm_

TRAIN_STAGES = ("augment", "forward", "loss", "backward", "optimizer")


def make_train_step(criterion_cfg: CriterionConfig, train_cfg: TrainConfig,
                    augment_cfg: AugmentConfig = AugmentConfig(),
                    axis_name: Optional[str] = None,
                    use_pallas_augment: bool = False,
                    denoising: bool = False,
                    compute_dtype: Optional[torch.dtype] = None):
    """Build ``train_step(state, batch, generator, on_stage=None) -> losses``.

    Batch dict (tensors on one device): image (B,P,P,3) uint8 canvases,
    clip_bbox_buf (B,4), landmarks_buf (B,K,2), labels (B,K). ``generator``
    is a ``torch.Generator`` on that device and drives the augmentation.
    ``compute_dtype`` (e.g. ``torch.bfloat16``) runs the model under
    ``torch.autocast`` on float32 parameters; None computes in the
    parameters' dtype. ``use_pallas_augment`` augments with
    ``augment_batch_pallas`` (one affine warp, then the fused photometric
    kernel K4 on the GPU) instead of ``augment_batch``. ``denoising`` hands
    an RT-DETR trained with ``num_denoising > 0`` its targets ({"labels",
    "points": the augmented normalised landmarks}) and ``generator`` for its
    CDN groups. The state is updated in place; the returned losses are
    detached tensors (no host synchronisation).

    ``axis_name``: a data ``parallel.mesh.Mesh``. Each rank then passes its
    rows of the global batch (``parallel.mesh.shard_batch``) and the same
    seeded ``generator``: the augmentation and the CDN groups draw the
    global batch's parameters and apply the rank's rows, BatchNorm takes
    the global batch's statistics, the model runs under
    ``DistributedDataParallel`` (its gradients averaged over the group while
    the backward runs), the criterion averages its number of points, and
    the returned losses are the group's means (JAX's ``pmean``). A dp-N
    step so matches the one-device step on the global batch. Dropout masks
    are drawn per rank.
    """
    augment = augment_batch_pallas if use_pallas_augment else augment_batch
    replicas: dict = {}  # model -> its DistributedDataParallel wrapper

    def train_step(state: TrainState, batch, generator, on_stage=None):
        """``on_stage(name)``, if given, is called as each stage ends
        (augment, forward, loss, backward, optimizer), e.g. to record a CUDA
        event for a per-stage breakdown; the spans ``train.<stage>`` end at
        the same points."""
        with span("train.step"), Stages("train", TRAIN_STAGES, on_stage) as mark:
            return run(state, batch, generator, mark)

    def run(state: TrainState, batch, generator, mark):
        model = state.model
        with data_parallel(axis_name, batch["image"].shape[0]):
            images, kp_norm = augment(generator, batch["image"], batch["clip_bbox_buf"],
                                      batch["landmarks_buf"], augment_cfg)
            targets = {"labels": batch["labels"], "landmarks": kp_norm}
            mark("augment")
            model.train()
            forward = model
            if axis_name is not None:
                # an RT-DETR's sigma heads are read by the Laplace point
                # loss alone
                unread = criterion_cfg.point_loss != "uncert" and any(
                    "sigma_embed" in n for n, _ in model.named_parameters())
                forward = ddp_module(model, axis_name, replicas, find_unused_parameters=unread)
            if compute_dtype is None:
                images = images.to(next(model.parameters()).dtype)
            with torch.autocast(images.device.type, dtype=compute_dtype,
                                enabled=compute_dtype is not None):
                if denoising:
                    outputs = forward(images, {"labels": batch["labels"], "points": kp_norm},
                                      generator)
                else:
                    outputs = forward(images)
            mark("forward")
            total, losses = set_criterion(outputs, targets, criterion_cfg, axis_name)
        mark("loss")

        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        mark("backward")
        if state.clip_max_norm > 0:
            clip_by_global_norm_(model.parameters(), state.clip_max_norm)
        state.optimizer.step()
        state.scheduler.step()
        if state.ema is not None:
            ema_update(state.ema, model, state.step, train_cfg.ema_decay,
                       tau=train_cfg.ema_warmups)
        state.step += 1
        mark("optimizer")
        if axis_name is not None:
            return group_mean_losses(losses, axis_name)
        return {k: v.detach() for k, v in losses.items()}

    return train_step


def make_eval_step(criterion_cfg: Optional[CriterionConfig] = None,
                   solver_cfg: SolverConfig = SolverConfig(),
                   out_size: int = 256, solver: str = "simple",
                   use_ema: bool = False,
                   compute_dtype: Optional[torch.dtype] = None,
                   quant: Optional[dict] = None):
    """Build ``eval_step(model_or_state, batch) -> dict``.

    Batch dict: image (B,P,P,3) uint8 canvases, clip_bbox_buf (B,4) crop
    boxes in canvas pixels, clip_bbox (B,4) the same boxes in original
    image pixels, plus quat_gt (B,4) / tvec_gt (B,3) when ground truth is
    available, landmarks_buf (B,K,2) / labels (B,K) for the eval losses and,
    for ``solver="self_assessed"``, bbox_area (B,). Returns quat_pr,
    tvec_pr, valid, points, probs, sigmas, aux_points_<i> (float32 raw
    aux-layer logits, the JAX eval-log contract), with ground truth
    score_tvec / score_quat / score, and with ``criterion_cfg`` and
    landmarks ``eval_losses`` (loss_total and the criterion's dict).

    ``solver``: "simple" (R1: P3P-RANSAC + pixel LM; sigmas are ones),
    "sigma" or "self_assessed" (R2, for a model with ``pred_sigmas``:
    sigmas = exp(pred_sigmas) * (crop extent)^2 in original pixel^2, then
    ``solve_pose_sigma`` / ``solve_pose_self_assessed``).

    Given a ``TrainState``, the step evaluates its model, with
    ``use_ema`` on the EMA shadow (parameters and buffers, BN running
    statistics included) cast to the model's dtype. The model runs in eval mode. ``compute_dtype`` (e.g.
    ``torch.bfloat16``) runs it under ``torch.autocast``, as the train
    step does, so a train state's float32 parameters are evaluated in the
    model dtype the JAX eval step uses; None computes in the parameters'
    dtype.

    ``quant``: the calibrated activation ranges of an int8 model
    (``utils.calibrate.calibrate_act_scales``, or a JAX ``quant``
    collection through ``flax_quant_to_port``): its int8 modules then take
    static scales max(amax, 1e-8) / 127, resolved to the model's modules
    the first time the step sees the model on a device; a ``quant`` that
    does not hold exactly the model's int8 sites raises there
    (``models.layers.site_scales``). Without it they quantize each
    activation dynamically.
    """
    resolved = weakref.WeakKeyDictionary()  # model -> (device, its site scales)

    def quant_context(model, device):
        if quant is None:
            return contextlib.nullcontext()
        entry = resolved.get(model)
        if entry is None or entry[0] != device:
            entry = resolved[model] = (device, site_scales(model, quant, device))
        return static_scales(entry[1])

    if solver not in ("simple", "sigma", "self_assessed"):
        raise ValueError(f"unknown solver {solver!r}")

    @torch.inference_mode()
    def eval_step(model_or_state, batch):
        state = model_or_state if isinstance(model_or_state, TrainState) else None
        model = state.model if state is not None else model_or_state
        with span("eval.step"):
            with span("eval.warp"):
                images = crop_resize_cubic_mxu(batch["image"], batch["clip_bbox_buf"],
                                               out_size, True)
                dtype = next(model.parameters()).dtype
                if compute_dtype is None:
                    images = images.to(dtype)
            with span("eval.model"):
                was_training = model.training
                model.eval()
                try:
                    with torch.autocast(images.device.type, dtype=compute_dtype,
                                        enabled=compute_dtype is not None), \
                            quant_context(model, images.device):
                        if use_ema and state is not None and state.ema is not None:
                            weights = {k: v.to(dtype) for k, v in state.ema.items()}
                            outputs = torch.func.functional_call(model, weights, (images,))
                        else:
                            outputs = model(images)
                finally:
                    model.train(was_training)
            with span("eval.solver"):
                result = solve(outputs, batch)
            if criterion_cfg is not None and "landmarks_buf" in batch:
                bb = batch["clip_bbox_buf"]
                kp_norm = (batch["landmarks_buf"] - bb[:, None, 0:2]) / (
                    bb[:, None, 2:4] - bb[:, None, 0:2])
                total, losses = set_criterion(
                    outputs, {"labels": batch["labels"], "landmarks": kp_norm}, criterion_cfg)
                result["eval_losses"] = {"loss_total": total, **losses}
        return result

    def solve(outputs, batch):
        """Softmax, pixel de-normalisation, the pose solver and the SPEED
        score of the model's ``outputs``; on a card the first and the last
        replay a graph each (``utils/graphs.py``), as the solver's stages
        do."""
        probs, pts_pix, sigmas_pix = graphed(
            "eval.solver.prepare", _prepare, outputs["pred_logits"], outputs["pred_points"],
            None if solver == "simple" else outputs["pred_sigmas"], batch["clip_bbox"])
        world = world_points(pts_pix.device, pts_pix.dtype)
        if solver == "simple":
            quat, tvec, valid = solve_pose_simple(world, pts_pix, probs, solver_cfg)
        elif solver == "sigma":
            quat, tvec, valid = solve_pose_sigma(world, pts_pix, probs, sigmas_pix, solver_cfg)
        else:
            quat, tvec, valid = solve_pose_self_assessed(
                world, pts_pix, probs, sigmas_pix, batch["bbox_area"], solver_cfg)
        result = {
            "quat_pr": quat,
            "tvec_pr": tvec,
            "valid": valid,
            "points": pts_pix,
            "probs": probs,
            "sigmas": sigmas_pix,
        }
        for i, logits in collect_aux_points(outputs):
            result[f"aux_points_{i}"] = logits
        if "quat_gt" in batch:
            result.update(graphed("eval.solver.score", speed_score_batch, quat, tvec,
                                  batch["quat_gt"], batch["tvec_gt"]))
        return result

    return eval_step


def _prepare(logits, points, log_sigmas, clip):
    """Probabilities, and the points (normalised to the crop) and sigmas in
    original-image pixels, from the model's outputs; ``log_sigmas`` None
    (the simple solver): sigmas are ones."""
    probs = torch.softmax(logits, dim=-1)
    clip = clip.to(torch.float32)
    wh = clip[:, 2:4] - clip[:, 0:2]
    pts_pix = points * wh[:, None, :] + clip[:, None, 0:2]
    if log_sigmas is None:
        return probs, pts_pix, torch.ones_like(pts_pix)
    # Sigmas are predicted in normalised crop units: variances scale to
    # original pixels^2 with the square of the crop extent.
    return probs, pts_pix, torch.exp(log_sigmas) * wh[:, None, :] ** 2
