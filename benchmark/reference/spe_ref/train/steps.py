"""The train step (counterpart of train/steps.py's ``make_train_step``):
augment -> model (training mode) -> set criterion -> backward -> global-norm
clip -> optimizer step and schedule -> EMA (parameters and buffers, the
BatchNorm running statistics the forward updated included), on one device
with no host round trip. The eval cells' reference runs the warp, the model,
the solvers and the score itself (``drivers/eval_closed_loop.py``).
"""
from __future__ import annotations

from typing import Optional

import torch

from ..data.augment import AugmentConfig, augment_batch
from ..losses.criterion import CriterionConfig, set_criterion
from .ema import ema_update
from .state import TrainConfig, TrainState, clip_by_global_norm_


def make_train_step(criterion_cfg: CriterionConfig, train_cfg: TrainConfig,
                    augment_cfg: AugmentConfig = AugmentConfig(),
                    denoising: bool = False,
                    compute_dtype: Optional[torch.dtype] = None):
    """Build ``train_step(state, batch, generator, on_stage=None) -> losses``.

    Batch dict (tensors on one device): image (B,P,P,3) uint8 canvases,
    clip_bbox_buf (B,4), landmarks_buf (B,K,2), labels (B,K). ``generator``
    is a ``torch.Generator`` on that device and drives the augmentation.
    ``compute_dtype`` (e.g. ``torch.bfloat16``) runs the model under
    ``torch.autocast`` on float32 parameters; None computes in the
    parameters' dtype. ``denoising`` hands an RT-DETR trained with
    ``num_denoising > 0`` its targets ({"labels", "points": the augmented
    normalised landmarks}) and ``generator`` for its CDN groups. The state
    is updated in place; the returned losses are detached tensors (no host
    synchronisation).
    """

    def train_step(state: TrainState, batch, generator, on_stage=None):
        """``on_stage(name)``, if given, is called as each stage ends
        (augment, forward, loss, backward, optimizer), e.g. to record a CUDA
        event for a per-stage breakdown."""
        mark = on_stage or (lambda name: None)
        model = state.model
        images, kp_norm = augment_batch(generator, batch["image"], batch["clip_bbox_buf"],
                                        batch["landmarks_buf"], augment_cfg)
        targets = {"labels": batch["labels"], "landmarks": kp_norm}
        mark("augment")
        model.train()
        if compute_dtype is None:
            images = images.to(next(model.parameters()).dtype)
        with torch.autocast(images.device.type, dtype=compute_dtype,
                            enabled=compute_dtype is not None):
            if denoising:
                outputs = model(images, {"labels": batch["labels"], "points": kp_norm},
                                generator)
            else:
                outputs = model(images)
        mark("forward")
        total, losses = set_criterion(outputs, targets, criterion_cfg)
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
        return {k: v.detach() for k, v in losses.items()}

    return train_step
