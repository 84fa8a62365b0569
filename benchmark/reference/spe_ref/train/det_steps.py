"""The detection train step (counterpart of train/det_solver.py's
``make_det_train_step``): the model in training mode, with CDN groups from
the targets when ``denoising`` -> the box criterion (``losses.
det_criterion``) -> backward -> a zero gradient for every parameter no loss
reads (the sigma heads, which AdamW then still decays, as the program does)
-> global-norm clip -> optimizer step and schedule -> EMA, on one device.
"""
from __future__ import annotations

from typing import Optional

import torch

from ..losses.det_criterion import DetCriterionConfig, set_criterion_boxes
from .ema import ema_update
from .state import TrainConfig, TrainState, clip_by_global_norm_


def make_det_train_step(crit_cfg: DetCriterionConfig, train_cfg: TrainConfig,
                        denoising: bool = False,
                        compute_dtype: Optional[torch.dtype] = None):
    """``train_step(state, images, labels, boxes, generator, on_stage=None)
    -> losses`` on (B, S, S, 3) normalised images, (B, T) labels padded with
    -1 and (B, T, 4) normalised cxcywh boxes; ``generator`` draws the CDN
    noise. ``on_stage(name)`` is called as each stage ends (forward, match,
    loss, backward, optimizer). The state is updated in place."""

    def train_step(state: TrainState, images, labels, boxes, generator, on_stage=None):
        mark = on_stage or (lambda name: None)
        model = state.model
        model.train()
        with torch.autocast(images.device.type, dtype=compute_dtype,
                            enabled=compute_dtype is not None):
            if denoising:
                outputs = model(images, {"labels": labels, "points": boxes}, generator)
            else:
                outputs = model(images)
        mark("forward")
        total, losses = set_criterion_boxes(outputs, {"labels": labels, "boxes": boxes},
                                            crit_cfg, on_match=lambda: mark("match"))
        mark("loss")
        state.optimizer.zero_grad(set_to_none=True)
        total.backward()
        for p in model.parameters():
            if p.grad is None:
                p.grad = torch.zeros_like(p)
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
