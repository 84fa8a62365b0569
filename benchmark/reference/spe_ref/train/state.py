"""Train state: AdamW with backbone / main parameter groups, the multistep
learning-rate schedule, global-norm clipping and the EMA shadow
(counterpart of train/state.py).

FrozenBatchNorm statistics and affines are buffers, so the optimizer never
sees them: they are neither updated nor decayed. The registry optimizers of
the RT-DETR recipes (``train/optim.py``) replace the default AdamW through
``create_train_state(..., tx=build_optimizer(...))``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .ema import ema_init


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    lr: float = 1e-4
    lr_backbone: float = 1e-5
    weight_decay: float = 1e-4
    clip_max_norm: float = 0.1
    lr_drop_steps: Tuple[int, ...] = ()  # in optimizer steps
    lr_drop_gamma: float = 0.1
    use_ema: bool = False
    ema_decay: float = 0.9999
    ema_warmups: float = 2000.0  # decay ramp time constant
    betas: Tuple[float, float] = (0.9, 0.999)


@dataclasses.dataclass
class TrainState:
    """The model (float32 parameters), its optimizer and schedule, the EMA
    shadow (None without EMA), the global-norm clip of the gradients (0:
    none) and the number of optimizer steps taken. The train step updates
    it in place."""
    model: torch.nn.Module
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LRScheduler
    ema: Optional[dict]
    step: int = 0
    clip_max_norm: float = 0.0


def make_optimizer(cfg: TrainConfig, model: torch.nn.Module):
    """AdamW (eps 1e-8, decoupled weight decay on every parameter) with the
    parameters under ``backbone.`` at ``lr_backbone`` and the rest at
    ``lr``, and a schedule
    that multiplies both by ``lr_drop_gamma`` from each of
    ``lr_drop_steps`` on (optimizer steps counted from 0, as optax counts).
    Returns (optimizer, scheduler); call ``scheduler.step()`` after each
    ``optimizer.step()``."""
    named = [(n, p) for n, p in model.named_parameters() if p.requires_grad]
    groups = [
        {"params": [p for n, p in named if n.startswith("backbone.")], "lr": cfg.lr_backbone},
        {"params": [p for n, p in named if not n.startswith("backbone.")], "lr": cfg.lr},
    ]
    optimizer = torch.optim.AdamW(
        [g for g in groups if g["params"]], lr=cfg.lr, betas=cfg.betas, eps=1e-8,
        weight_decay=cfg.weight_decay)
    drops = sorted(set(int(s) for s in cfg.lr_drop_steps))
    gamma = cfg.lr_drop_gamma
    scheduler = torch.optim.lr_scheduler.LambdaLR(
        optimizer, lambda count: gamma ** sum(count >= s for s in drops))
    return optimizer, scheduler


@torch.no_grad()
def clip_by_global_norm_(parameters, max_norm: float) -> torch.Tensor:
    """Scale the gradients in place by max_norm / max(|g|, max_norm), |g|
    their global norm (optax ``clip_by_global_norm``; unlike
    ``torch.nn.utils.clip_grad_norm_`` no 1e-6 is added to the norm).
    Returns |g| as a tensor, with no host synchronisation."""
    grads = [p.grad for p in parameters if p.grad is not None]
    norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
    scale = torch.where(norm < max_norm, 1.0, max_norm / norm)
    torch._foreach_mul_(grads, scale)
    return norm


def create_train_state(model: torch.nn.Module, cfg: TrainConfig, tx=None) -> TrainState:
    """Wrap a model with float32 parameters (``build_detr_train_model``,
    ``build_rtdetr_train_model``) into a train state: optimizer, schedule,
    clip and, with ``use_ema``, the shadow. ``tx`` (a
    ``train.optim.RegistryOptimizer`` from ``build_optimizer``, built on
    this model) replaces the default, ``make_optimizer(cfg, model)`` with
    ``cfg.clip_max_norm``."""
    if tx is None:
        optimizer, scheduler = make_optimizer(cfg, model)
        clip = cfg.clip_max_norm
    else:
        optimizer, scheduler, clip = tx
    return TrainState(model=model, optimizer=optimizer, scheduler=scheduler,
                      ema=ema_init(model) if cfg.use_ema else None, clip_max_norm=clip)
