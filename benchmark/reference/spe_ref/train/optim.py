"""Optimizer and learning-rate schedule registry with regex parameter
groups (counterpart of train/optim.py), for the R2 YAML recipes'
``optimizer:`` / ``lr_scheduler:`` sections.

Each group of ``optimizer["params"]`` carries a regex matched (``re.findall``)
against the ``named_parameters()`` names and overrides lr / weight_decay /
betas for what it matches; the rest falls into a default group built from
the top-level settings. FrozenBatchNorm affines are buffers, so no group
sees them and the optimizer never updates or decays them.

The numerics are the JAX package's optax ones, which PyTorch's classes
match for the optimizers (SGD and Adam fold the L2 weight decay into the
gradient before the momentum or the moments; AdamW decouples it) but not
for the schedules. So every group's learning rate is set directly, before
each step, to the JAX schedule's value for that group's own base rate at
the optimizer step count (counted from 0, as optax counts):

* MultiStepLR: the base rate times gamma for each milestone (in epochs,
  times ``steps_per_epoch``) the count has reached, the milestone step
  itself included;
* CosineAnnealingLR: the closed form eta_min + (base - eta_min) (1 +
  cos(pi t / T)) / 2, which cycles past T_max;
* OneCycleLR: optax's ``cosine_onecycle_schedule``: ``max_lr`` is the peak
  of every group, no momentum is cycled;
* LambdaLR: the base rate times ``lr_lambda(epoch)``, for a callable
  passed in code.
"""
from __future__ import annotations

import math
import re
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

__all__ = ["OPTIMIZERS", "SCHEDULERS", "RegistryOptimizer", "GroupSchedule",
           "build_param_groups", "make_schedule", "build_optimizer"]


def build_param_groups(group_cfgs: Sequence[dict], model: torch.nn.Module
                       ) -> Tuple[Dict[str, str], List[dict]]:
    """Assign every parameter of ``model`` to a regex group.

    Returns (labels, groups): ``labels`` maps each parameter name to
    ``"g0".."gN"``, the last being the default catch-all, and ``groups`` is
    the per-label list of overrides (the default's empty). A name matched
    by two groups raises ``ValueError``."""
    names = [n for n, _ in model.named_parameters()]
    labels: Dict[str, str] = {}
    for gi, gcfg in enumerate(group_cfgs):
        for name in names:
            if re.findall(gcfg["params"], name):
                if name in labels:
                    raise ValueError(f"param '{name}' matched by groups {labels[name]} and "
                                     f"g{gi}: patterns must be disjoint")
                labels[name] = f"g{gi}"
    default = f"g{len(group_cfgs)}"
    for name in names:
        labels.setdefault(name, default)
    return labels, [dict(g) for g in group_cfgs] + [{}]


# -- schedules: step count -> learning rate -----------------------------------

def _multistep(base_lr, steps_per_epoch, milestones=(), gamma=0.1, **_):
    bounds = sorted({int(m) * steps_per_epoch for m in milestones})

    def sched(count):
        lr = base_lr
        for b in bounds:
            if count >= b:
                lr = gamma * lr
        return lr

    return sched


def _cosine(base_lr, steps_per_epoch, T_max, eta_min=0.0, **_):
    total = int(T_max) * steps_per_epoch

    def sched(count):
        return eta_min + (base_lr - eta_min) * 0.5 * (1.0 + math.cos(math.pi * count / total))

    return sched


def _onecycle(base_lr, steps_per_epoch, max_lr=None, total_steps=None, epochs=None,
              pct_start=0.3, div_factor=25.0, final_div_factor=1e4, **_):
    if total_steps is None:
        total_steps = int(epochs) * steps_per_epoch
    peak = float(max_lr) if max_lr is not None else base_lr
    bounds = [0, int(float(pct_start) * int(total_steps)), int(total_steps)]
    values = [peak / float(div_factor)]
    for scale in (float(div_factor), 1.0 / (float(div_factor) * float(final_div_factor))):
        values.append(values[-1] * scale)

    def sched(count):
        for i in range(2):
            if bounds[i] <= count < bounds[i + 1]:
                pct = (count - bounds[i]) / (bounds[i + 1] - bounds[i])
                start, end = values[i], values[i + 1]
                return end + (start - end) / 2.0 * (math.cos(math.pi * pct) + 1)
        return values[-1]

    return sched


def _lambda(base_lr, steps_per_epoch, lr_lambda: Callable[[int], float], **_):
    def sched(count):
        return base_lr * lr_lambda(count // steps_per_epoch)

    return sched


SCHEDULERS: Dict[str, Callable] = {
    "MultiStepLR": _multistep,
    "CosineAnnealingLR": _cosine,
    "OneCycleLR": _onecycle,
    "LambdaLR": _lambda,
}


def make_schedule(sched_cfg: Optional[dict], base_lr: float,
                  steps_per_epoch: int = 1) -> Callable[[int], float]:
    """The step count -> lr function of an R2 ``lr_scheduler`` dict (a
    constant ``base_lr`` without one)."""
    if not sched_cfg:
        return lambda count: base_lr
    kind = sched_cfg.get("type", "MultiStepLR")
    if kind not in SCHEDULERS:
        raise ValueError(f"unknown lr_scheduler type {kind!r}; known: {sorted(SCHEDULERS)}")
    kwargs = {k: v for k, v in sched_cfg.items() if k != "type"}
    return SCHEDULERS[kind](base_lr, steps_per_epoch, **kwargs)


class GroupSchedule(torch.optim.lr_scheduler.LRScheduler):
    """Sets group i's learning rate to ``schedules[i](count)``, ``count``
    the number of ``step()`` calls so far (one after each optimizer
    step)."""

    def __init__(self, optimizer: torch.optim.Optimizer,
                 schedules: Sequence[Callable[[int], float]]):
        self.schedules = list(schedules)
        super().__init__(optimizer)

    def get_lr(self):
        return [float(fn(self.last_epoch)) for fn in self.schedules]

    def state_dict(self):
        """The step count and rates, without the schedule functions (which
        the config rebuilds), so that the state can be saved."""
        return {k: v for k, v in super().state_dict().items() if k != "schedules"}

    def load_state_dict(self, state_dict):
        super().load_state_dict({k: v for k, v in state_dict.items() if k != "schedules"})


# -- optimizers: (param groups, lr, settings) -> torch optimizer -------------

def _sgd(groups, lr, weight_decay=0.0, momentum=0.0, nesterov=False, **_):
    return torch.optim.SGD(groups, lr=lr, momentum=momentum or 0.0, nesterov=nesterov,
                           weight_decay=weight_decay)


def _adam(groups, lr, weight_decay=0.0, betas=(0.9, 0.999), eps=1e-8, **_):
    return torch.optim.Adam(groups, lr=lr, betas=tuple(betas), eps=eps,
                            weight_decay=weight_decay)


def _adamw(groups, lr, weight_decay=0.0, betas=(0.9, 0.999), eps=1e-8, **_):
    return torch.optim.AdamW(groups, lr=lr, betas=tuple(betas), eps=eps,
                             weight_decay=weight_decay)


OPTIMIZERS: Dict[str, Callable] = {"SGD": _sgd, "Adam": _adam, "AdamW": _adamw}

_GROUP_KEYS = {"SGD": ("weight_decay", "momentum", "nesterov"),
               "Adam": ("weight_decay", "betas", "eps"),
               "AdamW": ("weight_decay", "betas", "eps")}


class RegistryOptimizer(NamedTuple):
    """What ``build_optimizer`` returns and ``train.state.create_train_state``
    takes: the optimizer, its per-group schedule (call ``step()`` after each
    optimizer step) and the global-norm clip (0: none)."""
    optimizer: torch.optim.Optimizer
    scheduler: GroupSchedule
    clip_max_norm: float


def build_optimizer(optim_cfg: dict, model: torch.nn.Module, steps_per_epoch: int = 1,
                    sched_cfg: Optional[dict] = None,
                    clip_max_norm: float = 0.0) -> RegistryOptimizer:
    """An R2 ``optimizer:`` dict (type / lr / betas / weight_decay /
    momentum / params groups) and ``lr_scheduler:`` dict -> the optimizer
    over ``model``'s parameters, one torch group per regex group (the
    default last; empty groups dropped), each scheduled from its own base
    lr."""
    kind = optim_cfg.get("type", "AdamW")
    if kind not in OPTIMIZERS:
        raise ValueError(f"unknown optimizer type {kind!r}; known: {sorted(OPTIMIZERS)}")
    base = {k: v for k, v in optim_cfg.items() if k not in ("type", "params")}
    base_lr = float(base.pop("lr", 1e-4))
    labels, overrides = build_param_groups(optim_cfg.get("params", []) or [], model)
    named = list(model.named_parameters())
    groups, schedules = [], []
    for gi, over in enumerate(overrides):
        params = [p for n, p in named if labels[n] == f"g{gi}"]
        if not params:
            continue
        kw = dict(base)
        kw.update({k: v for k, v in over.items() if k != "params"})
        lr = float(kw.pop("lr", base_lr))
        group = {"params": params, "lr": lr}
        for k, v in kw.items():
            if k in _GROUP_KEYS[kind]:
                group[k] = tuple(v) if k == "betas" else (v or 0.0) if k == "momentum" else v
        groups.append(group)
        schedules.append(make_schedule(sched_cfg, lr, steps_per_epoch))
    optimizer = OPTIMIZERS[kind](groups, base_lr, **base)
    return RegistryOptimizer(optimizer, GroupSchedule(optimizer, schedules),
                             float(clip_max_norm or 0.0))
