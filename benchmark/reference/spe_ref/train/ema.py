"""Model EMA with a warmup-ramped decay (counterpart of train/ema.py).

The shadow is a float32 copy of every floating parameter AND buffer of the
model, keyed by ``state_dict`` name (the FrozenBatchNorm statistics and
affines included, as the JAX package averages its ``batch_stats`` too).
Per step: d = decay * (1 - exp(-(step + 1) / tau)), computed in float32 as
the JAX step does; shadow = d * shadow + (1 - d) * new.
"""
from __future__ import annotations

import torch


def ema_init(model: torch.nn.Module) -> dict:
    return {name: t.detach().to(torch.float32, copy=True)
            for name, t in model.state_dict().items() if t.is_floating_point()}


@torch.no_grad()
def ema_update(ema: dict, model: torch.nn.Module, step: int,
               decay: float = 0.9999, tau: float = 2000.0) -> None:
    """Update ``ema`` in place from the model's current weights; ``step`` is
    the number of optimizer steps taken before this one."""
    t = torch.tensor(step + 1.0, dtype=torch.float32)
    d = decay * (1.0 - torch.exp(-t / tau))  # float32, on the host
    state = model.state_dict()
    shadow = list(ema.values())
    new = [state[name].to(torch.float32) for name in ema]
    torch._foreach_mul_(shadow, float(d))
    torch._foreach_add_(shadow, new, alpha=float(1.0 - d))
