"""The detection cell's matcher: an optimal assignment of queries to one
image's real targets by ``scipy.optimize.linear_sum_assignment``, in float64
on the host, one image and one decoder level at a time. It shares nothing
with the program's batched Hungarian (a fixed-bound shortest augmenting
path on the device over every padded target), so it checks that solver's
choice instead of repeating it.
"""
from __future__ import annotations

import numpy as np
import torch
from scipy.optimize import linear_sum_assignment


def solve(cost: np.ndarray) -> np.ndarray:
    """The query of each target (column) of the (Q, n) float64 ``cost``
    that minimises the assignment's total, Q >= n."""
    rows, cols = linear_sum_assignment(cost)
    out = np.empty(cost.shape[1], dtype=np.int64)
    out[cols] = rows
    return out


def assign(costs, mask):
    """(L, B, T) int64 on ``mask``'s device: for ``costs[l][b]`` (the
    (Q, n_b) cost of level l and image b over the n_b real targets that
    ``mask[b]`` (B, T) marks, in their order) the optimal query of each real
    target, and for each padded target the lowest query the image left
    free, in order, so that every image's queries are distinct."""
    real = mask.to("cpu").numpy()
    out = np.empty((len(costs), *real.shape), dtype=np.int64)
    for lv, per_image in enumerate(costs):
        for b, cost in enumerate(per_image):
            c = cost.detach().to("cpu", torch.float64).numpy()
            picked = solve(c) if c.shape[1] else np.empty(0, dtype=np.int64)
            free = np.setdiff1d(np.arange(c.shape[0]), picked)
            out[lv, b, real[b]] = picked
            out[lv, b, ~real[b]] = free[: int((~real[b]).sum())]
    return torch.from_numpy(out).to(mask.device)


def total_cost(cost, picked) -> float:
    """The total of ``cost`` (Q, n) over ``picked`` (n,): target t to query
    picked[t]."""
    c = cost.detach().to("cpu", torch.float64)
    return float(c[picked.to("cpu"), torch.arange(c.shape[1])].sum())
