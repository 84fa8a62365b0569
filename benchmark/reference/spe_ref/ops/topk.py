"""Query selection for the RT-DETR decoder (counterpart of ops/topk.py).

The JAX package replaces ``jax.lax.top_k`` and the row gather with
TPU forms (``topk_small_k``: K argmax sweeps; ``select_rows``: a one-hot
matmul). Their semantics are an exact top-k, descending, ties resolved to
the lowest index first, and a row gather. ``torch.topk`` on CUDA gives no
order among ties (and bf16 scores over thousands of tokens do tie), so the
selection here is a stable descending sort.
"""
from __future__ import annotations

import torch


def topk(scores: torch.Tensor, k: int):
    """(values, indices) of the ``k`` largest of each row of ``scores``
    (B, L), descending, ties -> lowest index first. Scores below float32
    are compared in float32 (an exact widening)."""
    work = scores.float() if scores.dtype in (torch.bfloat16, torch.float16) else scores
    vals, idx = torch.sort(work, dim=-1, descending=True, stable=True)
    return vals[:, :k].to(scores.dtype), idx[:, :k]


def select_rows(arr: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """``arr[b, ind[b, k], :]`` -> (B, K, C). Unlike the JAX one-hot form,
    a row of ``arr`` holding +inf (an invalid anchor) does not turn the
    other selected rows into NaN (0 * inf)."""
    return torch.gather(arr, 1, ind[..., None].expand(-1, -1, arr.shape[-1]))
