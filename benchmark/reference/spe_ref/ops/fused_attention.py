"""Plain self-attention: softmax(sm_scale * q @ k^T) @ v over (B, H, T, D)
inputs, with autograd's gradient. The benchmark's copy of the program's
``ops/fused_attention.py`` keeps only its plain version, which it runs on
every device in place of the K1 / K2 kernels.
"""
from __future__ import annotations

import torch


def attention_plain(q, k, v, sm_scale):
    """Plain attention: float32 scores and softmax, probabilities cast to
    v's dtype, float32 PV, cast back to the input dtype (float64 stays
    float64)."""
    acc = torch.promote_types(q.dtype, torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", q.to(acc), k.to(acc)).float() * sm_scale
    acc = torch.promote_types(v.dtype, torch.float32)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).to(acc), v.to(acc))
    return out.float().to(v.dtype)


def fused_self_attention(q, k, v, sm_scale: float):
    """``attention_plain`` with a gradient, on any device."""
    return attention_plain(q, k, v, float(sm_scale))
