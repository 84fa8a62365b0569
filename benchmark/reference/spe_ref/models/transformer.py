"""DETR encoder/decoder transformer (counterpart of models/transformer.py).

Post-norm layers (pre-norm with ``normalize_before``, which adds a final
``encoder_norm``), LayerNorm eps 1e-5, ReLU or erf-GELU FFNs, positional
embeddings added to q/k only, and one shared ``decoder_norm`` applied to
every decoder intermediate. Sequences are (B, T, C). ``module.training``
stands for the JAX layers' ``deterministic=False``: dropout sits where the
JAX layers put it (on the attention weights of the plain core, after the
FFN activation, and on each residual branch), and ``remat`` recomputes
each encoder layer in the backward pass (``torch.utils.checkpoint``).
One device, float only: the program's tensor- and sequence-parallel forms
and its int8 paths have no copy here.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.fused_attention import fused_self_attention
from .layers import get_activation, linear


class _Attention(nn.Module):
    """Multi-head attention with a selectable core:

    * ``fused`` — the plain math of ops/fused_attention.py (float32 scores
      and softmax), which the program runs as K1 forward and K2 backward;
    * ``plain`` — einsum / softmax in the model dtype, with attention-weight
      dropout and an optional mask.

    ``fused`` falls to ``plain`` for a mask, for dropout in training and for
    sequences shorter than 256 tokens (the JAX routing rule).
    """

    def __init__(self, d_model, nhead, dropout=0.1, impl="fused", generator=None):
        super().__init__()
        self.nhead = nhead
        self.head_dim = d_model // nhead
        self.dropout = dropout
        self.impl = impl
        inner = nhead * self.head_dim
        self.mha_query = linear(d_model, inner, generator)
        self.mha_key = linear(d_model, inner, generator)
        self.mha_value = linear(d_model, inner, generator)
        self.mha_out = linear(inner, d_model, generator)
        self.attn_drop = nn.Dropout(dropout)

    def forward(self, q, k, v, attn_mask=None):
        """``attn_mask``: optional (Tq, Tk) bool, True = blocked."""
        sm_scale = 1.0 / (self.head_dim ** 0.5)

        def heads(proj, x):  # (B, T, C) -> (B, H, T, D) view
            return proj(x).unflatten(-1, (self.nhead, self.head_dim)).transpose(1, 2)

        qh = heads(self.mha_query, q)
        kh = heads(self.mha_key, k)
        vh = heads(self.mha_value, v)

        impl = self.impl
        if (self.dropout > 0.0 and self.training) or attn_mask is not None:
            impl = "plain"
        if impl == "fused" and q.shape[1] < 256:
            # Short sequences (decoder queries): launch overhead beats any
            # score-traffic saving.
            impl = "plain"
        if impl == "fused":
            out = fused_self_attention(qh, kh, vh, sm_scale)
        else:
            # The scale rounded to the scores' dtype, as the JAX core
            # multiplies by jnp.asarray(sm_scale, dtype).
            s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * torch.tensor(sm_scale, dtype=qh.dtype)
            if attn_mask is not None:
                s = s.masked_fill(attn_mask, -1e9)
            p = self.attn_drop(torch.softmax(s, dim=-1))
            out = torch.einsum("bhqk,bhkd->bhqd", p.to(vh.dtype), vh)
        return self.mha_out(out.transpose(1, 2).flatten(2))


def _ffn(layer, x):
    """linear1 -> activation -> dropout -> linear2."""
    return layer.linear2(layer.drop(layer.act(layer.linear1(x))))


class EncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward=2048, dropout=0.1, generator=None,
                 activation="relu", normalize_before=False):
        super().__init__()
        self.normalize_before = normalize_before
        self.act = get_activation(activation)
        self.self_attn = _Attention(d_model, nhead, dropout, "fused", generator)
        self.linear1 = linear(d_model, dim_feedforward, generator)
        self.linear2 = linear(dim_feedforward, d_model, generator)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.drop = nn.Dropout(dropout)

    def forward(self, src, pos):
        """``src`` (B, T, C) and ``pos`` (1, T, C)."""
        def sa(x):
            qk = x + pos
            return self.drop(self.self_attn(qk, qk, x))

        if self.normalize_before:
            src = src + sa(self.norm1(src))
            return src + self.drop(_ffn(self, self.norm2(src)))
        src = self.norm1(src + sa(src))
        return self.norm2(src + self.drop(_ffn(self, src)))


class DecoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward=2048, dropout=0.1, generator=None,
                 activation="relu", normalize_before=False):
        super().__init__()
        self.normalize_before = normalize_before
        self.act = get_activation(activation)
        self.self_attn = _Attention(d_model, nhead, dropout, "plain", generator)
        self.cross_attn = _Attention(d_model, nhead, dropout, "plain", generator)
        self.linear1 = linear(d_model, dim_feedforward, generator)
        self.linear2 = linear(dim_feedforward, d_model, generator)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.drop = nn.Dropout(dropout)

    def forward(self, tgt, memory, pos, query_pos):
        def sa(x):
            qk = x + query_pos
            return self.drop(self.self_attn(qk, qk, x))

        def ca(x):
            return self.drop(self.cross_attn(x + query_pos, memory + pos, memory))

        if self.normalize_before:
            tgt = tgt + sa(self.norm1(tgt))
            tgt = tgt + ca(self.norm2(tgt))
            return tgt + self.drop(_ffn(self, self.norm3(tgt)))
        tgt = self.norm1(tgt + sa(tgt))
        tgt = self.norm2(tgt + ca(tgt))
        return self.norm3(tgt + self.drop(_ffn(self, tgt)))


class Transformer(nn.Module):
    """Full DETR transformer: (B, HW, C) memory tokens and learned queries
    -> stacked decoder intermediates (num_decoder_layers, B, Q, C) and the
    encoder memory."""

    def __init__(self, d_model=256, nhead=8, num_encoder_layers=6,
                 num_decoder_layers=6, dim_feedforward=2048, dropout=0.1,
                 generator=None, activation="relu", normalize_before=False, remat=False):
        super().__init__()
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.remat = remat
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer_{i}", EncoderLayer(
                d_model, nhead, dim_feedforward, dropout, generator, activation,
                normalize_before))
        self.encoder_norm = nn.LayerNorm(d_model, eps=1e-5) if normalize_before else None
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer_{i}", DecoderLayer(
                d_model, nhead, dim_feedforward, dropout, generator, activation,
                normalize_before))
        self.decoder_norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, query_embed, pos_embed):
        """src (B, T, C); query_embed (Q, C); pos_embed (T, C)."""
        pos = pos_embed[None].to(src.dtype)
        query_pos = query_embed[None].expand(src.shape[0], -1, -1).to(src.dtype)
        mem = src
        for i in range(self.num_encoder_layers):
            layer = getattr(self, f"encoder_layer_{i}")
            if self.remat and self.training:
                mem = checkpoint(layer, mem, pos, use_reentrant=False)
            else:
                mem = layer(mem, pos)
        if self.encoder_norm is not None:
            mem = self.encoder_norm(mem)
        tgt = torch.zeros_like(query_pos)
        intermediates = []
        for i in range(self.num_decoder_layers):
            tgt = getattr(self, f"decoder_layer_{i}")(tgt, mem, pos, query_pos)
            intermediates.append(self.decoder_norm(tgt))
        return torch.stack(intermediates, dim=0), mem
