"""DETR encoder/decoder transformer (counterpart of models/transformer.py).

Post-norm layers (pre-norm with ``normalize_before``, which adds a final
``encoder_norm``), LayerNorm eps 1e-5, ReLU or erf-GELU FFNs, positional
embeddings added to q/k only, and one shared ``decoder_norm`` applied to
every decoder intermediate. Sequences are (B, T, C). ``module.training``
stands for the JAX layers' ``deterministic=False``: dropout sits where the
JAX layers put it (on the attention weights of the plain core, after the
FFN activation, and on each residual branch), and ``remat`` recomputes
each encoder layer in the backward pass (``torch.utils.checkpoint``).

Inside ``parallel.tp.tp_activation_sharding`` every attention runs its
local heads and every FFN its local hidden units (tensor parallelism);
inside ``parallel.sp.sequence_sharding`` the encoder runs on this rank's
tokens (sequence parallelism).

``quant`` (eval deployment) makes the FFNs int8 under the ``ffn`` scope and
the attention projections under ``attn_proj`` (``ops.quantize.quant_scope``,
read when the model is built); the decoder layers take
``quant and quant_scope("dec")``. An attention with ``quant`` and
``quant_core`` set also runs its core on int8 codes
(``ops.quantize.int8_attention_core``, K6 on the card), whatever the
``attn_proj`` scope: no layer sets ``quant_core``, as in JAX, so a caller
sets the attribute on the modules it wants.
"""
from __future__ import annotations

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from ..ops.flash_attention import flash_self_attention
from ..ops.fused_attention import fused_self_attention
from ..ops.quantize import int8_attention_core, quant_scope
from ..parallel.sp import active as sp_active
from ..parallel.sp import gather_tokens, shard_tokens
from ..parallel.tp import activation_ctx, column_parallel, row_parallel, split_ctx
from .layers import QDense, act_scale_or_calibrate, get_activation, linear


class _Attention(nn.Module):
    """Multi-head attention with a selectable core:

    * ``fused`` — ops/fused_attention.py (on a GPU, K1 forward and K2
      backward);
    * ``flash`` — ops/flash_attention.py (on a GPU, K5 forward and
      backward);
    * ``plain`` — einsum / softmax in the model dtype, with attention-weight
      dropout and an optional mask.

    ``fused`` and ``flash`` fall to ``plain`` for a mask and for dropout in
    training, and ``fused`` also for sequences shorter than 256 tokens (the
    JAX routing rule). ``quant`` makes the projections int8 under the
    ``attn_proj`` scope. ``quant`` and ``quant_core`` together make the core
    int8 (``ops.quantize.int8_attention_core``; on a GPU, K6) whenever no
    dropout is needed, before every rule above and whatever the scope, as
    JAX routes it; its q, k and v scales are the static-PTQ sites
    ``amax_q``, ``amax_k`` and ``amax_v`` of this module. JAX's int8 core
    ignores a mask; this one raises on it (a mask comes only with CDN
    training, where quant is off).
    """

    def __init__(self, d_model, nhead, dropout=0.1, impl="fused", generator=None,
                 quant=False, quant_core=False):
        super().__init__()
        self.nhead = nhead
        self.head_dim = d_model // nhead
        self.dropout = dropout
        self.impl = impl
        self.quant = quant
        self.quant_core = quant_core
        inner = nhead * self.head_dim
        qproj = quant and quant_scope("attn_proj")
        self.mha_query = linear(d_model, inner, generator, qproj)
        self.mha_key = linear(d_model, inner, generator, qproj)
        self.mha_value = linear(d_model, inner, generator, qproj)
        self.mha_out = linear(inner, d_model, generator, qproj)
        self.attn_drop = nn.Dropout(dropout)

    def forward(self, q, k, v, attn_mask=None):
        """``attn_mask``: optional (Tq, Tk) bool, True = blocked. Inside
        ``parallel.tp.tp_activation_sharding`` the attention runs this
        rank's heads of the model axis, and its output projection's partial
        sums are reduced over that axis."""
        sm_scale = 1.0 / (self.head_dim ** 0.5)
        inner = self.nhead * self.head_dim
        tp = _tp_ctx(self.nhead, self.mha_query)
        nhead = self.nhead if tp is None else self.nhead // tp[0].axis_size(tp[2])

        def heads(proj, x):  # (B, T, C) -> (B, H, T, D) view
            y = proj(x) if tp is None else column_parallel(x, proj, inner, tp)
            return y.unflatten(-1, (nhead, self.head_dim)).transpose(1, 2)

        qh = heads(self.mha_query, q)
        kh = heads(self.mha_key, k)
        vh = heads(self.mha_value, v)

        impl = self.impl
        needs_dropout = self.dropout > 0.0 and self.training
        if needs_dropout or attn_mask is not None:
            impl = "plain"
        if impl == "fused" and q.shape[1] < 256:
            # Short sequences (decoder queries): launch overhead beats any
            # score-traffic saving.
            impl = "plain"
        if self.quant and self.quant_core and not needs_dropout:
            if attn_mask is not None:
                raise ValueError("the int8 attention core takes no mask")
            if tp is not None:
                raise ValueError("the int8 attention core quantizes all heads with one scale; "
                                 "tensor parallelism splits them")
            scales = tuple(act_scale_or_calibrate(self, t, f"amax_{n}")
                           for n, t in (("q", qh), ("k", kh), ("v", vh)))
            out = int8_attention_core(qh, kh, vh, sm_scale, scales)
        elif impl == "fused":
            out = fused_self_attention(qh, kh, vh, sm_scale)
        elif impl == "flash":
            out = flash_self_attention(qh, kh, vh, sm_scale)
        else:
            # The scale rounded to the scores' dtype, as the JAX core
            # multiplies by jnp.asarray(sm_scale, dtype).
            s = torch.einsum("bhqd,bhkd->bhqk", qh, kh) * torch.tensor(sm_scale, dtype=qh.dtype)
            if attn_mask is not None:
                s = s.masked_fill(attn_mask, -1e9)
            p = self.attn_drop(torch.softmax(s, dim=-1))
            out = torch.einsum("bhqk,bhkd->bhqd", p.to(vh.dtype), vh)
        out = out.transpose(1, 2).flatten(2)
        return self.mha_out(out) if tp is None else row_parallel(out, self.mha_out, inner, tp)


def _tp_ctx(count: int, proj):
    """The tensor-parallel context that splits ``count`` heads or hidden
    units, or None; int8 projections have no split form."""
    tp = split_ctx(count)
    if tp is not None and isinstance(proj, QDense):
        raise ValueError("tensor parallelism splits float projections; this layer is int8")
    return tp


def _ffn(layer, x):
    """linear1 -> activation -> dropout -> linear2; inside
    ``parallel.tp.tp_activation_sharding`` on this rank's hidden units, the
    partial sums reduced over the model axis."""
    f = layer.linear1.out_features
    tp = _tp_ctx(f, layer.linear1)
    if tp is None:
        return layer.linear2(layer.drop(layer.act(layer.linear1(x))))
    h = layer.drop(layer.act(column_parallel(x, layer.linear1, f, tp)))
    return row_parallel(h, layer.linear2, f, tp)


class EncoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward=2048, dropout=0.1, generator=None,
                 use_flash=False, activation="relu", normalize_before=False, quant=False):
        super().__init__()
        self.normalize_before = normalize_before
        self.act = get_activation(activation)
        self.self_attn = _Attention(d_model, nhead, dropout,
                                    "flash" if use_flash else "fused", generator, quant)
        qffn = quant and quant_scope("ffn")
        self.linear1 = linear(d_model, dim_feedforward, generator, qffn)
        self.linear2 = linear(dim_feedforward, d_model, generator, qffn)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.drop = nn.Dropout(dropout)

    def forward(self, src, pos):
        """``src`` (B, T, C) and ``pos`` (1, T, C); inside
        ``parallel.sp.sequence_sharding`` ``src`` is this rank's T / n
        tokens (and so is the output): the attention runs on the gathered
        sequence, the rest on the rank's tokens."""
        sharded = sp_active() is not None and src.shape[1] != pos.shape[1]

        def sa(x):
            if not sharded:
                qk = x + pos
                return self.drop(self.self_attn(qk, qk, x))
            x = gather_tokens(x)
            qk = x + pos
            return self.drop(shard_tokens(self.self_attn(qk, qk, x)))

        def ffn(x):
            if sharded and activation_ctx() is not None:
                # the TP split's partial sums cover every token of the group
                return shard_tokens(_ffn(self, gather_tokens(x)))
            return _ffn(self, x)

        if self.normalize_before:
            src = src + sa(self.norm1(src))
            return src + self.drop(ffn(self.norm2(src)))
        src = self.norm1(src + sa(src))
        return self.norm2(src + self.drop(ffn(src)))


class DecoderLayer(nn.Module):
    def __init__(self, d_model, nhead, dim_feedforward=2048, dropout=0.1, generator=None,
                 activation="relu", normalize_before=False, quant=False):
        super().__init__()
        self.normalize_before = normalize_before
        self.act = get_activation(activation)
        self.self_attn = _Attention(d_model, nhead, dropout, "plain", generator, quant)
        self.cross_attn = _Attention(d_model, nhead, dropout, "plain", generator, quant)
        self.linear1 = linear(d_model, dim_feedforward, generator, quant)
        self.linear2 = linear(dim_feedforward, d_model, generator, quant)
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
                 generator=None, use_flash=False, activation="relu",
                 normalize_before=False, quant=False, remat=False):
        super().__init__()
        self.num_encoder_layers = num_encoder_layers
        self.num_decoder_layers = num_decoder_layers
        self.remat = remat
        for i in range(num_encoder_layers):
            self.add_module(f"encoder_layer_{i}", EncoderLayer(
                d_model, nhead, dim_feedforward, dropout, generator, use_flash, activation,
                normalize_before, quant))
        self.encoder_norm = nn.LayerNorm(d_model, eps=1e-5) if normalize_before else None
        qdec = quant and quant_scope("dec")
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer_{i}", DecoderLayer(
                d_model, nhead, dim_feedforward, dropout, generator, activation,
                normalize_before, qdec))
        self.decoder_norm = nn.LayerNorm(d_model, eps=1e-5)

    def forward(self, src, query_embed, pos_embed):
        """src (B, T, C); query_embed (Q, C); pos_embed (T, C)."""
        pos = pos_embed[None].to(src.dtype)
        query_pos = query_embed[None].expand(src.shape[0], -1, -1).to(src.dtype)
        mem = shard_tokens(src)  # this rank's tokens under sequence sharding
        for i in range(self.num_encoder_layers):
            layer = getattr(self, f"encoder_layer_{i}")
            if self.remat and self.training:
                mem = checkpoint(layer, mem, pos, use_reentrant=False)
            else:
                mem = layer(mem, pos)
        if self.encoder_norm is not None:
            mem = self.encoder_norm(mem)
        mem = gather_tokens(mem, replicated=True)  # every rank decodes the whole memory
        tgt = torch.zeros_like(query_pos)
        intermediates = []
        for i in range(self.num_decoder_layers):
            tgt = getattr(self, f"decoder_layer_{i}")(tgt, mem, pos, query_pos)
            intermediates.append(self.decoder_norm(tgt))
        return torch.stack(intermediates, dim=0), mem
