"""RT-DETR point-query decoder with per-layer Gaussian sigma heads
(counterpart of models/rtdetr_decoder.py), eval only.

* per-pixel (x, y) anchors in logit space over every level; anchors
  outside (eps, 1 - eps) get the logit +inf, as in JAX (which computes the
  valid mask and, unlike the upstream RT-DETR, never multiplies the memory
  by it);
* an encoder head scores every token; the top ``num_queries`` tokens give
  the initial reference points and the query features
  (``ops.topk``: ties to the lowest index, exact row gathers);
* decoder layers: query self-attention, multi-scale deformable
  cross-attention, FFN, with iterative inverse-sigmoid point refinement;
* a sigma head MLP(h, h, 1, 3) per layer, broadcast to (x, y);
* outputs ``pred_logits`` / ``pred_points`` / ``pred_sigmas`` and
  ``aux_outputs`` (every earlier layer, then the encoder's top-k without
  sigmas), in the loss dtype.

Training (``module.training``) and CDN denoising (``num_denoising > 0``)
belong to the RT-DETR train slice and raise here, as do the learnt query
table and the detection task's 4-D box queries, which no speed config
selects. Module names follow the
JAX package. The decoder stays float under
``ops.quantize.quantized_inference``, as in JAX.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.deform_attn import deformable_attention_core
from ..ops.precision import to_loss_dtype
from ..ops.topk import select_rows, topk
from .layers import MLP, conv2d, get_activation, linear, norm_layer
from .transformer import _Attention


def inverse_sigmoid(x, eps=1e-5):
    x = x.clamp(0.0, 1.0)
    return torch.log(x.clamp(min=eps) / (1.0 - x).clamp(min=eps))


def _bias_init_with_prob(prior=0.01):
    return float(-math.log((1 - prior) / prior))


class MSDeformableAttention(nn.Module):
    def __init__(self, embed_dim=256, num_heads=8, num_levels=3, num_points=4, generator=None):
        super().__init__()
        self.num_heads, self.num_levels, self.num_points = num_heads, num_levels, num_points
        total = num_heads * num_levels * num_points
        self.value_proj = linear(embed_dim, embed_dim, generator)
        self.sampling_offsets = linear(embed_dim, total * 2, generator)
        self.attention_weights = linear(embed_dim, total, generator)
        self.output_proj = linear(embed_dim, embed_dim, generator)
        with torch.no_grad():
            # The reference init: per head a unit direction on a ring,
            # scaled 1..num_points; attention weights uniform.
            self.sampling_offsets.weight.zero_()
            thetas = torch.arange(num_heads, dtype=torch.float32) * (2.0 * math.pi / num_heads)
            grid = torch.stack([thetas.cos(), thetas.sin()], -1)
            grid = grid / grid.abs().amax(-1, keepdim=True)
            grid = grid.reshape(num_heads, 1, 1, 2).repeat(1, num_levels, num_points, 1)
            grid = grid * torch.arange(1, num_points + 1, dtype=torch.float32).reshape(1, 1, -1, 1)
            self.sampling_offsets.bias.copy_(grid.reshape(-1))
            self.attention_weights.weight.zero_()

    def forward(self, query, reference_points, value, spatial_shapes):
        """query (B, Q, C); reference_points (B, Q, 2) in [0, 1]; value
        (B, L, C); spatial_shapes [(h, w)] per level."""
        B, Q, _ = query.shape
        L = value.shape[1]
        H, Lv, P = self.num_heads, self.num_levels, self.num_points
        v = self.value_proj(value).reshape(B, L, H, -1)
        offsets = self.sampling_offsets(query).reshape(B, Q, H, Lv, P, 2)
        attw = torch.softmax(self.attention_weights(query).reshape(B, Q, H, Lv * P), dim=-1)
        attw = attw.reshape(B, Q, H, Lv, P)
        normalizer = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                                  device=query.device).reshape(1, 1, 1, Lv, 1, 2)
        locations = reference_points[:, :, None, None, None, :] + offsets / normalizer
        return self.output_proj(deformable_attention_core(v, spatial_shapes, locations, attw))


class RTDecoderLayer(nn.Module):
    def __init__(self, d_model=256, n_head=8, dim_feedforward=1024, dropout=0.0,
                 activation="relu", n_levels=3, n_points=4, generator=None):
        super().__init__()
        g = generator
        self.self_attn = _Attention(d_model, n_head, dropout, "fused", g)
        self.norm1 = nn.LayerNorm(d_model, eps=1e-5)
        self.cross_attn = MSDeformableAttention(d_model, n_head, n_levels, n_points, g)
        self.norm2 = nn.LayerNorm(d_model, eps=1e-5)
        self.linear1 = linear(d_model, dim_feedforward, g)
        self.linear2 = linear(dim_feedforward, d_model, g)
        self.norm3 = nn.LayerNorm(d_model, eps=1e-5)
        self.act = get_activation(activation)
        self.drop = nn.Dropout(dropout)

    def forward(self, tgt, reference_points, memory, spatial_shapes, query_pos):
        qk = tgt + query_pos
        tgt = self.norm1(tgt + self.drop(self.self_attn(qk, qk, tgt)))
        ca = self.cross_attn(tgt + query_pos, reference_points, memory, spatial_shapes)
        tgt = self.norm2(tgt + self.drop(ca))
        ff = self.linear2(self.drop(self.act(self.linear1(tgt))))
        return self.norm3(tgt + self.drop(ff))


class RTDETRTransformer(nn.Module):
    def __init__(self, num_classes=11, hidden_dim=256, num_queries=30,
                 feat_channels=(256, 256, 256), num_levels=3, num_decoder_points=4, nhead=8,
                 num_decoder_layers=3, dim_feedforward=1024, dropout=0.0, activation="relu",
                 learnt_init_query=False, box_dim=2, eps=1e-2, aux_loss=True, num_denoising=0,
                 generator=None):
        super().__init__()
        if num_denoising > 0:
            raise NotImplementedError("CDN denoising (num_denoising > 0) trains RT-DETR; "
                                      "RT-DETR training is not ported")
        if learnt_init_query or box_dim != 2:
            raise NotImplementedError("the learnt query table and box queries (box_dim 4, the "
                                      "detection task) are not ported")
        g = generator
        h = hidden_dim
        self.num_queries, self.num_decoder_layers = num_queries, num_decoder_layers
        self.eps, self.aux_loss = eps, aux_loss
        for i, cin in enumerate(feat_channels):
            self.add_module(f"input_proj_{i}_conv", conv2d(cin, h, 1, bias=False, generator=g))
            self.add_module(f"input_proj_{i}_norm", norm_layer("bn", h))
        self.enc_output_0 = linear(h, h, g)
        self.enc_output_1 = nn.LayerNorm(h, eps=1e-5)
        self.enc_score_head = linear(h, num_classes + 1, g)
        self.enc_bbox_head = MLP(h, h, 2, 3, generator=g)
        self.query_pos_head = MLP(2, 2 * h, h, 2, generator=g)
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer_{i}", RTDecoderLayer(
                h, nhead, dim_feedforward, dropout, activation, num_levels,
                num_decoder_points, g))
            self.add_module(f"dec_bbox_head_{i}", MLP(h, h, 2, 3, generator=g))
            self.add_module(f"dec_score_head_{i}", linear(h, num_classes + 1, g))
            self.add_module(f"sigma_embed_{i}", MLP(h, h, 1, 3, generator=g))
        with torch.no_grad():
            for i in ["enc_score_head"] + [f"dec_score_head_{i}"
                                           for i in range(num_decoder_layers)]:
                getattr(self, i).bias.fill_(_bias_init_with_prob())

    def _anchors(self, spatial_shapes, device):
        """(L, 2) anchor logits, +inf outside (eps, 1 - eps)."""
        anchors = []
        for h, w in spatial_shapes:
            gx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
            gy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
            gyy, gxx = torch.meshgrid(gy, gx, indexing="ij")
            anchors.append(torch.stack([gxx, gyy], -1).reshape(h * w, 2))
        anchors = torch.cat(anchors, 0)
        valid = ((anchors > self.eps) & (anchors < 1 - self.eps)).all(-1, keepdim=True)
        logit = torch.log(anchors / (1 - anchors))
        return torch.where(valid, logit, torch.inf)

    def forward(self, feats):
        """feats: NCHW maps of ``feat_channels`` -> the output dict."""
        if self.training:
            raise NotImplementedError("RT-DETR training is not ported; put the model in "
                                      "eval mode")
        proj, spatial_shapes = [], []
        for i, feat in enumerate(feats):
            x = getattr(self, f"input_proj_{i}_norm")(getattr(self, f"input_proj_{i}_conv")(feat))
            spatial_shapes.append(tuple(x.shape[-2:]))
            proj.append(x.flatten(2).transpose(1, 2))
        memory = torch.cat(proj, dim=1)  # (B, L, C)

        # Encoder head and the top-k query selection.
        anchors = self._anchors(spatial_shapes, memory.device)
        out_mem = self.enc_output_1(self.enc_output_0(memory))
        enc_logits = self.enc_score_head(out_mem)
        enc_coord_unact = self.enc_bbox_head(out_mem) + anchors[None]  # float32
        _, topk_ind = topk(enc_logits.amax(-1), self.num_queries)
        ref_points_unact = select_rows(enc_coord_unact, topk_ind)
        enc_topk_points = torch.sigmoid(ref_points_unact)
        enc_topk_logits = select_rows(enc_logits, topk_ind)
        output = select_rows(out_mem, topk_ind)

        # Decoder with iterative refinement and sigma heads. The float32
        # reference points enter the layers' linears in the memory's dtype.
        logits, points, sigmas = [], [], []
        ref_points = enc_topk_points
        for i in range(self.num_decoder_layers):
            query_pos = self.query_pos_head(ref_points.to(memory.dtype))
            output = getattr(self, f"decoder_layer_{i}")(output, ref_points, memory,
                                                          spatial_shapes, query_pos)
            delta = getattr(self, f"dec_bbox_head_{i}")(output)
            ref_points = torch.sigmoid(delta + inverse_sigmoid(ref_points))
            logits.append(getattr(self, f"dec_score_head_{i}")(output))
            points.append(ref_points)
            sigmas.append(getattr(self, f"sigma_embed_{i}")(output).repeat(1, 1, 2))

        out = {"pred_logits": to_loss_dtype(logits[-1]),
               "pred_points": to_loss_dtype(points[-1]),
               "pred_sigmas": to_loss_dtype(sigmas[-1])}
        if self.aux_loss:
            out["aux_outputs"] = [
                {"pred_logits": to_loss_dtype(logits[i]), "pred_points": to_loss_dtype(points[i]),
                 "pred_sigmas": to_loss_dtype(sigmas[i])}
                for i in range(self.num_decoder_layers - 1)
            ] + [{"pred_logits": to_loss_dtype(enc_topk_logits),
                  "pred_points": to_loss_dtype(enc_topk_points)}]
        return out
