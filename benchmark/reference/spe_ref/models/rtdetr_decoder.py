"""RT-DETR point-query decoder with per-layer Gaussian sigma heads
(counterpart of models/rtdetr_decoder.py).

* per-pixel (x, y) anchors in logit space over every level (with
  ``box_dim = 4``, the detection task's cxcywh boxes, a level's anchors
  carry wh = 0.05 * 2^level); anchors
  outside (eps, 1 - eps) get the logit +inf, as in JAX (which computes the
  valid mask and, unlike the upstream RT-DETR, never multiplies the memory
  by it);
* an encoder head scores every token; the top ``num_queries`` tokens give
  the initial reference points and the query features
  (``ops.topk``: ties to the lowest index, exact row gathers), or with
  ``learnt_init_query`` a learnt query table (``tgt_embed``) gives the
  features;
* decoder layers: query self-attention, multi-scale deformable
  cross-attention, FFN, with iterative inverse-sigmoid point refinement;
* a sigma head MLP(h, h, 1, 3) per layer, broadcast to (x, y);
* outputs ``pred_logits`` / ``pred_points`` / ``pred_sigmas`` and
  ``aux_outputs`` (every earlier layer, then the encoder's top-k without
  sigmas), in the loss dtype.

In training (``module.training``) the gradient paths are JAX's: the
initial reference points and the selected query features are detached
(the features not with ``learnt_init_query``), each layer takes detached
reference points, and a layer's output point is refined from the previous
layer's undetached point, so the gradient reaches the previous point head;
the encoder's top-k outputs keep theirs through the gather. With
``num_denoising > 0`` a training call needs ``targets``: CDN groups
(``models.denoising``, embedded by ``denoising_class_embed``) go ahead of
the matching queries under a block self-attention mask, and the outputs
gain ``dn_aux_outputs`` (every layer, with sigmas) and ``dn_meta``.

With ``box_dim = 4`` the point heads regress cxcywh boxes, the deformable
sampling offsets scale with each reference box's size, and the outputs keep
their names (``pred_points`` holds the boxes). Module names follow the JAX
package.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from ..ops.deform_attn import deformable_attention_core
from ..ops.precision import to_loss_dtype
from ..ops.topk import select_rows, topk
from . import denoising
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
        """query (B, Q, C); reference_points (B, Q, 2) points or (B, Q, 4)
        cxcywh boxes in [0, 1]; value (B, L, C); spatial_shapes [(h, w)] per
        level."""
        B, Q, _ = query.shape
        L = value.shape[1]
        H, Lv, P = self.num_heads, self.num_levels, self.num_points
        v = self.value_proj(value).reshape(B, L, H, -1)
        offsets = self.sampling_offsets(query).reshape(B, Q, H, Lv, P, 2)
        attw = torch.softmax(self.attention_weights(query).reshape(B, Q, H, Lv * P), dim=-1)
        attw = attw.reshape(B, Q, H, Lv, P)
        ref = reference_points[:, :, None, None, None, :]
        if reference_points.shape[-1] == 2:
            normalizer = torch.tensor([[w, h] for h, w in spatial_shapes], dtype=torch.float32,
                                      device=query.device).reshape(1, 1, 1, Lv, 1, 2)
            locations = ref + offsets / normalizer
        else:  # boxes: the offsets scale with the box's size
            locations = ref[..., :2] + offsets / P * ref[..., 2:] * 0.5
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

    def forward(self, tgt, reference_points, memory, spatial_shapes, query_pos, attn_mask=None):
        qk = tgt + query_pos
        tgt = self.norm1(tgt + self.drop(self.self_attn(qk, qk, tgt, attn_mask)))
        ca = self.cross_attn(tgt + query_pos, reference_points, memory, spatial_shapes)
        tgt = self.norm2(tgt + self.drop(ca))
        ff = self.linear2(self.drop(self.act(self.linear1(tgt))))
        return self.norm3(tgt + self.drop(ff))


class RTDETRTransformer(nn.Module):
    def __init__(self, num_classes=11, hidden_dim=256, num_queries=30,
                 feat_channels=(256, 256, 256), num_levels=3, num_decoder_points=4, nhead=8,
                 num_decoder_layers=3, dim_feedforward=1024, dropout=0.0, activation="relu",
                 learnt_init_query=False, box_dim=2, eps=1e-2, aux_loss=True, num_denoising=0,
                 label_noise_ratio=0.5, box_noise_scale=1.0, generator=None):
        super().__init__()
        if box_dim not in (2, 4):
            raise ValueError(f"box_dim is 2 (points) or 4 (cxcywh boxes), not {box_dim}")
        g = generator
        h = hidden_dim
        self.num_queries, self.num_decoder_layers = num_queries, num_decoder_layers
        self.num_classes, self.eps, self.aux_loss = num_classes, eps, aux_loss
        self.box_dim = box_dim
        self.num_denoising = num_denoising
        self.label_noise_ratio, self.box_noise_scale = label_noise_ratio, box_noise_scale
        for i, cin in enumerate(feat_channels):
            self.add_module(f"input_proj_{i}_conv", conv2d(cin, h, 1, bias=False, generator=g))
            self.add_module(f"input_proj_{i}_norm", norm_layer("bn", h))
        self.enc_output_0 = linear(h, h, g)
        self.enc_output_1 = nn.LayerNorm(h, eps=1e-5)
        self.enc_score_head = linear(h, num_classes + 1, g)
        self.enc_bbox_head = MLP(h, h, box_dim, 3, generator=g)
        self.query_pos_head = MLP(box_dim, 2 * h, h, 2, generator=g)
        if learnt_init_query:
            self.tgt_embed = nn.Embedding(num_queries, h)
            nn.init.xavier_uniform_(self.tgt_embed.weight, generator=g)
        else:
            self.tgt_embed = None
        if num_denoising > 0:
            self.denoising_class_embed = nn.Embedding(num_classes + 1, h)
            with torch.no_grad():
                self.denoising_class_embed.weight.normal_(generator=g)
        for i in range(num_decoder_layers):
            self.add_module(f"decoder_layer_{i}", RTDecoderLayer(
                h, nhead, dim_feedforward, dropout, activation, num_levels,
                num_decoder_points, g))
            self.add_module(f"dec_bbox_head_{i}", MLP(h, h, box_dim, 3, generator=g))
            self.add_module(f"dec_score_head_{i}", linear(h, num_classes + 1, g))
            self.add_module(f"sigma_embed_{i}", MLP(h, h, 1, 3, generator=g))
        with torch.no_grad():
            for i in ["enc_score_head"] + [f"dec_score_head_{i}"
                                           for i in range(num_decoder_layers)]:
                getattr(self, i).bias.fill_(_bias_init_with_prob())

    def _anchors(self, spatial_shapes, device, grid_size=0.05):
        """(L, box_dim) anchor logits, +inf where a coordinate lies outside
        (eps, 1 - eps)."""
        anchors = []
        for lvl, (h, w) in enumerate(spatial_shapes):
            gx = (torch.arange(w, dtype=torch.float32, device=device) + 0.5) / w
            gy = (torch.arange(h, dtype=torch.float32, device=device) + 0.5) / h
            gyy, gxx = torch.meshgrid(gy, gx, indexing="ij")
            xy = torch.stack([gxx, gyy], -1).reshape(h * w, 2)
            if self.box_dim == 4:
                xy = torch.cat([xy, xy.new_full((h * w, 2), grid_size * 2.0 ** lvl)], -1)
            anchors.append(xy)
        anchors = torch.cat(anchors, 0)
        valid = ((anchors > self.eps) & (anchors < 1 - self.eps)).all(-1, keepdim=True)
        logit = torch.log(anchors / (1 - anchors))
        return torch.where(valid, logit, torch.inf)

    def forward(self, feats, targets=None, generator=None):
        """feats: NCHW maps of ``feat_channels`` -> the output dict.

        ``targets`` {"labels" (B, T), "points" (B, T, box_dim) normalised} and
        ``generator`` (the ``torch.Generator`` the CDN draws come from; None:
        the device's default) are read only in training with
        ``num_denoising > 0``, where ``targets`` is required."""
        train = self.training
        dn = train and self.num_denoising > 0
        if dn and targets is None:
            raise ValueError("num_denoising > 0 requires `targets` in training (labels + "
                             "points): pass them through the train step or set num_denoising: 0")
        proj, spatial_shapes = [], []
        for i, feat in enumerate(feats):
            x = getattr(self, f"input_proj_{i}_norm")(getattr(self, f"input_proj_{i}_conv")(feat))
            spatial_shapes.append(tuple(x.shape[-2:]))
            proj.append(x.flatten(2).transpose(1, 2))
        memory = torch.cat(proj, dim=1)  # (B, L, C)
        B = memory.shape[0]

        # Encoder head and the top-k query selection.
        anchors = self._anchors(spatial_shapes, memory.device)
        out_mem = self.enc_output_1(self.enc_output_0(memory))
        enc_logits = self.enc_score_head(out_mem)
        enc_coord_unact = self.enc_bbox_head(out_mem) + anchors[None]  # float32
        _, topk_ind = topk(enc_logits.amax(-1), self.num_queries)
        coord_unact = select_rows(enc_coord_unact, topk_ind)
        ref_points_unact = coord_unact.detach()
        enc_topk_points = torch.sigmoid(coord_unact)
        enc_topk_logits = select_rows(enc_logits, topk_ind)
        if self.tgt_embed is not None:
            target = self.tgt_embed.weight[None].expand(B, -1, -1).to(memory.dtype)
        else:
            target = select_rows(out_mem, topk_ind).detach()

        # CDN groups ahead of the matching queries (training only).
        attn_mask, dn_meta = None, None
        if dn:
            dn_embed, dn_points_unact, attn_mask, dn_meta = denoising.build_denoising_group(
                generator, targets["labels"], targets["points"].to(torch.float32),
                self.denoising_class_embed.weight, self.num_queries, self.num_classes,
                self.num_denoising, self.label_noise_ratio, self.box_noise_scale)
            target = torch.cat([dn_embed.to(target.dtype), target], dim=1)
            ref_points_unact = torch.cat([dn_points_unact.detach().to(ref_points_unact.dtype),
                                          ref_points_unact], dim=1)

        # Decoder with iterative refinement and sigma heads. The float32
        # reference points enter the layers' linears in the memory's dtype.
        # Each layer takes detached reference points in training; the output
        # point of a layer after the first refines the previous layer's
        # undetached one (the same values; in eval the same function).
        logits, points, sigmas = [], [], []
        ref_points_detach = torch.sigmoid(ref_points_unact)
        ref_points = None
        output = target
        for i in range(self.num_decoder_layers):
            query_pos = self.query_pos_head(ref_points_detach.to(memory.dtype))
            output = getattr(self, f"decoder_layer_{i}")(output, ref_points_detach, memory,
                                                          spatial_shapes, query_pos, attn_mask)
            delta = getattr(self, f"dec_bbox_head_{i}")(output)
            inter_ref = torch.sigmoid(delta + inverse_sigmoid(ref_points_detach))
            logits.append(getattr(self, f"dec_score_head_{i}")(output))
            points.append(inter_ref if i == 0 or not train
                          else torch.sigmoid(delta + inverse_sigmoid(ref_points)))
            sigmas.append(getattr(self, f"sigma_embed_{i}")(output).repeat(1, 1, 2))
            ref_points = inter_ref
            ref_points_detach = inter_ref.detach() if train else inter_ref

        def level(i, lo, hi):
            return {"pred_logits": to_loss_dtype(logits[i][:, lo:hi]),
                    "pred_points": to_loss_dtype(points[i][:, lo:hi]),
                    "pred_sigmas": to_loss_dtype(sigmas[i][:, lo:hi])}

        n_dn = dn_meta["dn_num_split"][0] if dn else 0
        out = level(-1, n_dn, None)
        if dn:
            out["dn_aux_outputs"] = [level(i, 0, n_dn) for i in range(self.num_decoder_layers)]
            out["dn_meta"] = dn_meta
        if self.aux_loss:
            out["aux_outputs"] = [level(i, n_dn, None)
                                  for i in range(self.num_decoder_layers - 1)] + [
                {"pred_logits": to_loss_dtype(enc_topk_logits),
                 "pred_points": to_loss_dtype(enc_topk_points)}]
        return out
