"""DETR keypoint-set model, the R1 flagship (counterpart of models/detr.py).

Backbone feature map -> 1x1 input projection to hidden_dim -> transformer
with learned query embeddings -> two heads on every decoder layer:
``cls_embed`` (Linear to num_keypoints + 1 classes) and ``point_embed``
(3-layer MLP + sigmoid -> normalised (x, y)). Outputs 'pred_logits'
(B, Q, 12), 'pred_points' (B, Q, 2) and, with ``aux_loss``, 'aux_outputs'
for every earlier decoder layer, all in the loss dtype (float32 for a bf16
or float32 model, float64 for a float64 one).

``module.training`` stands for the JAX model's ``train=True``: dropout is
active in training mode and a ``bn`` backbone normalises with batch
statistics. ``build_detr_model`` builds an eval model in one dtype;
``build_detr_train_model`` keeps the parameters float32 and leaves the
compute dtype to ``torch.autocast`` (Flax's ``dtype=bf16`` means bf16
compute on float32 parameters). The reference computes every attention
core in plain math, so ``use_flash_attention`` changes nothing here.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from ..ops.precision import to_loss_dtype
from .layers import MLP, conv2d, linear
from .position_encoding import PositionEmbeddingLearned, PositionEmbeddingSine
from .resnet import Backbone8s, ResNet
from .transformer import Transformer


@dataclasses.dataclass(frozen=True)
class DETRConfig:
    """The JAX ``DETRConfig`` (the R1 CLI surface) less its ``dtype``,
    which ``build_detr_model`` takes."""

    backbone: str = "resnet50s8"  # resnet18/34/50/101 (layer3 tap) or resnet50s8
    bn: str = "frozen_bn"  # frozen_bn | bn | sync_bn | group_bn
    dilation: bool = False  # accepted and unused, as in JAX
    position_embedding: str = "sine"  # sine | learned
    hidden_dim: int = 256
    nheads: int = 8
    enc_layers: int = 6
    dec_layers: int = 6
    dim_feedforward: int = 2048
    dropout: float = 0.1
    pre_norm: bool = False
    num_queries: int = 20
    num_keypoints: int = 11
    aux_loss: bool = True
    use_flash_attention: bool = False  # encoder self-attention through K5
    remat: bool = False  # recompute encoder layers in the backward pass


class DETRKeypointModel(nn.Module):
    def __init__(self, config: DETRConfig = DETRConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = cfg = config
        g = generator
        if cfg.backbone == "resnet50s8":
            self.backbone = Backbone8s(cfg.bn, g)
            channels = Backbone8s.num_channels
        else:
            self.backbone = ResNet(cfg.backbone, (3,), cfg.bn, g)
            channels = ResNet.tap_channels(cfg.backbone, 3)
        self.input_proj = conv2d(channels, cfg.hidden_dim, 1, generator=g)
        if cfg.position_embedding == "sine":
            self.pos_enc = PositionEmbeddingSine(num_pos_feats=cfg.hidden_dim // 2)
        else:
            self.pos_enc = PositionEmbeddingLearned(cfg.hidden_dim, g)
        self.query_embed = nn.Parameter(torch.empty(cfg.num_queries, cfg.hidden_dim))
        with torch.no_grad():
            self.query_embed.normal_(0.0, 1.0, generator=g)
        self.transformer = Transformer(
            d_model=cfg.hidden_dim, nhead=cfg.nheads,
            num_encoder_layers=cfg.enc_layers, num_decoder_layers=cfg.dec_layers,
            dim_feedforward=cfg.dim_feedforward, dropout=cfg.dropout, generator=g,
            normalize_before=cfg.pre_norm, remat=cfg.remat)
        self.cls_embed = linear(cfg.hidden_dim, cfg.num_keypoints + 1, g)
        self.point_embed = MLP(cfg.hidden_dim, cfg.hidden_dim, 2, 3, generator=g)

    def forward(self, images):
        """images: (B, H, W, 3) normalised crops in the model's dtype."""
        x = images.permute(0, 3, 1, 2)  # NCHW for the convolutions
        src = self.input_proj(self.backbone(x)[-1])  # (B, C, h, w)
        _, _, h, w = src.shape
        pos = self.pos_enc(h, w, device=src.device, dtype=src.dtype)
        hs, _ = self.transformer(src.flatten(2).transpose(1, 2), self.query_embed,
                                 pos.reshape(h * w, -1))
        logits = to_loss_dtype(self.cls_embed(hs))  # (L, B, Q, 12)
        points = to_loss_dtype(torch.sigmoid(self.point_embed(hs)))  # (L, B, Q, 2)
        out = {"pred_logits": logits[-1], "pred_points": points[-1]}
        if self.config.aux_loss:
            out["aux_outputs"] = [{"pred_logits": logits[i], "pred_points": points[i]}
                                  for i in range(logits.shape[0] - 1)]
        return out
