"""RT-DETR, the R2 landmarker (and, with ``box_dim = 4``, the COCO box
detector): a PResNet, MobileNetV3 or GhostNetV2 backbone -> HybridEncoder ->
RTDETRTransformer (counterpart of models/rtdetr.py).

The reference holds the float model on one device with the PResNet trunk.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from .hybrid_encoder import HybridEncoder
from .presnet import PResNet
from .rtdetr_decoder import RTDETRTransformer


@dataclasses.dataclass(frozen=True)
class RTDETRConfig:
    """The JAX ``RTDETRConfig`` (the rtdetr_r50vd speed config surface) less
    its ``dtype``. ``box_dim = 2`` gives
    the speed landmarker's point queries, ``box_dim = 4`` the detection
    task's cxcywh box queries."""

    backbone: str = "presnet"  # presnet | mobilenetv3_large | mobilenetv3_small | ghostnetv2
    depth: int = 50
    variant: str = "d"
    return_idx: Sequence[int] = (1, 2, 3)
    freeze_norm: bool = True
    num_classes: int = 11
    hidden_dim: int = 256
    num_queries: int = 30
    num_decoder_layers: int = 3
    nhead: int = 8
    dim_feedforward: int = 1024
    expansion: float = 1.0
    dropout: float = 0.0
    learnt_init_query: bool = False
    box_dim: int = 2  # 2 = speed landmarker, 4 = COCO detection
    num_denoising: int = 0
    label_noise_ratio: float = 0.5
    box_noise_scale: float = 1.0
    deploy: bool = False


class RTDETR(nn.Module):
    def __init__(self, config: RTDETRConfig = RTDETRConfig(),
                 generator: torch.Generator | None = None):
        super().__init__()
        self.config = cfg = config
        g = generator
        if cfg.backbone != "presnet":
            raise ValueError(f"the reference copy holds the PResNet trunk only, not {cfg.backbone}")
        self.backbone = PResNet(cfg.depth, cfg.variant, return_idx=cfg.return_idx,
                                freeze_norm=cfg.freeze_norm, generator=g)
        self.encoder = HybridEncoder(
            in_channels=tuple(self.backbone.out_channels), hidden_dim=cfg.hidden_dim,
            nhead=cfg.nhead, dim_feedforward=cfg.dim_feedforward, dropout=cfg.dropout,
            expansion=cfg.expansion, deploy=cfg.deploy, generator=g)
        self.decoder = RTDETRTransformer(
            num_classes=cfg.num_classes, hidden_dim=cfg.hidden_dim, num_queries=cfg.num_queries,
            feat_channels=(cfg.hidden_dim,) * len(cfg.return_idx), num_levels=len(cfg.return_idx),
            nhead=cfg.nhead, num_decoder_layers=cfg.num_decoder_layers,
            dim_feedforward=cfg.dim_feedforward, dropout=cfg.dropout,
            learnt_init_query=cfg.learnt_init_query, box_dim=cfg.box_dim,
            num_denoising=cfg.num_denoising, label_noise_ratio=cfg.label_noise_ratio,
            box_noise_scale=cfg.box_noise_scale, generator=g)

    def forward(self, images, targets=None, generator=None):
        """images: (B, H, W, 3) normalised crops in the model's dtype.

        In training with ``num_denoising > 0`` the decoder builds its CDN
        groups from ``targets`` {"labels" (B, T), "points" (B, T, box_dim)
        normalised}, which it then requires, drawing their noise from
        ``generator``, a ``torch.Generator`` on the images' device (the
        train step passes its own; None takes the device's default
        generator). Otherwise both are ignored."""
        feats = self.encoder(self.backbone(images.permute(0, 3, 1, 2)))
        return self.decoder(feats, targets, generator)
