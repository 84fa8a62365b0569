"""RT-DETR, the R2 landmarker (and, with ``box_dim = 4``, the COCO box
detector): a PResNet, MobileNetV3 or GhostNetV2 backbone -> HybridEncoder ->
RTDETRTransformer (counterpart of models/rtdetr.py).

``build_rtdetr_model`` builds one from a seed for evaluation and
``build_rtdetr_train_model`` one to train (float32 parameters, training
mode; ``train.steps.make_train_step``); built inside
``ops.quantize.quantized_inference`` it is the int8 deployment model (the
PResNet and encoder ``ConvNorm`` convolutions and the AIFI FFN int8, the
rest float): build it in float32, calibrate it with
``utils.calibrate.calibrate_act_scales`` and evaluate it with
``make_eval_step(compute_dtype=torch.bfloat16, quant=...)``.
``convert_params_to_deploy`` folds the RepVgg branches of a state dict into
the ``deploy=True`` model's fused convolutions.
"""
from __future__ import annotations

import collections
import dataclasses
from typing import Sequence

import torch
from torch import nn

from ..ops.quantize import quantization_active
from .ghostnetv2 import GhostNetV2
from .hybrid_encoder import HybridEncoder, fuse_repvgg_params
from .mobilenetv3 import MobileNetV3
from .presnet import PResNet
from .rtdetr_decoder import RTDETRTransformer


@dataclasses.dataclass(frozen=True)
class RTDETRConfig:
    """The JAX ``RTDETRConfig`` (the rtdetr_r50vd speed config surface) less
    its ``dtype``, which ``build_rtdetr_model`` takes. ``box_dim = 2`` gives
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
    """``csp_blocks``: the RepVGG blocks in each of the encoder's FPN and PAN
    CSPRepLayers, upstream's ``round(3 * depth_mult)`` (3 in its published
    configs); 1, as the JAX package builds, whose fields ``RTDETRConfig``
    keeps."""

    def __init__(self, config: RTDETRConfig = RTDETRConfig(),
                 generator: torch.Generator | None = None, csp_blocks: int = 1):
        super().__init__()
        self.config = cfg = config
        g = generator
        if cfg.backbone.startswith("mobilenetv3"):
            self.backbone = MobileNetV3(cfg.backbone.split("_")[-1], generator=g)
        elif cfg.backbone == "ghostnetv2":
            self.backbone = GhostNetV2(generator=g)
        else:
            self.backbone = PResNet(cfg.depth, cfg.variant, return_idx=cfg.return_idx,
                                    freeze_norm=cfg.freeze_norm, generator=g)
        self.encoder = HybridEncoder(
            in_channels=tuple(self.backbone.out_channels), hidden_dim=cfg.hidden_dim,
            nhead=cfg.nhead, dim_feedforward=cfg.dim_feedforward, dropout=cfg.dropout,
            expansion=cfg.expansion, deploy=cfg.deploy, generator=g, num_blocks=csp_blocks)
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


def convert_params_to_deploy(state_dict: dict) -> dict:
    """The state dict of a two-branch RT-DETR with every ``RepVggBlock``'s
    branches folded (``fuse_repvgg_params``, its BN running statistics
    included) into the ``conv_fused`` weight and bias that
    ``RTDETRConfig(deploy=True)`` expects. A RepVgg block is a module whose
    only children are ``conv1`` and ``conv2``, each a conv + norm (a
    ``CSPRepLayer`` also has ``conv1``/``conv2``, beside its bottlenecks)."""
    children = collections.defaultdict(set)  # module path -> names of its children
    for key in state_dict:
        parts = key.split(".")
        for i in range(len(parts) - 1):
            children[".".join(parts[:i])].add(parts[i])
    blocks = [f"{p}." for p, c in children.items()
              if c == {"conv1", "conv2"} and f"{p}.conv1.conv.weight" in state_dict]
    out = {k: v for k, v in state_dict.items() if not any(k.startswith(p) for p in blocks)}
    for p in blocks:
        out.update(fuse_repvgg_params(state_dict, p))
    return out


def build_rtdetr_model(config: RTDETRConfig = RTDETRConfig(), seed: int = 0, device="cuda",
                       dtype=torch.float32) -> RTDETR:
    """An RT-DETR with weights drawn from ``seed`` (on the CPU, so the
    weights do not depend on the device), moved to ``device``/``dtype`` and
    put in eval mode. The model runs on the card unless ``device="cpu"`` is
    asked for; without a card the default raises, as ``Module.to("cuda")``
    does. Built inside ``quantized_inference`` it is int8, in float32 only
    (its weights are quantized from float32; run it in bf16 under
    autocast)."""
    if quantization_active() and dtype != torch.float32:
        raise ValueError("an int8 model keeps float32 weights; build it in float32 and "
                         "evaluate it with make_eval_step(compute_dtype=torch.bfloat16)")
    generator = torch.Generator().manual_seed(seed)
    model = RTDETR(config, generator)
    return model.to(device=device, dtype=dtype).eval()


def build_rtdetr_train_model(config: RTDETRConfig = RTDETRConfig(), seed: int = 0,
                             device="cuda") -> RTDETR:
    """An RT-DETR to train: the weights of ``build_rtdetr_model(config,
    seed)`` in float32 (run it in bf16 with ``make_train_step(...,
    compute_dtype=torch.bfloat16)``), in training mode, on the card unless
    ``device="cpu"`` is asked for."""
    return build_rtdetr_model(config, seed, device).train()
