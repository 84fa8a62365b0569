"""Classification sanity-check task (counterpart of models/classification.py):
``Classification`` = the CIFAR-style ``MResNet`` trunk and ``ClassHead``
(global mean, then a linear layer).

The input is channels-last (N, 32, 32, 3), as in JAX, and is permuted to
NCHW once at entry. The norms are the port's ``bn`` (``nn.BatchNorm2d``
with the JAX ``TorchBatchNorm`` semantics), and the submodules carry the
flax names (``stem``, ``stem_bn``, ``stage{s}_{b}`` with ``conv1`` /
``bn1`` / ``conv2`` / ``bn2`` / ``short`` / ``short_bn``, ``head.fc``), so
JAX weights map by path (``utils.checkpoint_convert.
flax_classification_to_state_dict``). ``module.training`` stands for the
JAX model's ``train=True``.
"""
from __future__ import annotations

import torch
from torch import nn

from .layers import conv2d, linear, norm_layer


class MResNetBlock(nn.Module):
    def __init__(self, inplanes, planes, stride=1, generator=None):
        super().__init__()
        g = generator
        self.conv1 = conv2d(inplanes, planes, 3, stride, 1, bias=False, generator=g)
        self.bn1 = norm_layer("bn", planes)
        self.conv2 = conv2d(planes, planes, 3, 1, 1, bias=False, generator=g)
        self.bn2 = norm_layer("bn", planes)
        self.project = stride != 1 or inplanes != planes
        if self.project:
            # flax's 1x1 "SAME" conv at stride 2 on an even side pads nothing
            self.short = conv2d(inplanes, planes, 1, stride, bias=False, generator=g)
            self.short_bn = norm_layer("bn", planes)

    def forward(self, x):
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        identity = self.short_bn(self.short(x)) if self.project else x
        return torch.relu(y + identity)


class MResNet(nn.Module):
    """CIFAR-style small resnet trunk: a 16-channel stem, then stages of
    ``layers`` blocks with planes 16, 32, 64, stride 2 at each stage's first
    block past stage 0."""

    def __init__(self, layers=(2, 2, 2), generator=None):
        super().__init__()
        self.stem = conv2d(3, 16, 3, 1, 1, bias=False, generator=generator)
        self.stem_bn = norm_layer("bn", 16)
        self.blocks = []
        inplanes = planes = 16
        for stage, count in enumerate(layers):
            for b in range(count):
                name = f"stage{stage}_{b}"
                self.add_module(name, MResNetBlock(
                    inplanes, planes, 2 if (b == 0 and stage > 0) else 1, generator))
                self.blocks.append(name)
                inplanes = planes
            planes *= 2
        self.num_channels = inplanes

    def forward(self, x):
        """x: (N, C, H, W) -> (N, 64, H / 4, W / 4)."""
        x = torch.relu(self.stem_bn(self.stem(x)))
        for name in self.blocks:
            x = getattr(self, name)(x)
        return x


class ClassHead(nn.Module):
    def __init__(self, in_channels, num_classes=10, generator=None):
        super().__init__()
        self.fc = linear(in_channels, num_classes, generator)

    def forward(self, x):
        return self.fc(x.mean(dim=(2, 3)))


class Classification(nn.Module):
    def __init__(self, num_classes=10, generator=None):
        super().__init__()
        self.backbone = MResNet(generator=generator)
        self.head = ClassHead(self.backbone.num_channels, num_classes, generator)

    def forward(self, images):
        """images: (N, H, W, 3) normalised, channels last -> (N, num_classes)
        logits."""
        return self.head(self.backbone(images.permute(0, 3, 1, 2)))


def build_classification_model(num_classes: int = 10, seed: int = 0, device="cuda",
                               dtype=torch.float32) -> Classification:
    """A ``Classification`` model with weights drawn from ``seed`` (on the
    CPU, so they do not depend on the device), on ``device`` in ``dtype``,
    in training mode. The model runs on the card unless ``device="cpu"`` is
    asked for; without a card the default raises."""
    model = Classification(num_classes, torch.Generator().manual_seed(seed))
    return model.to(device=device, dtype=dtype).train()
