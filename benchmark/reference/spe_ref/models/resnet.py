"""ResNet-18/34/50/101 trunks and the stride-8 fusion backbone (counterpart
of models/resnet.py), NCHW inside.

Module names follow the JAX package (``conv1``/``bn1``/``layer{s}_{b}``,
``downsample_conv``/``downsample_bn``), so the converter in
``utils/checkpoint_convert.py`` maps parameters one to one. As in JAX,
block 0 of every stage has a downsample branch (``downsample=(b == 0)``),
resnet18's and resnet34's ``layer1_0`` too, where torchvision has none.
The JAX stem's space-to-depth form is a TPU rewrite of the plain 7x7
stride-2 pad-3 convolution and stores that convolution's kernel; here it is
that convolution. ``norm`` picks every block's norm (``layers.norm_layer``).
"""
from __future__ import annotations

import torch
from torch import nn

from ..ops.image_warp import upsample_bilinear_align_corners
from .layers import conv2d, norm_layer


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes, planes, stride=1, downsample=False, norm="frozen_bn",
                 generator=None):
        super().__init__()
        self.conv1 = conv2d(inplanes, planes, 3, stride=stride, padding=1, bias=False,
                            generator=generator)
        self.bn1 = norm_layer(norm, planes)
        self.conv2 = conv2d(planes, planes, 3, padding=1, bias=False, generator=generator)
        self.bn2 = norm_layer(norm, planes)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = conv2d(inplanes, planes, 1, stride=stride, bias=False,
                                          generator=generator)
            self.downsample_bn = norm_layer(norm, planes)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = self.bn2(self.conv2(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return torch.relu(out + identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes, planes, stride=1, downsample=False, norm="frozen_bn",
                 generator=None):
        super().__init__()
        wide = planes * self.expansion
        self.conv1 = conv2d(inplanes, planes, 1, bias=False, generator=generator)
        self.bn1 = norm_layer(norm, planes)
        self.conv2 = conv2d(planes, planes, 3, stride=stride, padding=1, bias=False,
                            generator=generator)
        self.bn2 = norm_layer(norm, planes)
        self.conv3 = conv2d(planes, wide, 1, bias=False, generator=generator)
        self.bn3 = norm_layer(norm, wide)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = conv2d(inplanes, wide, 1, stride=stride, bias=False,
                                          generator=generator)
            self.downsample_bn = norm_layer(norm, wide)

    def forward(self, x):
        out = torch.relu(self.bn1(self.conv1(x)))
        out = torch.relu(self.bn2(self.conv2(out)))
        out = self.bn3(self.conv3(out))
        identity = self.downsample_bn(self.downsample_conv(x)) if self.downsample else x
        return torch.relu(out + identity)


_ARCHS = {
    "resnet18": (BasicBlock, (2, 2, 2, 2)),
    "resnet34": (BasicBlock, (3, 4, 6, 3)),
    "resnet50": (Bottleneck, (3, 4, 6, 3)),
    "resnet101": (Bottleneck, (3, 4, 23, 3)),
}


class ResNet(nn.Module):
    """torchvision-style ResNet trunk returning the requested layer taps
    (e.g. (2, 3): the stride-8 and stride-16 maps)."""

    def __init__(self, arch="resnet50", taps=(3,), norm="frozen_bn",
                 generator=None):
        super().__init__()
        block, layout = _ARCHS[arch]
        self.taps = tuple(taps)
        self.conv1 = conv2d(3, 64, 7, stride=2, padding=3, bias=False, generator=generator)
        self.bn1 = norm_layer(norm, 64)
        self.maxpool = nn.MaxPool2d(3, stride=2, padding=1)
        inplanes, planes = 64, 64
        self.stages = []
        for stage in range(max(self.taps)):
            names = []
            for b in range(layout[stage]):
                stride = 2 if (stage > 0 and b == 0) else 1
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, block(inplanes, planes, stride, b == 0, norm,
                                            generator))
                inplanes = planes * block.expansion
                names.append(name)
            self.stages.append(names)
            planes *= 2

    @staticmethod
    def tap_channels(arch: str, tap: int) -> int:
        return 64 * 2 ** (tap - 1) * _ARCHS[arch][0].expansion

    def forward(self, x):
        x = self.maxpool(torch.relu(self.bn1(self.conv1(x))))
        outputs = {}
        for stage, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            outputs[stage + 1] = x
        return [outputs[t] for t in self.taps]


class Backbone8s(nn.Module):
    """ResNet-50 stride-8 fusion backbone: layer2 (s8, 512ch) + bilinearly
    (align_corners) 2x-upsampled layer3 (s16, 1024ch), lateral 1x1 / 3x3
    convs to 256ch each, concatenated, 3x3 output conv -> 512ch at s8."""

    num_channels = 512

    def __init__(self, norm="frozen_bn", generator=None):
        super().__init__()
        g = generator
        self.body = ResNet("resnet50", (2, 3), norm, g)
        self.s8_latern = conv2d(512, 256, 1, bias=False, generator=g)
        self.s16_latern = conv2d(1024, 256, 3, padding=1, bias=False, generator=g)
        self.output_conv = conv2d(512, 512, 3, padding=1, generator=g)

    def forward(self, x):
        xs8, xs16 = self.body(x)
        up = upsample_bilinear_align_corners(xs16, 2)
        l8 = self.s8_latern(xs8)
        l16 = self.s16_latern(up)
        return [self.output_conv(torch.cat([l8, l16], dim=1))]
