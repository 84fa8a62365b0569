"""MobileNetV3 Large / Small, the reference's custom variant (counterpart of
models/mobilenetv3.py; R2/nn/backbone/mobilenetv3.py), NCHW inside:

* every block ends ``act(project + skip)``, with a parameterised skip when
  the shape changes (1x1 conv + BN at stride 1; depthwise 3x3 stride 2 + BN,
  then 1x1 conv with bias + BN when the channels change, at stride 2);
* squeeze-excite (conv-BN-relu / conv / hardsigmoid, reduction
  max(exp // 4, 8), no conv biases) on the expanded depthwise output;
* the expand conv exists even where exp == in (block 0);
* levels 0 and 1 come from a side branch that resizes the stem output to
  input / 4 (bilinear, no antialias, as torch's ``F.interpolate``) and
  applies two stride-2 3x3 convs (16 -> 128 -> 256; with BN + hardswish in
  Large, raw in Small); level 2 is the block tail through a 1x1 512 conv.

Every norm is a trainable ``nn.BatchNorm2d`` (the JAX ``apply_norm("bn")``).
Module names follow the JAX package (``conv1/bn1``, ``Conv1/Bn1``,
``bneck_{i}``, ``skip_{j}``, ``se_{j}``), so parameters map by path. The
classifier tail is dead in the detection forward and is not built.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image_warp import resize_bilinear_torch
from .layers import conv2d, norm_layer


def hswish(x):
    return x * F.relu6(x + 3.0) / 6.0


def hsigmoid(x):
    return F.relu6(x + 3.0) / 6.0


class SeModule(nn.Module):
    """Squeeze-excite on ``in_size`` channels (R2 mobilenetv3.py:28-42)."""

    def __init__(self, in_size, generator=None):
        super().__init__()
        expand = max(in_size // 4, 8)
        self.se_1 = conv2d(in_size, expand, 1, bias=False, generator=generator)
        self.se_2 = norm_layer("bn", expand)
        self.se_4 = conv2d(expand, in_size, 1, bias=False, generator=generator)

    def forward(self, x):
        s = torch.mean(x, dim=(2, 3), keepdim=True)
        s = self.se_4(torch.relu(self.se_2(self.se_1(s))))
        return x * hsigmoid(s)


class Block(nn.Module):
    """expand 1x1 -> depthwise kxk -> SE on the expanded output -> project
    1x1, plus the always-taken residual; the activation follows the sum
    (R2 mobilenetv3.py:45-121)."""

    def __init__(self, kernel, in_size, expand_size, out_size, use_hs, use_se, stride,
                 generator=None):
        super().__init__()
        g = generator
        self.act = hswish if use_hs else torch.relu
        self.conv1 = conv2d(in_size, expand_size, 1, bias=False, generator=g)
        self.bn1 = norm_layer("bn", expand_size)
        self.conv2 = conv2d(expand_size, expand_size, kernel, stride, kernel // 2,
                            groups=expand_size, bias=False, generator=g)
        self.bn2 = norm_layer("bn", expand_size)
        self.se = SeModule(expand_size, g) if use_se else None
        self.conv3 = conv2d(expand_size, out_size, 1, bias=False, generator=g)
        self.bn3 = norm_layer("bn", out_size)
        self.skip = []
        if stride == 1 and in_size != out_size:
            self.skip_0 = conv2d(in_size, out_size, 1, bias=False, generator=g)
            self.skip_1 = norm_layer("bn", out_size)
            self.skip = ["skip_0", "skip_1"]
        elif stride == 2:
            self.skip_0 = conv2d(in_size, in_size, 3, 2, 1, groups=in_size, bias=False,
                                 generator=g)
            self.skip_1 = norm_layer("bn", in_size)
            self.skip = ["skip_0", "skip_1"]
            if in_size != out_size:
                self.skip_2 = conv2d(in_size, out_size, 1, bias=True, generator=g)
                self.skip_3 = norm_layer("bn", out_size)
                self.skip += ["skip_2", "skip_3"]

    def forward(self, x):
        out = self.act(self.bn1(self.conv1(x)))
        out = self.act(self.bn2(self.conv2(out)))
        if self.se is not None:
            out = self.se(out)
        out = self.bn3(self.conv3(out))
        skip = x
        for name in self.skip:
            skip = getattr(self, name)(skip)
        return self.act(out + skip)


# (kernel, in, expand, out, hswish, se, stride): R2 mobilenetv3.py:148-164
LARGE = [
    (3, 16, 16, 16, 0, 0, 1),
    (3, 16, 64, 24, 0, 0, 2),
    (3, 24, 72, 24, 0, 0, 1),
    (5, 24, 72, 40, 0, 1, 2),
    (5, 40, 120, 40, 0, 1, 1),
    (5, 40, 120, 40, 0, 1, 1),
    (3, 40, 240, 80, 1, 0, 2),
    (3, 80, 200, 80, 1, 0, 1),
    (3, 80, 184, 80, 1, 0, 1),
    (3, 80, 184, 80, 1, 0, 1),
    (3, 80, 480, 112, 1, 1, 1),
    (3, 112, 672, 112, 1, 1, 1),
    (5, 112, 672, 160, 1, 1, 2),
    (5, 160, 672, 160, 1, 1, 1),
    (5, 160, 960, 160, 1, 1, 1),
]

# R2 mobilenetv3.py:248-260
SMALL = [
    (3, 16, 16, 16, 0, 1, 2),
    (3, 16, 72, 24, 0, 0, 2),
    (3, 24, 88, 24, 0, 0, 1),
    (5, 24, 96, 40, 1, 1, 2),
    (5, 40, 240, 40, 1, 1, 1),
    (5, 40, 240, 40, 1, 1, 1),
    (5, 40, 120, 48, 1, 1, 1),
    (5, 48, 144, 48, 1, 1, 1),
    (5, 48, 288, 96, 1, 1, 2),
    (5, 96, 576, 96, 1, 1, 1),
    (5, 96, 576, 96, 1, 1, 1),
]


class MobileNetV3(nn.Module):
    """The reference-variant pyramid [input/8 (128 ch), input/16 (256 ch),
    input/32 (512 ch)] (R2 mobilenetv3.py:208-228 Large, 302-324 Small).
    The reference resizes the branch to (64, 64) for its 256 input; here it
    is input / 4, the same at 256."""

    out_channels = (128, 256, 512)

    def __init__(self, mode: str = "large", generator=None):
        super().__init__()
        if mode not in ("large", "small"):
            raise ValueError(f"MobileNetV3 mode is 'large' or 'small', not {mode!r}")
        g = generator
        self.large = mode == "large"
        self.conv1 = conv2d(3, 16, 3, 2, 1, bias=False, generator=g)
        self.bn1 = norm_layer("bn", 16)
        self.Conv1 = conv2d(16, 128, 3, 2, 1, bias=False, generator=g)
        self.Conv2 = conv2d(128, 256, 3, 2, 1, bias=False, generator=g)
        if self.large:
            self.Bn1 = norm_layer("bn", 128)
            self.Bn2 = norm_layer("bn", 256)
        self.blocks = []
        for i, (k, cin, exp, cout, hs, se, s) in enumerate(LARGE if self.large else SMALL):
            self.add_module(f"bneck_{i}", Block(k, cin, exp, cout, bool(hs), bool(se), s, g))
            self.blocks.append(f"bneck_{i}")
        self.conv2 = conv2d(160 if self.large else 96, 512, 1, bias=False, generator=g)
        self.bn2 = norm_layer("bn", 512)

    def forward(self, x):
        """x: (B, 3, H, W) -> [(B, 128, H/8, W/8), (B, 256, H/16, W/16),
        (B, 512, H/32, W/32)]."""
        out = hswish(self.bn1(self.conv1(x)))
        b = self.Conv1(resize_bilinear_torch(out, x.shape[2] // 4, x.shape[3] // 4))
        if self.large:
            b = hswish(self.Bn1(b))
        c = self.Conv2(b)
        if self.large:
            c = hswish(self.Bn2(c))
        for name in self.blocks:
            out = getattr(self, name)(out)
        out = hswish(self.bn2(self.conv2(out)))
        return [b, c, out]
