"""PResNet, the ResNet-vd backbone of RT-DETR (counterpart of
models/presnet.py), NCHW inside.

* variant ``d``: a 3x3 stem triplet (``conv1_1/2/3``) in place of the 7x7
  conv, and on stride-2 blocks an avgpool(2, ceil) + 1x1 conv shortcut;
* the bottleneck puts its stride on the 3x3 (variants b/d), the basic
  block on its first 3x3;
* ``return_idx`` picks the pyramid levels (strides 4, 8, 16, 32);
* ``freeze_norm`` makes every norm a ``FrozenBatchNorm``, else an
  ``nn.BatchNorm2d`` (the JAX ``TorchBatchNorm``).

Module names follow the JAX package (``conv1_1``, ``res{i}_{b}``,
``branch2a``, ``short_conv``, each ``ConvNorm`` a ``conv`` and a ``norm``),
so the converter maps parameters by path.
"""
from __future__ import annotations

import torch.nn.functional as F
from torch import nn

from .layers import conv2d, get_activation, norm_layer

_CFG = {
    18: ([2, 2, 2, 2], 1),
    34: ([3, 4, 6, 3], 1),
    50: ([3, 4, 6, 3], 4),
    101: ([3, 4, 23, 3], 4),
}


class ConvNorm(nn.Module):
    """conv (no bias, padding (k - 1) // 2) -> norm -> optional activation."""

    def __init__(self, cin, cout, kernel, stride=1, act=None, norm="frozen_bn",
                 generator=None):
        super().__init__()
        self.conv = conv2d(cin, cout, kernel, stride=stride, padding=(kernel - 1) // 2,
                           bias=False, generator=generator)
        self.norm = norm_layer(norm, cout)
        self.act = get_activation(act)

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


def _avgpool_ceil2(x):
    """AvgPool2d(2, 2, ceil_mode=True) as JAX writes it: an odd edge is
    padded by replication, so the last window averages 4 values."""
    h, w = x.shape[-2:]
    if h % 2 or w % 2:
        x = F.pad(x, (0, w % 2, 0, h % 2), mode="replicate")
    return F.avg_pool2d(x, 2, 2)


class _Shortcut(nn.Module):
    def _init_shortcut(self, cin, cout, stride, shortcut, variant, norm, g):
        self.shortcut = shortcut
        self.pool_first = variant == "d" and stride == 2
        if not shortcut:
            self.short_conv = ConvNorm(cin, cout, 1, 1 if self.pool_first else stride,
                                       None, norm, g)

    def _short(self, x):
        if self.shortcut:
            return x
        return self.short_conv(_avgpool_ceil2(x) if self.pool_first else x)


class PBasicBlock(_Shortcut):
    expansion = 1

    def __init__(self, cin, ch_out, stride, shortcut, act="relu", variant="d",
                 norm="frozen_bn", generator=None):
        super().__init__()
        g = generator
        self.branch2a = ConvNorm(cin, ch_out, 3, stride, act, norm, g)
        self.branch2b = ConvNorm(ch_out, ch_out, 3, 1, None, norm, g)
        self._init_shortcut(cin, ch_out, stride, shortcut, variant, norm, g)
        self.act = get_activation(act)

    def forward(self, x):
        return self.act(self.branch2b(self.branch2a(x)) + self._short(x))


class PBottleNeck(_Shortcut):
    expansion = 4

    def __init__(self, cin, ch_out, stride, shortcut, act="relu", variant="d",
                 norm="frozen_bn", generator=None):
        super().__init__()
        g = generator
        s1, s2 = (stride, 1) if variant == "a" else (1, stride)
        wide = ch_out * self.expansion
        self.branch2a = ConvNorm(cin, ch_out, 1, s1, act, norm, g)
        self.branch2b = ConvNorm(ch_out, ch_out, 3, s2, act, norm, g)
        self.branch2c = ConvNorm(ch_out, wide, 1, 1, None, norm, g)
        self._init_shortcut(cin, wide, stride, shortcut, variant, norm, g)
        self.act = get_activation(act)

    def forward(self, x):
        out = self.branch2c(self.branch2b(self.branch2a(x)))
        return self.act(out + self._short(x))


class PResNet(nn.Module):
    def __init__(self, depth=50, variant="d", num_stages=4, return_idx=(1, 2, 3), act="relu",
                 freeze_norm=True, generator=None):
        super().__init__()
        if depth not in _CFG:
            raise ValueError(f"PResNet depth {depth} is not one of {sorted(_CFG)}")
        g = generator
        block_nums, expansion = _CFG[depth]
        norm = "frozen_bn" if freeze_norm else "bn"
        block = PBottleNeck if depth >= 50 else PBasicBlock
        self.return_idx = tuple(return_idx)
        self.out_channels = [64 * 2 ** i * expansion for i in self.return_idx]
        if variant in ("c", "d"):
            self.conv1_1 = ConvNorm(3, 32, 3, 2, act, norm, g)
            self.conv1_2 = ConvNorm(32, 32, 3, 1, act, norm, g)
            self.conv1_3 = ConvNorm(32, 64, 3, 1, act, norm, g)
            self.stem = ["conv1_1", "conv1_2", "conv1_3"]
        else:
            self.conv1_1 = ConvNorm(3, 64, 7, 2, act, norm, g)
            self.stem = ["conv1_1"]
        self.stages = []
        cin = 64
        for i, ch_out in enumerate([64, 128, 256, 512][:num_stages]):
            names = []
            for b in range(block_nums[i]):
                name = f"res{i + 2}_{b}"
                self.add_module(name, block(cin, ch_out, 2 if (b == 0 and i != 0) else 1,
                                            b != 0, act, variant, norm, g))
                cin = ch_out * block.expansion
                names.append(name)
            self.stages.append(names)

    def forward(self, x):
        """x: (B, 3, H, W) -> the feature maps of ``return_idx``."""
        for name in self.stem:
            x = getattr(self, name)(x)
        x = F.max_pool2d(x, 3, 2, 1)
        outs = []
        for i, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if i in self.return_idx:
                outs.append(x)
        return outs
