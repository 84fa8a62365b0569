"""GhostNetV2 emitting a three-level pyramid (counterpart of
models/ghostnetv2.py; R2/nn/backbone/ghostnetv2.py), NCHW inside.

Ghost modules (a primary conv and a cheap depthwise op) with the decoupled
fully-connected (DFC) attention branch from the third block on: a 2x2
average pool, a 1x1 conv, the 1x5 and 5x1 depthwise convs, a sigmoid gate
and a nearest (floor-index) upsample back to the module's input size. As in
the reference, levels 0 and 1 come from a side branch on the pre-BN stem
output resized to input / 4 (bilinear, no antialias) through two stride-2
3x3 convs with BN + hardswish, and level 2 is the 960-channel block tail
through a 1x1 512 conv. Every norm is a trainable ``nn.BatchNorm2d``.
Module names follow the JAX package (``conv_stem/bn1``, ``Conv{1,2,3}`` /
``Bn{1,2,3}``, ``blocks_{stage}_{i}``), so parameters map by path; the
classifier tail is not built.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image_warp import resize_bilinear_torch
from .layers import conv2d, norm_layer
from .mobilenetv3 import hswish


def make_divisible(v, divisor=4):
    return max(divisor, int(v + divisor / 2) // divisor * divisor)


class GhostModule(nn.Module):
    def __init__(self, cin, ch_out, kernel=1, ratio=2, dw_size=3, relu=True, mode="original",
                 generator=None):
        super().__init__()
        g = generator
        init_ch = math.ceil(ch_out / ratio)
        new_ch = init_ch * (ratio - 1)
        self.ch_out, self.relu, self.attn = ch_out, relu, mode == "attn"
        self.primary_conv = conv2d(cin, init_ch, kernel, padding=kernel // 2, bias=False,
                                   generator=g)
        self.primary_bn = norm_layer("bn", init_ch)
        self.cheap_conv = conv2d(init_ch, new_ch, dw_size, padding=dw_size // 2, groups=init_ch,
                                 bias=False, generator=g)
        self.cheap_bn = norm_layer("bn", new_ch)
        if self.attn:
            self.short_conv = conv2d(cin, ch_out, 1, bias=False, generator=g)
            self.short_bn = norm_layer("bn", ch_out)
            self.dfc_h = conv2d(ch_out, ch_out, (1, 5), padding=(0, 2), groups=ch_out, bias=False,
                                generator=g)
            self.dfc_h_bn = norm_layer("bn", ch_out)
            self.dfc_v = conv2d(ch_out, ch_out, (5, 1), padding=(2, 0), groups=ch_out, bias=False,
                                generator=g)
            self.dfc_v_bn = norm_layer("bn", ch_out)

    def forward(self, x):
        y1 = self.primary_bn(self.primary_conv(x))
        if self.relu:
            y1 = torch.relu(y1)
        y2 = self.cheap_bn(self.cheap_conv(y1))
        if self.relu:
            y2 = torch.relu(y2)
        out = torch.cat([y1, y2], dim=1)[:, :self.ch_out]
        if self.attn:
            h, w = x.shape[2:]
            a = self.short_bn(self.short_conv(F.avg_pool2d(x, 2, 2)))
            a = self.dfc_v_bn(self.dfc_v(self.dfc_h_bn(self.dfc_h(a))))
            gate = torch.sigmoid(a)
            # torch F.interpolate(mode="nearest"): floor-index sampling
            hi = torch.arange(h, device=x.device) * gate.shape[2] // h
            wi = torch.arange(w, device=x.device) * gate.shape[3] // w
            gate = gate.index_select(2, hi).index_select(3, wi)
            out = out * gate.to(out.dtype)
        return out


class GhostBottleneckV2(nn.Module):
    def __init__(self, ch_in, mid_ch, ch_out, dw_kernel=3, stride=1, se_ratio=0.0, layer_id=0,
                 generator=None):
        super().__init__()
        g = generator
        # DFC attention from the third block (layer 2) on
        self.ghost1 = GhostModule(ch_in, mid_ch, relu=True,
                                  mode="original" if layer_id <= 1 else "attn", generator=g)
        self.stride, self.se = stride, se_ratio > 0
        if stride > 1:
            self.dw_conv = conv2d(mid_ch, mid_ch, dw_kernel, stride, (dw_kernel - 1) // 2,
                                  groups=mid_ch, bias=False, generator=g)
            self.dw_bn = norm_layer("bn", mid_ch)
        if self.se:
            red = make_divisible(mid_ch * se_ratio)
            self.se_reduce = conv2d(mid_ch, red, 1, bias=True, generator=g)
            self.se_expand = conv2d(red, mid_ch, 1, bias=True, generator=g)
        self.ghost2 = GhostModule(mid_ch, ch_out, relu=False, generator=g)
        self.identity = stride == 1 and ch_in == ch_out
        if not self.identity:
            self.short_dw = conv2d(ch_in, ch_in, dw_kernel, stride, (dw_kernel - 1) // 2,
                                   groups=ch_in, bias=False, generator=g)
            self.short_dw_bn = norm_layer("bn", ch_in)
            self.short_pw = conv2d(ch_in, ch_out, 1, bias=False, generator=g)
            self.short_pw_bn = norm_layer("bn", ch_out)

    def forward(self, x):
        y = self.ghost1(x)
        if self.stride > 1:
            y = self.dw_bn(self.dw_conv(y))
        if self.se:
            s = self.se_expand(torch.relu(self.se_reduce(torch.mean(y, dim=(2, 3), keepdim=True))))
            y = y * torch.clamp(s + 3.0, 0.0, 6.0) / 6.0
        y = self.ghost2(y)
        if self.identity:
            return y + x
        return y + self.short_pw_bn(self.short_pw(self.short_dw_bn(self.short_dw(x))))


# (dw_kernel, mid, out, se_ratio, stride) per block, in the reference's 9
# stages (R2 ghostnetv2.py:297-319)
CFG = [
    [(3, 16, 16, 0.0, 1)],
    [(3, 48, 24, 0.0, 2)],
    [(3, 72, 24, 0.0, 1)],
    [(5, 72, 40, 0.25, 2)],
    [(5, 120, 40, 0.25, 1)],
    [(3, 240, 80, 0.0, 2)],
    [(3, 200, 80, 0.0, 1),
     (3, 184, 80, 0.0, 1),
     (3, 184, 80, 0.0, 1),
     (3, 480, 112, 0.25, 1),
     (3, 672, 112, 0.25, 1)],
    [(5, 672, 160, 0.25, 2)],
    [(5, 960, 160, 0.0, 1),
     (5, 960, 160, 0.25, 1),
     (5, 960, 160, 0.0, 1),
     (5, 960, 160, 0.25, 1)],
]


class GhostNetV2(nn.Module):
    """The reference-variant pyramid [input/8 (128 ch), input/16 (256 ch),
    input/32 (512 ch)] (R2 ghostnetv2.py:286-442)."""

    out_channels = (128, 256, 512)

    def __init__(self, width: float = 1.0, generator=None):
        super().__init__()
        g = generator
        stem = make_divisible(16 * width)
        self.conv_stem = conv2d(3, stem, 3, 2, 1, bias=False, generator=g)
        self.bn1 = norm_layer("bn", stem)
        self.Conv1 = conv2d(stem, 128, 3, 2, 1, bias=False, generator=g)
        self.Bn1 = norm_layer("bn", 128)
        self.Conv2 = conv2d(128, 256, 3, 2, 1, bias=False, generator=g)
        self.Bn2 = norm_layer("bn", 256)
        self.blocks = []
        ch, layer_id = stem, 0
        for si, stage in enumerate(CFG):
            for bi, (k, mid, cout, se, s) in enumerate(stage):
                cout = make_divisible(cout * width)
                self.add_module(f"blocks_{si}_{bi}", GhostBottleneckV2(
                    ch, make_divisible(mid * width), cout, k, s, se, layer_id, g))
                self.blocks.append(f"blocks_{si}_{bi}")
                ch, layer_id = cout, layer_id + 1
        tail = make_divisible(960 * width)  # stage 9: ConvBnAct 160 -> 960
        self.blocks_9_0_conv = conv2d(ch, tail, 1, bias=False, generator=g)
        self.blocks_9_0_bn1 = norm_layer("bn", tail)
        self.Conv3 = conv2d(tail, 512, 1, bias=False, generator=g)
        self.Bn3 = norm_layer("bn", 512)

    def forward(self, x):
        out = self.conv_stem(x)
        # the side branch taps the pre-BN stem output (R2 ghostnetv2.py:420)
        b = self.Conv1(resize_bilinear_torch(out, x.shape[2] // 4, x.shape[3] // 4))
        b = hswish(self.Bn1(b))
        c = hswish(self.Bn2(self.Conv2(b)))
        out = torch.relu(self.bn1(out))
        for name in self.blocks:
            out = getattr(self, name)(out)
        out = torch.relu(self.blocks_9_0_bn1(self.blocks_9_0_conv(out)))
        out = hswish(self.Bn3(self.Conv3(out)))
        return [b, c, out]
