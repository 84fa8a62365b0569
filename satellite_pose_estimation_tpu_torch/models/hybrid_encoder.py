"""HybridEncoder: the AIFI intra-scale transformer and the CCFM cross-scale
CSP-RepVgg fusion (counterpart of models/hybrid_encoder.py), NCHW inside.

* a 1x1 conv + BN projection of every level to ``hidden_dim``;
* AIFI: one post-norm transformer encoder layer (erf-GELU FFN) over the
  tokens of the deepest level, with the 2D sincos position embedding. It is
  the DETR encoder's ``EncoderLayer``, so its attention takes K1 (the fused
  kernel) from 256 tokens on (input 512: a 16 x 16 level) and the plain
  core below, as the JAX layer routes it;
* CCFM: a top-down FPN (nearest 2x upsample, CSPRepLayer) and a bottom-up
  PAN (bicubic 0.5x downsample without antialias, CSPRepLayer);
* ``RepVggBlock`` runs its 3x3 and 1x1 conv + BN branches side by side,
  or with ``deploy`` one fused 3x3 conv (``fuse_repvgg_params``).

Module names follow the JAX package. Built under
``ops.quantize.quantized_inference``, every ``ConvNormLayer`` convolution
is a ``QConv`` and the AIFI layer takes ``quant`` (its FFN int8 under the
``ffn`` scope, its projections under ``attn_proj``); the input projections
and the fused deploy convs stay float, as in JAX.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.image_warp import resize_bicubic_torch, resize_bilinear_torch
from ..ops.quantize import quantization_active
from .layers import conv2d, get_activation, norm_layer
from .position_encoding import build_2d_sincos_position_embedding
from .transformer import EncoderLayer


class ConvNormLayer(nn.Module):
    """conv (no bias) -> norm -> optional activation; padding (k - 1) // 2
    unless given."""

    def __init__(self, cin, cout, kernel, stride=1, padding=None, act=None, norm="bn",
                 generator=None):
        super().__init__()
        pad = (kernel - 1) // 2 if padding is None else padding
        self.conv = conv2d(cin, cout, kernel, stride=stride, padding=pad, bias=False,
                           generator=generator, quant=quantization_active())
        self.norm = norm_layer(norm, cout)
        self.act = get_activation(act)

    def forward(self, x):
        return self.act(self.norm(self.conv(x)))


class RepVggBlock(nn.Module):
    """3x3 + 1x1 conv + BN branches, summed, then the activation; with
    ``deploy`` one 3x3 conv with a bias (``conv_fused``)."""

    def __init__(self, ch, act="relu", norm="bn", deploy=False, generator=None):
        super().__init__()
        self.deploy = deploy
        if deploy:
            self.conv_fused = conv2d(ch, ch, 3, padding=1, generator=generator)
        else:
            self.conv1 = ConvNormLayer(ch, ch, 3, 1, act=None, norm=norm, generator=generator)
            self.conv2 = ConvNormLayer(ch, ch, 1, 1, padding=0, act=None, norm=norm,
                                       generator=generator)
        self.act = get_activation(act)

    def forward(self, x):
        y = self.conv_fused(x) if self.deploy else self.conv1(x) + self.conv2(x)
        return self.act(y)


def fuse_repvgg_params(state: dict, prefix: str, eps: float = 1e-5) -> dict:
    """Fold one two-branch ``RepVggBlock``'s (conv3x3 + BN, conv1x1 + BN),
    read from ``state`` under ``prefix`` (e.g.
    ``"encoder.fpn_blocks_0.bottlenecks_0."``), into the deploy block's
    ``conv_fused`` weight and bias: ``{prefix + "conv_fused.weight": ...,
    prefix + "conv_fused.bias": ...}``."""
    def fold(branch):
        w = state[f"{prefix}{branch}.conv.weight"]
        p = f"{prefix}{branch}.norm."
        t = state[p + "weight"] / torch.sqrt(state[p + "running_var"] + eps)
        return w * t[:, None, None, None], state[p + "bias"] - state[p + "running_mean"] * t

    k3, b3 = fold("conv1")
    k1, b1 = fold("conv2")
    return {prefix + "conv_fused.weight": k3 + F.pad(k1, (1, 1, 1, 1)),
            prefix + "conv_fused.bias": b3 + b1}


class CSPRepLayer(nn.Module):
    def __init__(self, cin, ch_out, num_blocks=3, expansion=1.0, act="silu", deploy=False,
                 generator=None):
        super().__init__()
        g = generator
        hidden = int(ch_out * expansion)
        self.num_blocks = num_blocks
        self.conv1 = ConvNormLayer(cin, hidden, 1, 1, act=act, generator=g)
        for i in range(num_blocks):
            self.add_module(f"bottlenecks_{i}", RepVggBlock(hidden, act, deploy=deploy,
                                                            generator=g))
        self.conv2 = ConvNormLayer(cin, hidden, 1, 1, act=act, generator=g)
        self.conv3 = (ConvNormLayer(hidden, ch_out, 1, 1, act=act, generator=g)
                      if hidden != ch_out else None)

    def forward(self, x):
        x1 = self.conv1(x)
        for i in range(self.num_blocks):
            x1 = getattr(self, f"bottlenecks_{i}")(x1)
        y = x1 + self.conv2(x)
        return y if self.conv3 is None else self.conv3(y)


class HybridEncoder(nn.Module):
    def __init__(self, in_channels=(512, 1024, 2048), hidden_dim=256, nhead=8,
                 dim_feedforward=1024, dropout=0.0, enc_act="gelu", use_encoder_idx=(2,),
                 num_encoder_layers=1, pe_temperature=10000.0, expansion=1.0, act="silu",
                 deploy=False, generator=None, num_blocks=1):
        super().__init__()
        g = generator
        self.hidden_dim = hidden_dim
        self.use_encoder_idx = tuple(use_encoder_idx)
        self.num_encoder_layers = num_encoder_layers
        self.pe_temperature = pe_temperature
        self.n = n = len(in_channels)
        for i, cin in enumerate(in_channels):
            self.add_module(f"input_proj_{i}_conv", conv2d(cin, hidden_dim, 1, bias=False,
                                                           generator=g))
            self.add_module(f"input_proj_{i}_norm", norm_layer("bn", hidden_dim))
        for i in range(len(self.use_encoder_idx)):
            for layer in range(num_encoder_layers):
                self.add_module(f"encoder_{i}_layer_{layer}", EncoderLayer(
                    hidden_dim, nhead, dim_feedforward, dropout, g, activation=enc_act,
                    quant=quantization_active()))
        for j in range(n - 1):
            self.add_module(f"lateral_convs_{j}", ConvNormLayer(hidden_dim, hidden_dim, 1, 1,
                                                                act=act, generator=g))
            self.add_module(f"fpn_blocks_{j}", CSPRepLayer(2 * hidden_dim, hidden_dim,
                                                           num_blocks, expansion, act, deploy, g))
            self.add_module(f"pan_blocks_{j}", CSPRepLayer(2 * hidden_dim, hidden_dim,
                                                           num_blocks, expansion, act, deploy, g))

    def _project(self, feats):
        if len(feats) != self.n:
            raise ValueError(f"expected {self.n} feature maps, got {len(feats)}")
        return [getattr(self, f"input_proj_{i}_norm")(getattr(self, f"input_proj_{i}_conv")(f))
                for i, f in enumerate(feats)]

    def _aifi(self, x, i):
        """The encoder layers ``encoder_{i}_layer_*`` over the tokens of the
        NCHW map ``x``."""
        b, c, h, w = x.shape
        mem = x.flatten(2).transpose(1, 2)  # (B, h*w, C), rows h-major
        pos = build_2d_sincos_position_embedding(w, h, self.hidden_dim, self.pe_temperature,
                                                 device=x.device)[None].to(mem.dtype)
        for layer in range(self.num_encoder_layers):
            mem = getattr(self, f"encoder_{i}_layer_{layer}")(mem, pos)
        return mem.transpose(1, 2).reshape(b, c, h, w)

    def forward(self, feats):
        """feats: NCHW maps of ``in_channels`` -> ``len(feats)`` NCHW maps of
        ``hidden_dim`` channels at the same strides."""
        proj = self._project(feats)
        for i, enc_ind in enumerate(self.use_encoder_idx):
            proj[enc_ind] = self._aifi(proj[enc_ind], i)

        n = self.n
        inner_outs = [proj[-1]]  # top-down FPN
        for idx in range(n - 1, 0, -1):
            feat_high = getattr(self, f"lateral_convs_{n - 1 - idx}")(inner_outs[0])
            inner_outs[0] = feat_high
            up = F.interpolate(feat_high, scale_factor=2, mode="nearest")
            inner_outs.insert(0, getattr(self, f"fpn_blocks_{n - 1 - idx}")(
                torch.cat([up, proj[idx - 1]], dim=1)))

        outs = [inner_outs[0]]  # bottom-up PAN
        for idx in range(n - 1):
            h, w = outs[-1].shape[-2:]
            down = resize_bicubic_torch(outs[-1], h // 2, w // 2)
            outs.append(getattr(self, f"pan_blocks_{idx}")(
                torch.cat([down, inner_outs[idx + 1]], dim=1)))
        return outs


class HybridEncoderModify(HybridEncoder):
    """Single-resolution fusion: the shallowest and deepest levels are
    resized (bilinear) to the middle level's size, AIFI runs on the resized
    deepest level, and the FPN / PAN fuse without resampling. As in JAX and
    the reference, both axes are sized from the middle level's H (square
    inputs). ``RTDETR`` builds ``HybridEncoder`` only, as JAX does."""

    def forward(self, feats):
        proj = self._project(feats)
        hm = proj[1].shape[-2]
        p0 = resize_bilinear_torch(proj[0], hm, hm)
        p2 = self._aifi(resize_bilinear_torch(proj[2], hm, hm), 0)

        levels = [p0, proj[1], p2]
        n = len(levels)
        inner_outs = [levels[-1]]
        for idx in range(n - 1, 0, -1):
            feat_high = getattr(self, f"lateral_convs_{n - 1 - idx}")(inner_outs[0])
            inner_outs[0] = feat_high
            inner_outs.insert(0, getattr(self, f"fpn_blocks_{n - 1 - idx}")(
                torch.cat([feat_high, levels[idx - 1]], dim=1)))
        outs = [inner_outs[0]]
        for idx in range(n - 1):
            outs.append(getattr(self, f"pan_blocks_{idx}")(
                torch.cat([outs[-1], inner_outs[idx + 1]], dim=1)))
        return outs
