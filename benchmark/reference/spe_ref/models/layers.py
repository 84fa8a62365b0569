"""Shared building blocks (counterpart of models/layers.py).

Initialisers mirror flax's defaults, so a seeded model built here has the
statistics of the JAX one: convolution and dense kernels are LeCun-normal
(truncated normal, fan-in), biases zero. One device, float only: the
program's int8 modules and data-parallel BatchNorm have no copy here.
"""
from __future__ import annotations

import math

import torch
from torch import nn


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal at +-2 std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def conv2d(cin, cout, kernel, stride=1, padding=0, bias=True, generator=None, groups=1):
    """``nn.Conv2d`` with flax's initialisation (LeCun normal over the
    fan-in, cin / groups x kh x kw). ``kernel`` and ``padding`` may be
    pairs."""
    conv = nn.Conv2d(cin, cout, kernel, stride=stride, padding=padding, bias=bias,
                     groups=groups)
    lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


def linear(cin, cout, generator=None):
    """``nn.Linear`` with flax's initialisation."""
    lin = nn.Linear(cin, cout)
    lecun_normal_(lin.weight, cin, generator)
    nn.init.zeros_(lin.bias)
    return lin


class FrozenBatchNorm(nn.Module):
    """BatchNorm with fixed statistics and affine parameters (NCHW):
    y = (x - mean) * rsqrt(var + eps) * weight + bias, all four held as
    buffers and never trained. The per-channel multiplier and shift are
    formed in float32 and cast to the input dtype, as the JAX module does.
    """

    def __init__(self, features: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.register_buffer("weight", torch.ones(features))
        self.register_buffer("bias", torch.zeros(features))
        self.register_buffer("running_mean", torch.zeros(features))
        self.register_buffer("running_var", torch.ones(features))

    def forward(self, x):
        inv = 1.0 / torch.sqrt(self.running_var.float() + self.eps)
        weight = self.weight.float()
        mult = (weight * inv).to(x.dtype)
        shift = (self.bias.float() - self.running_mean.float() * weight * inv).to(x.dtype)
        return x * mult[:, None, None] + shift[:, None, None]


def norm_layer(kind: str, features: int) -> nn.Module:
    """The norm of ``kind`` over ``features`` NCHW channels (counterpart of
    ``apply_norm``, the reference's build_batchnorm selector):

    * ``frozen_bn`` -- ``FrozenBatchNorm``;
    * ``bn`` and ``sync_bn`` -- ``nn.BatchNorm2d`` (eps 1e-5, momentum 0.1 =
      JAX's retention 0.9, the unbiased variance in the running statistic:
      the JAX ``TorchBatchNorm`` semantics; one device);
    * ``group_bn`` -- ``nn.GroupNorm(32)`` with flax's eps 1e-6.
    """
    if kind == "frozen_bn":
        return FrozenBatchNorm(features)
    if kind in ("bn", "sync_bn"):
        return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1)
    if kind == "group_bn":
        return nn.GroupNorm(32, features, eps=1e-6)
    raise ValueError(f"unknown norm kind: {kind}")


_ACTIVATIONS = {"relu": torch.relu, "gelu": nn.functional.gelu,  # erf GELU, as JAX's
                "silu": nn.functional.silu, "swish": nn.functional.silu}


def get_activation(name):
    """The activation ``name`` (JAX ``get_activation``: relu, gelu (erf),
    silu / swish), or the identity for None."""
    return (lambda x: x) if name is None else _ACTIVATIONS[name]


class MLP(nn.Module):
    """DETR-style MLP head: (num_layers-1) x [Linear + ReLU] + Linear."""

    def __init__(self, input_dim, hidden_dim, output_dim, num_layers, generator=None):
        super().__init__()
        self.num_layers = num_layers
        dims = [input_dim] + [hidden_dim] * (num_layers - 1) + [output_dim]
        for i in range(num_layers):
            self.add_module(f"layers_{i}", linear(dims[i], dims[i + 1], generator))

    def forward(self, x):
        for i in range(self.num_layers):
            x = getattr(self, f"layers_{i}")(x)
            if i < self.num_layers - 1:
                x = torch.relu(x)
        return x
