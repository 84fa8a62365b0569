"""Shared building blocks (counterpart of models/layers.py).

Initialisers mirror flax's defaults, so a seeded model built here has the
statistics of the JAX one: convolution and dense kernels are LeCun-normal
(truncated normal, fan-in), biases zero.

The int8 modules ``QConv`` and ``QDense`` are ``nn.Conv2d`` / ``nn.Linear``
with the same parameters, so one state dict loads into the float and the
int8 model. Their activation scales, and the q, k and v scales of an
attention whose core is int8, come from the static-PTQ hook
(``calibration`` / ``static_scales``, below, keyed by site; ``int8_sites``
and ``site_scales`` map them to and from module paths), which plays the
part of the JAX ``quant`` variable collection.
"""
from __future__ import annotations

import math
import threading
from contextlib import contextmanager

import torch
from torch import nn

from ..ops.quantize import amax_to_scale, int8_conv, int8_matmul
from ..parallel.mesh import active_data_parallel, all_mean_differentiable


def lecun_normal_(weight: torch.Tensor, fan_in: int,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """flax ``lecun_normal``: truncated normal at +-2 std, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    with torch.no_grad():
        return nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std,
                                     generator=generator)


def conv2d(cin, cout, kernel, stride=1, padding=0, bias=True, generator=None, quant=False,
           groups=1):
    """``nn.Conv2d`` (``QConv`` with ``quant``) with flax's initialisation
    (LeCun normal over the fan-in, cin / groups x kh x kw). ``kernel`` and
    ``padding`` may be pairs."""
    conv = (QConv if quant else nn.Conv2d)(cin, cout, kernel, stride=stride, padding=padding,
                                          bias=bias, groups=groups)
    lecun_normal_(conv.weight, conv.weight[0].numel(), generator)
    if bias:
        nn.init.zeros_(conv.bias)
    return conv


def linear(cin, cout, generator=None, quant=False):
    """``nn.Linear`` (``QDense`` with ``quant``) with flax's initialisation."""
    lin = (QDense if quant else nn.Linear)(cin, cout)
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


class BatchNorm2d(nn.BatchNorm2d):
    """``nn.BatchNorm2d`` whose training statistics cover the global batch
    inside a data-parallel step (``parallel.mesh.data_parallel``), the JAX
    ``TorchBatchNorm`` with a bound ``axis_name``: the mean and mean square
    of each rank's (equal) shard are averaged over the group, n counts the
    global batch, and the gradient flows back through the average. The
    statistics and the normalisation run in float32 (float64 for a float64
    input), as ``nn.BatchNorm2d`` computes them on the card. A dp-N
    step then normalises as the dp-1 step on the same global batch does, as
    JAX's jit-SPMD program does by construction. Outside such a step it is
    ``nn.BatchNorm2d``."""

    def forward(self, x):
        dp = active_data_parallel()
        if dp is None or dp.size == 1 or not self.training:
            return super().forward(x)
        xs = x.to(torch.promote_types(x.dtype, torch.float32))
        stats = all_mean_differentiable(
            torch.stack([xs.mean(dim=(0, 2, 3)), xs.square().mean(dim=(0, 2, 3))]),
            dp.mesh, dp.axis)
        mean, mean2 = stats[0], stats[1]
        var = torch.clamp_min(mean2 - mean.square(), 0.0)
        n = x.numel() // x.shape[1] * dp.size
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(m * mean.detach())
            # the unbiased variance in the running statistic, as torch stores it
            self.running_var.mul_(1.0 - m).add_(m * var.detach() * (n / max(n - 1, 1)))
            self.num_batches_tracked.add_(1)
        inv = torch.rsqrt(var + self.eps) * self.weight
        # normalised in float32 at least and cast back, as cuDNN's batch
        # norm treats a bf16 input under autocast
        y = (xs - mean[:, None, None]) * inv[:, None, None] + self.bias[:, None, None]
        return y.to(x.dtype)


def norm_layer(kind: str, features: int) -> nn.Module:
    """The norm of ``kind`` over ``features`` NCHW channels (counterpart of
    ``apply_norm``, the reference's build_batchnorm selector):

    * ``frozen_bn`` -- ``FrozenBatchNorm``;
    * ``bn`` and ``sync_bn`` -- ``BatchNorm2d`` (eps 1e-5, momentum 0.1 =
      JAX's retention 0.9, the unbiased variance in the running statistic:
      the JAX ``TorchBatchNorm`` semantics). On one device they are
      ``nn.BatchNorm2d``; in a data-parallel step both take the global
      batch's statistics, as JAX's jit-SPMD step gives ``bn`` and
      ``sync_bn`` alike (the reference's ``bn`` is per replica);
    * ``group_bn`` -- ``nn.GroupNorm(32)`` with flax's eps 1e-6.
    """
    if kind == "frozen_bn":
        return FrozenBatchNorm(features)
    if kind in ("bn", "sync_bn"):
        return BatchNorm2d(features, eps=1e-5, momentum=0.1)
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


# -- int8 PTQ ------------------------------------------------------------------

_quant = threading.local()


CORE_SITES = ("amax_q", "amax_k", "amax_v")  # an int8 attention core's q, k, v


def int8_sites(model: nn.Module) -> dict:
    """``{key: site}`` for every int8 site of ``model``: ``"<module
    path>.act_amax"`` -> the module for a ``QConv`` / ``QDense``, and
    ``"<module path>.amax_q"`` (``_k``, ``_v``) -> (module, name) for an
    attention whose core is int8 (``quant`` and ``quant_core``). The keys
    are those of its calibrated ranges, the JAX ``quant`` collection's paths
    joined by dots."""
    sites = {}
    for name, m in model.named_modules():
        if isinstance(m, (QConv, QDense)):
            sites[_join(name, "act_amax")] = m
        elif getattr(m, "quant_core", False) and m.quant:
            sites.update({_join(name, leaf): (m, leaf) for leaf in CORE_SITES})
    return sites


def _join(path, leaf):
    return f"{path}.{leaf}" if path else leaf


def site_scales(model: nn.Module, quant: dict, device=None) -> dict:
    """The static scales of ``model``'s int8 sites from the calibrated
    ranges ``quant`` (``{key: amax}``, keyed as ``int8_sites``):
    ``{site: max(amax, 1e-8) / 127}`` on ``device`` (default the
    model's). Raises unless ``quant`` holds exactly the model's sites: a
    dict calibrated under another ``SPE_INT8_SCOPE``, without the int8
    attention cores, on a wrapped model or on another model would leave
    sites dynamic."""
    sites = int8_sites(model)
    missing, extra = sorted(sites.keys() - quant.keys()), sorted(quant.keys() - sites.keys())
    if missing or extra:
        raise ValueError(f"calibrated ranges do not match the model's {len(sites)} int8 sites: "
                         f"missing {missing[:3]} ({len(missing)}), extra {extra[:3]} "
                         f"({len(extra)})")
    device = device or next(model.parameters()).device
    return {m: amax_to_scale(quant[k]).to(device) for k, m in sites.items()}


@contextmanager
def _quant_context(scales, amax):
    prev = getattr(_quant, "ctx", None)
    _quant.ctx = (scales, amax)
    try:
        yield
    finally:
        _quant.ctx = prev


def calibration(amax: dict):
    """Within this context every int8 site records the running max
    |activation| it sees into ``amax`` (``{site: float32 scalar}``, sites as
    ``int8_sites`` names them) and still quantizes dynamically -- the JAX
    calibration pass."""
    return _quant_context(None, amax)


def static_scales(scales: dict):
    """Within this context every int8 site quantizes its activations with
    its scale in ``scales`` (``site_scales``; a None value leaves that site
    dynamic, and a site absent from it raises). Outside both contexts
    every site is dynamic."""
    return _quant_context(scales, None)


def act_scale_or_calibrate(mod: nn.Module, x, name: str = "act_amax"):
    """The static-PTQ hook of the int8 sites (JAX ``_act_scale_or_calibrate``):
    in ``calibration`` record max |x| and return None (dynamic); under
    ``static_scales`` return the site's scale; else None (dynamic). The
    site is ``mod`` for ``act_amax`` (a ``QConv`` / ``QDense``), else
    (``mod``, ``name``) (an int8 attention core's ``amax_q`` / ``_k`` /
    ``_v``)."""
    ctx = getattr(_quant, "ctx", None)
    if ctx is None:
        return None
    site = mod if name == "act_amax" else (mod, name)
    scales, amax = ctx
    if amax is None:
        return scales[site]
    seen = x.detach().abs().amax().float()
    amax[site] = torch.maximum(amax[site], seen) if site in amax else seen
    return None


def _check_master(weight):
    if weight.dtype != torch.float32:
        raise TypeError("int8 modules quantize float32 weights (as JAX quantizes its float32 "
                        f"parameters), got {weight.dtype}: keep the parameters float32 and "
                        "compute in bf16 under torch.autocast")


def _out_dtype(x):
    """The module's output dtype: autocast's where it is on, else x's (the
    JAX modules' ``dtype``)."""
    dev = x.device.type
    return torch.get_autocast_dtype(dev) if torch.is_autocast_enabled(dev) else x.dtype


class QConv(nn.Conv2d):
    """``nn.Conv2d`` on the int8 path (JAX ``QConv``): the same parameters,
    weights quantized per output channel from the float32 weight at every
    call, activations per tensor."""

    def forward(self, x):
        _check_master(self.weight)
        y = int8_conv(x, self.weight, self.stride[0], self.padding[0], _out_dtype(x),
                      act_scale_or_calibrate(self, x))
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)[:, None, None]
        return y


class QDense(nn.Linear):
    """``nn.Linear`` on the int8 path: JAX ``QDense`` and, for the port's
    flattened attention projections, ``QDenseGeneral`` (weight scales per
    output row: H*D rows for q/k/v, d for ``mha_out``)."""

    def forward(self, x):
        _check_master(self.weight)
        y = int8_matmul(x.reshape(-1, x.shape[-1]), self.weight, _out_dtype(x),
                        act_scale_or_calibrate(self, x))
        y = y.reshape(*x.shape[:-1], -1)
        if self.bias is not None:
            y = y + self.bias.to(y.dtype)
        return y
