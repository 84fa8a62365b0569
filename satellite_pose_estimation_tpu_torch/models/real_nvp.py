"""RealNVP normalizing flow over 2-D keypoint residuals (counterpart of
models/real_nvp.py): six affine coupling layers with alternating masks and
a standard-normal prior. Coupling layer i has a scale net ``s_{i}`` (tanh
output) and a translation net ``t_{i}``, each ``fc1`` -> leaky ReLU ->
``fc2`` -> leaky ReLU -> ``fc3`` (64 hidden units), as the JAX module
names them. Used by the normalizing-flow point loss
(``losses.criterion.nf_point_loss``).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from .layers import linear

_MASKS = [[0.0, 1.0], [1.0, 0.0]] * 3


class _CouplingNet(nn.Module):
    def __init__(self, out_tanh: bool, generator=None):
        super().__init__()
        self.out_tanh = out_tanh
        self.fc1 = linear(2, 64, generator)
        self.fc2 = linear(64, 64, generator)
        self.fc3 = linear(64, 2, generator)

    def forward(self, x):
        h = self.fc3(F.leaky_relu(self.fc2(F.leaky_relu(self.fc1(x)))))
        return torch.tanh(h) if self.out_tanh else h


class RealNVP(nn.Module):
    def __init__(self, num_coupling: int = 6, generator=None):
        super().__init__()
        self.num_coupling = num_coupling
        for i in range(num_coupling):
            self.add_module(f"s_{i}", _CouplingNet(True, generator))
            self.add_module(f"t_{i}", _CouplingNet(False, generator))

    def _mask(self, i, ref):
        return torch.tensor(_MASKS[i], dtype=ref.dtype, device=ref.device)

    def log_prob(self, x):
        """x (..., 2) residuals -> (...) log density under the flow."""
        log_det = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
        z = x
        for i in reversed(range(self.num_coupling)):
            m = self._mask(i, x)
            z_masked = m * z
            s = getattr(self, f"s_{i}")(z_masked) * (1 - m)
            t = getattr(self, f"t_{i}")(z_masked) * (1 - m)
            z = z_masked + (1 - m) * (z - t) * torch.exp(-s)
            log_det = log_det - s.sum(-1)
        return -0.5 * (z * z).sum(-1) - math.log(2 * math.pi) + log_det

    def transform(self, z):
        """The flow's map from prior samples z (..., 2) to residuals."""
        x = z
        for i in range(self.num_coupling):
            m = self._mask(i, z)
            x_masked = m * x
            s = getattr(self, f"s_{i}")(x_masked) * (1 - m)
            t = getattr(self, f"t_{i}")(x_masked) * (1 - m)
            x = x_masked + (1 - m) * (x * torch.exp(s) + t)
        return x

    def sample(self, generator, shape):
        """``shape`` + (2,) samples: z ~ N(0, 1) drawn from ``generator`` on
        the flow's device, through ``transform``."""
        weight = self.s_0.fc1.weight
        z = torch.randn(tuple(shape) + (2,), generator=generator, dtype=weight.dtype,
                        device=weight.device)
        return self.transform(z)
