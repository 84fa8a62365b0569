"""Matmul precision control (counterpart of ops/precision.py).

On a GPU, PyTorch runs float32 convolutions through cuDNN in TF32 by default
(about three decimal digits), and float32 matmuls in TF32 whenever
``torch.backends.cuda.matmul.allow_tf32`` is set. That is harmless for the
network (which runs in bf16 anyway) but ruins geometry: a 3e-3 error in a
rotation matrix is ~0.2 deg of attitude. Geometry, the crop warp and every
parity run go through ``highest_precision``. ``loss_dtype`` /
``to_loss_dtype`` decide the dtype that model outputs reach the loss in.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def highest_precision():
    """Context manager (and, as ``@highest_precision()``, a decorator) that
    turns TF32 off for cuBLAS matmuls and cuDNN convolutions and restores
    the previous settings on exit."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def loss_dtype(x: torch.Tensor) -> torch.dtype:
    """Dtype for handing model outputs to the loss: bf16/f16 promote to
    float32 (stable softmax and log sums), float32 stays float32 and float64
    stays float64, so a float64 parity run is not truncated."""
    return torch.promote_types(x.dtype, torch.float32)


def to_loss_dtype(x: torch.Tensor) -> torch.Tensor:
    """Cast ``x`` per :func:`loss_dtype`."""
    return x.to(loss_dtype(x))
