"""Paeth three-shear rotation as a hand-written CUDA kernel (counterpart of
ops/pallas_rotate.py).

``rotate_shear3_pallas(images, thetas, cubic)`` rotates (N, S, S, C) images
about their centres by per-image angles, |theta| <= pi/2, with the semantics
of ``ops.image_warp.rotate_shear3`` (the "shear" border rule, which the JAX
Pallas kernel reproduces):

* on CUDA tensors: K3, ``csrc/rotate_shear3.cu``, one kernel a call (each
  block stages a band of shear 2's output in shared memory; no scratch
  tensor);
* on CPU tensors: ``rotate_shear3``, the plain version.

The kernel is built with nvcc at first use and raises on anything it does
not take; on a CUDA tensor it never falls back to the plain version.
``launch_count`` counts kernel launches (one per rotation).
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.cuda_build import build_library
from .image_warp import rotate_shear3

SOURCES = ["rotate_shear3.cu"]

launch_count = 0
_lib = None


def load_library() -> ctypes.CDLL:
    """Build (first use only) and load K3's library."""
    global _lib
    if _lib is None:
        lib = build_library("rotate_shear3", SOURCES)
        lib.spe_rotate_shear3.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
            ctypes.c_void_p]
        lib.spe_rotate_shear3.restype = ctypes.c_int
        lib.spe_rotate_error_string.argtypes = [ctypes.c_int]
        lib.spe_rotate_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(images, thetas, cubic: bool):
    """K3 on the current stream; returns the (N, S, S, C) float32 result."""
    global launch_count
    if images.dim() != 4 or images.shape[1] != images.shape[2]:
        raise ValueError(f"expected (N, S, S, C) images, got {tuple(images.shape)}")
    N, S, _, C = images.shape
    if thetas.shape != (N,):
        raise ValueError(f"expected ({N},) angles, got {tuple(thetas.shape)}")
    if thetas.device != images.device:
        raise ValueError(f"angles on {thetas.device}, images on {images.device}")
    img = images.to(torch.float32).contiguous()
    th = thetas.to(torch.float32).contiguous()
    out = torch.empty_like(img)
    lib = load_library()
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream(img.device).cuda_stream
        err = lib.spe_rotate_shear3(img.data_ptr(), out.data_ptr(), th.data_ptr(),
                                    N, S, C, int(bool(cubic)), stream)
    if err != 0:
        msg = lib.spe_rotate_error_string(err).decode()
        raise RuntimeError(f"rotation kernel launch failed: CUDA error {err} ({msg})")
    launch_count += 1
    return out


def rotate_shear3_pallas(images, thetas, cubic: bool = False):
    """Rotate (N, S, S, C) images by ``thetas`` (N,) radians about their
    centres (S - 1) / 2: K3 on CUDA tensors, ``rotate_shear3`` on CPU
    tensors. Returns float32."""
    if images.device.type == "cuda":
        return _launch(images, thetas, cubic)
    if images.device.type == "cpu":
        return rotate_shear3(images, thetas, cubic)
    raise ValueError(f"rotation runs on cpu or cuda, not {images.device}")
