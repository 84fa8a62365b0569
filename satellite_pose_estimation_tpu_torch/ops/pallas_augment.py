"""The fused photometric chain as a hand-written CUDA kernel (counterpart of
ops/pallas_augment.py).

``fused_photometric_pallas(images, scalars, holes, seed, noise=None)``
applies, per image, 3x3 box blur -> additive gaussian noise -> cutout holes
-> edge truncation -> clip to [0, 255] -> /255 and ImageNet normalisation to
(B, S, S, 3) float32 crops in [0, 255], gated by the per-image scalars
(B, 8) = [do_blur, sigma, do_noise, do_cut, do_trunc, trunc_sel, th, tw] and
the cutout holes (B, NH, 4) = (x, y, w, h):

* on CUDA tensors: K4, ``csrc/fused_photometric.cu``, one pass;
* on CPU tensors: ``fused_photometric_plain``, the plain version, which
  follows the TPU kernel's order and arithmetic.

The noise is either given, one (B, S, S) plane per image shared by its
three channels (the TPU kernel's host-noise entry), or drawn from ``seed``
by a counter-based Philox4x32-10 keyed on (seed, b, pixel), one call per
pixel whose four words feed two Box-Muller pairs of 24-bit uniforms (the
TPU kernel's transform), independent per channel. The kernel draws it on
the card; ``philox_gaussian`` draws the same numbers in PyTorch for the CPU
path and for tests. These streams differ from the TPU
kernel's on-chip generator by design: the augmentation family is the same,
its random bits are not.

The kernel is built with nvcc at first use and raises on anything it does
not take; on a CUDA tensor it never falls back to the plain version.
``launch_count`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from ..utils.cuda_build import build_library
from .image_warp import IMAGENET_MEAN, IMAGENET_STD

SOURCES = ["fused_photometric.cu"]

launch_count = 0
_lib = None

_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_MASK32 = 0xFFFFFFFF


def _mulhilo32(a: int, b):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``a`` and
    the uint32 values in the int64 tensor ``b``, without int64 overflow."""
    p_lo = a * (b & 0xFFFF)  # < 2^48
    p_hi = a * (b >> 16)     # < 2^48
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (p_lo + ((p_hi & 0xFFFF) << 16)) & _MASK32
    return hi, lo


def philox4x32_10(c0, c1, c2, c3, k0, k1):
    """Philox4x32-10 (Salmon et al., SC'11) on int64 tensors holding uint32
    values: the four output words of counter (c0, c1, c2, c3) and key
    (k0, k1), as the kernel computes them."""
    for r in range(10):
        if r > 0:
            k0 = (k0 + _PHILOX_W[0]) & _MASK32
            k1 = (k1 + _PHILOX_W[1]) & _MASK32
        hi0, lo0 = _mulhilo32(_PHILOX_M[0], c0)
        hi1, lo1 = _mulhilo32(_PHILOX_M[1], c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_gaussian(seed, B: int, S: int, C: int = 3, device=None):
    """(B, S, S, C) float32 standard normals, C <= 4, the kernel's seeded
    stream: one Philox4x32-10 per pixel, of counter (y * S + x, b, 0, 0) and
    key (seed, 0), whose four words give u1 = (w0 >> 8) / 2^24 + 1e-7,
    u2 = (w1 >> 8) / 2^24, u3 = (w2 >> 8) / 2^24 + 1e-7 and
    u4 = (w3 >> 8) / 2^24, and two Box-Muller pairs r1 (cos, sin)(2 pi u2)
    and r2 (cos, sin)(2 pi u4), r = sqrt(-2 ln u), as channels 0-3. The two
    normals of a pair are independent, so every channel is. ``seed`` is an
    int or an integer tensor."""
    if not 1 <= C <= 4:
        raise ValueError(f"philox_gaussian draws 1 to 4 channels, not {C}")
    seed = torch.as_tensor(seed, dtype=torch.int64, device=device)
    i64 = dict(dtype=torch.int64, device=seed.device)
    shape = (B, S, S)
    zero = torch.zeros(shape, **i64)
    w = philox4x32_10(torch.arange(S * S, **i64).reshape(1, S, S).expand(shape),
                      torch.arange(B, **i64).reshape(B, 1, 1).expand(shape), zero, zero,
                      seed & _MASK32, torch.zeros((), **i64))
    u = [(word >> 8).to(torch.float32) * (1.0 / (1 << 24)) for word in w]
    r1 = torch.sqrt(-2.0 * torch.log(u[0] + 1e-7))
    r2 = torch.sqrt(-2.0 * torch.log(u[2] + 1e-7))
    a1, a2 = 2.0 * math.pi * u[1], 2.0 * math.pi * u[3]
    normals = (r1 * torch.cos(a1), r1 * torch.sin(a1), r2 * torch.cos(a2), r2 * torch.sin(a2))
    return torch.stack(normals[:C], dim=-1)


def fused_photometric_plain(images, scalars, holes, noise):
    """The chain in plain PyTorch, in the TPU kernel's order and arithmetic.
    ``noise`` is (B, S, S), shared by the channels, or (B, S, S, C)."""
    B, S, _, C = images.shape
    x = images.to(torch.float32)
    sc = scalars.to(torch.float32).reshape(B, 8, 1, 1, 1).unbind(1)
    dev = x.device
    rows = torch.arange(S, device=dev)[:, None]
    cols = torch.arange(S, device=dev)[None, :]

    row3 = x + torch.roll(x, 1, 1) + torch.roll(x, -1, 1)
    blur = (row3 + torch.roll(row3, 1, 2) + torch.roll(row3, -1, 2)) / 9.0
    interior = ((rows > 0) & (rows < S - 1) & (cols > 0) & (cols < S - 1))[None, :, :, None]
    x = x + (sc[0] > 0.5).float() * (torch.where(interior, blur, x) - x)

    g = noise.to(torch.float32)
    if g.dim() == 3:
        g = g[..., None]
    x = x + (sc[2] > 0.5).float() * g * sc[1]

    h = holes.to(torch.int64)[:, :, :, None, None]  # (B, NH, 4, 1, 1)
    hit = ((cols >= h[:, :, 0]) & (cols < h[:, :, 0] + h[:, :, 2])
           & (rows >= h[:, :, 1]) & (rows < h[:, :, 1] + h[:, :, 3])).any(dim=1)
    x = x * (1.0 - (sc[3] > 0.5).float() * hit[..., None].float())

    th, tw = sc[6].to(torch.int32)[..., 0], sc[7].to(torch.int32)[..., 0]  # (B, 1, 1)
    top = ((rows < th) | (cols < tw)).float()
    bottom = ((rows >= S - th) | (cols >= S - tw)).float()
    sel = sc[5][..., 0]
    tmask = torch.clamp((sel < 0.25).float() * top + (sel > 0.75).float() * bottom, 0.0, 1.0)
    x = x * (1.0 - (sc[4] > 0.5).float() * tmask[..., None])

    x = torch.clamp(x, 0.0, 255.0)
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=dev)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=dev)
    return (x / 255.0 - mean) / std


def load_library() -> ctypes.CDLL:
    """Build (first use only) and load K4's library."""
    global _lib
    if _lib is None:
        lib = build_library("fused_photometric", SOURCES)
        lib.spe_fused_photometric.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        lib.spe_fused_photometric.restype = ctypes.c_int
        lib.spe_photometric_error_string.argtypes = [ctypes.c_int]
        lib.spe_photometric_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def _launch(images, scalars, holes, seed, noise):
    """K4 on the current stream; returns the (B, S, S, 3) float32 result."""
    global launch_count
    if images.dim() != 4 or images.shape[1] != images.shape[2] or images.shape[3] != 3:
        raise ValueError(f"expected (B, S, S, 3) images, got {tuple(images.shape)}")
    B, S = images.shape[:2]
    dev = images.device
    if scalars.shape != (B, 8):
        raise ValueError(f"expected ({B}, 8) scalars, got {tuple(scalars.shape)}")
    if holes.dim() != 3 or holes.shape[0] != B or holes.shape[2] != 4:
        raise ValueError(f"expected ({B}, NH, 4) holes, got {tuple(holes.shape)}")
    img = images.to(torch.float32).contiguous()
    sc = scalars.to(device=dev, dtype=torch.float32).contiguous()
    hl = holes.to(device=dev, dtype=torch.int32).contiguous()
    noise_ptr = seed_ptr = None
    if noise is not None:
        if noise.shape != (B, S, S):
            raise ValueError(f"expected ({B}, {S}, {S}) noise, got {tuple(noise.shape)}")
        noise = noise.to(device=dev, dtype=torch.float32).contiguous()
        noise_ptr = noise.data_ptr()
    else:
        seed = torch.as_tensor(seed, dtype=torch.int64, device=dev).reshape(())
        seed_ptr = seed.data_ptr()
    out = torch.empty_like(img)
    lib = load_library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.spe_fused_photometric(img.data_ptr(), out.data_ptr(), sc.data_ptr(),
                                        hl.data_ptr(), noise_ptr, seed_ptr, B, S, hl.shape[1],
                                        stream)
    if err != 0:
        msg = lib.spe_photometric_error_string(err).decode()
        raise RuntimeError(f"photometric kernel launch failed: CUDA error {err} ({msg})")
    launch_count += 1
    return out


def fused_photometric_pallas(images, scalars, holes, seed, noise=None):
    """Apply the fused photometric chain: K4 on CUDA tensors, the plain
    version on CPU tensors (with ``philox_gaussian(seed)`` when no noise is
    given).

    Args:
        images: (B, S, S, 3) float32 in [0, 255].
        scalars: (B, 8) float32 per-image parameters.
        holes: (B, NH, 4) integer cutout holes (x, y, w, h).
        seed: int or integer tensor; used when ``noise`` is None.
        noise: optional (B, S, S) float32 noise planes, shared by channels.
    Returns:
        (B, S, S, 3) float32 ImageNet-normalised.
    """
    if images.device.type == "cuda":
        return _launch(images, scalars, holes, seed, noise)
    if images.device.type == "cpu":
        if noise is None:
            B, S = images.shape[:2]
            noise = philox_gaussian(seed, B, S, images.shape[3], images.device)
        return fused_photometric_plain(images, scalars, holes, noise)
    raise ValueError(f"the photometric chain runs on cpu or cuda, not {images.device}")
