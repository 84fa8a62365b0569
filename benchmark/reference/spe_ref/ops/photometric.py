"""Photometric corruptions of the train-time augmentation (counterpart of
ops/photometric.py), on batches of (N, S, S, 3) float RGB in [0, 255]:

* ``jpeg_artifacts`` — YCbCr, 4:2:0 chroma subsampling and an 8x8 DCT
  quantisation round trip with quality-scaled Annex-K tables;
* ``iso_noise`` — HLS conversion, rounded-normal Poisson luminance noise
  with lambda = std(L) * intensity * 255 and a gaussian hue shift;
* ``motion_blur`` / ``median_blur3`` / ``box_blur`` — the blur family.

Each random op is split into a *draw* (``*_draw``: a ``torch.Generator``
in, parameters and noise planes out) and an *apply* that takes everything
explicitly, so the same values can be fed to this module and to the JAX
one. Draws happen on the generator's device.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# ITU-T T.81 Annex K base quantization tables.
_Q_LUMA = np.asarray([
    [16, 11, 10, 16, 24, 40, 51, 61],
    [12, 12, 14, 19, 26, 58, 60, 55],
    [14, 13, 16, 24, 40, 57, 69, 56],
    [14, 17, 22, 29, 51, 87, 80, 62],
    [18, 22, 37, 56, 68, 109, 103, 77],
    [24, 35, 55, 64, 81, 104, 113, 92],
    [49, 64, 78, 87, 103, 121, 120, 101],
    [72, 92, 95, 98, 112, 100, 103, 99],
], np.float32)
_Q_CHROMA = np.asarray([
    [17, 18, 24, 47, 99, 99, 99, 99],
    [18, 21, 26, 66, 99, 99, 99, 99],
    [24, 26, 56, 99, 99, 99, 99, 99],
    [47, 66, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
    [99, 99, 99, 99, 99, 99, 99, 99],
], np.float32)


def _dct_matrix() -> np.ndarray:
    """Orthonormal 8x8 DCT-II matrix."""
    k = np.arange(8)
    C = np.cos((2 * k[None, :] + 1) * k[:, None] * np.pi / 16)
    C[0] *= 1 / np.sqrt(2)
    return (C * 0.5).astype(np.float32)


_DCT_NP = _dct_matrix()


def _quality_scale(quality):
    """libjpeg quality -> table scale percentage (jpeg_quality_scaling)."""
    q = torch.clamp(quality, 1.0, 100.0)
    return torch.where(q < 50.0, 5000.0 / q, 200.0 - 2.0 * q)


def _scaled_table(base: np.ndarray, quality):
    """(N, 8, 8) quantisation tables for the (N,) qualities."""
    base = torch.as_tensor(base, device=quality.device)
    scale = _quality_scale(quality)[:, None, None]
    return torch.clamp(torch.floor((base * scale + 50.0) / 100.0), 1.0, 255.0)


def _blockwise_quantize(plane, table):
    """8x8 blocked DCT -> quantize -> inverse DCT of (N, H, W) planes
    (H, W divisible by 8, level-shifted to 0) with (N, 8, 8) tables."""
    N, H, W = plane.shape
    dct = torch.as_tensor(_DCT_NP, device=plane.device)
    blocks = plane.reshape(N, H // 8, 8, W // 8, 8).permute(0, 1, 3, 2, 4)
    coef = torch.einsum("ij,nbcjk,lk->nbcil", dct, blocks, dct)
    t = table[:, None, None]
    coef = torch.round(coef / t) * t
    rec = torch.einsum("ji,nbcjk,kl->nbcil", dct, coef, dct)
    return rec.permute(0, 1, 3, 2, 4).reshape(N, H, W)


def _pad_to(x, mult: int):
    """Edge-pad (N, H, W, C) images to multiples of ``mult``; returns the
    padded batch and the original H, W."""
    H, W = x.shape[1:3]
    ph, pw = (-H) % mult, (-W) % mult
    if ph or pw:
        x = F.pad(x.permute(0, 3, 1, 2), (0, pw, 0, ph), mode="replicate").permute(0, 2, 3, 1)
    return x, H, W


def jpeg_artifacts(img, quality):
    """JPEG round trip of (N, H, W, 3) RGB [0, 255] images at the (N,)
    qualities: 4:2:0 chroma subsampling, quality-scaled Annex-K tables."""
    x, H, W = _pad_to(img.to(torch.float32), 16)
    quality = quality.to(torch.float32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.168736 * r - 0.331264 * g + 0.5 * b + 128.0
    cr = 0.5 * r - 0.418688 * g - 0.081312 * b + 128.0

    tl = _scaled_table(_Q_LUMA, quality)
    tc = _scaled_table(_Q_CHROMA, quality)
    y_q = _blockwise_quantize(y - 128.0, tl) + 128.0

    def sub(c):  # 2x2 average pool
        n, h, w = c.shape
        return c.reshape(n, h // 2, 2, w // 2, 2).mean(dim=(2, 4))

    def up(c):  # nearest upsample
        return c.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)

    cb_q = up(_blockwise_quantize(sub(cb) - 128.0, tc) + 128.0)
    cr_q = up(_blockwise_quantize(sub(cr) - 128.0, tc) + 128.0)

    r2 = y_q + 1.402 * (cr_q - 128.0)
    g2 = y_q - 0.344136 * (cb_q - 128.0) - 0.714136 * (cr_q - 128.0)
    b2 = y_q + 1.772 * (cb_q - 128.0)
    out = torch.stack([r2, g2, b2], dim=-1)[:, :H, :W]
    return torch.clamp(out, 0.0, 255.0)


def _rgb_to_hls(img01):
    r, g, b = img01[..., 0], img01[..., 1], img01[..., 2]
    mx = torch.maximum(torch.maximum(r, g), b)
    mn = torch.minimum(torch.minimum(r, g), b)
    l = (mx + mn) / 2.0
    d = mx - mn
    denom_s = torch.where(l <= 0.5, mx + mn, 2.0 - mx - mn)
    s = torch.where(d > 0, d / torch.clamp_min(denom_s, 1e-12), 0.0)
    dd = torch.clamp_min(d, 1e-12)
    h = torch.where(mx == r, (g - b) / dd,
                    torch.where(mx == g, 2.0 + (b - r) / dd, 4.0 + (r - g) / dd))
    h = torch.where(d > 0, torch.remainder(h * 60.0, 360.0), 0.0)
    return h, l, s


def _hls_to_rgb(h, l, s):
    c = (1.0 - torch.abs(2.0 * l - 1.0)) * s
    hp = torch.remainder(h, 360.0) / 60.0
    x = c * (1.0 - torch.abs(torch.remainder(hp, 2.0) - 1.0))
    z = torch.zeros_like(c)
    sextants = [(c, x, z), (x, c, z), (z, c, x), (z, x, c), (x, z, c), (c, z, x)]
    r, g, b = z, z, z
    for i in reversed(range(6)):  # the first sextant whose bound holds wins
        take = hp < i + 1 if i < 5 else hp >= 5
        rr, gg, bb = sextants[i]
        r, g, b = (torch.where(take, rr, r), torch.where(take, gg, g),
                   torch.where(take, bb, b))
    m = l - c / 2.0
    return torch.stack([r + m, g + m, b + m], dim=-1)


def iso_noise_draw(generator, n: int, size: int, color_shift=(0.01, 0.05),
                   intensity=(0.1, 0.5)):
    """Draw (color_shift (n,), intensity (n,), lum_normal (n, S, S),
    hue_normal (n, S, S)) for ``iso_noise``."""
    dev = generator.device
    u = torch.rand(2, n, generator=generator, device=dev, dtype=torch.float32)
    cs = color_shift[0] + (color_shift[1] - color_shift[0]) * u[0]
    it = intensity[0] + (intensity[1] - intensity[0]) * u[1]
    normals = torch.randn(2, n, size, size, generator=generator, device=dev,
                          dtype=torch.float32)
    return cs, it, normals[0], normals[1]


def iso_noise(img, color_shift, intensity, lum_normal, hue_normal):
    """Camera-sensor (ISO) noise on (N, S, S, 3) RGB [0, 255] images:
    luminance noise round(lam + sqrt(lam) * lum_normal) >= 0 with
    lam = std(L) * intensity * 255, applied as (n / 255) * (1 - L), and a hue
    shift hue_normal * color_shift * 360 * intensity."""
    h, l, s = _rgb_to_hls(img / 255.0)
    stddev = torch.std(l, dim=(1, 2), correction=0)
    lam = torch.clamp_min(stddev * intensity * 255.0, 1e-6)[:, None, None]
    lum_noise = torch.clamp_min(torch.round(lam + torch.sqrt(lam) * lum_normal), 0.0)
    color_noise = hue_normal * (color_shift * 360.0 * intensity)[:, None, None]
    h = torch.remainder(h + color_noise, 360.0)
    l = torch.clamp(l + (lum_noise / 255.0) * (1.0 - l), 0.0, 1.0)
    return torch.clamp(_hls_to_rgb(h, l, s) * 255.0, 0.0, 255.0)


def _depthwise(img, kernel):
    """(N, S, S, 3) 'SAME' zero-padded correlation with one odd (k, k)
    kernel shared by all images, or one (N, k, k) kernel per image, shared
    across channels."""
    N, S1, S2, C = img.shape
    kernel = kernel.to(torch.float32)
    if kernel.dim() == 2:
        kernel = kernel.expand(N, -1, -1)
    k = kernel.shape[-1]
    x = img.to(torch.float32).permute(0, 3, 1, 2).reshape(1, N * C, S1, S2)
    w = kernel[:, None].expand(N, C, k, k).reshape(N * C, 1, k, k)
    out = F.conv2d(x, w, padding=k // 2, groups=N * C)
    return out.reshape(N, C, S1, S2).permute(0, 2, 3, 1)


def motion_blur_draw(generator, n: int, max_ksize: int = 7):
    """Draw (ksize (n,), theta (n,)): an odd length in [3, max_ksize] and a
    uniform angle in [0, pi)."""
    dev = generator.device
    n_sizes = (max_ksize - 3) // 2 + 1
    ksize = 3.0 + 2.0 * torch.randint(0, n_sizes, (n,), generator=generator,
                                      device=dev).to(torch.float32)
    theta = torch.rand(n, generator=generator, device=dev, dtype=torch.float32) * math.pi
    return ksize, theta


def motion_blur_kernel(ksize, theta, max_ksize: int = 7):
    """(n, max_ksize, max_ksize) directed-line kernels: the cells within half
    a cell of the line through the centre at ``theta``, clipped to the
    ksize x ksize box, normalised to sum 1."""
    c = (max_ksize - 1) / 2.0
    ar = torch.arange(max_ksize, dtype=torch.float32, device=theta.device)
    dy = (ar[:, None] - c).expand(max_ksize, max_ksize)
    dx = (ar[None, :] - c).expand(max_ksize, max_ksize)
    dirx = torch.cos(theta)[:, None, None]
    diry = torch.sin(theta)[:, None, None]
    across = torch.abs(-dx * diry + dy * dirx)
    half = ((ksize - 1.0) / 2.0)[:, None, None]
    cheb = torch.maximum(torch.abs(dx), torch.abs(dy))
    on = ((across <= 0.5) & (cheb <= half + 1e-3)).to(torch.float32)
    return on / torch.clamp_min(on.sum(dim=(1, 2), keepdim=True), 1.0)


def motion_blur(img, ksize, theta, max_ksize: int = 7):
    return _depthwise(img, motion_blur_kernel(ksize, theta, max_ksize))


def median_blur3(img):
    """3x3 median filter (cv2.medianBlur(3), BORDER_REPLICATE)."""
    S1, S2 = img.shape[1:3]
    p = F.pad(img.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="replicate").permute(0, 2, 3, 1)
    stack = torch.stack([p[:, di:di + S1, dj:dj + S2]
                         for di in range(3) for dj in range(3)])
    return torch.sort(stack, dim=0).values[4]


def box_blur(img, ksize: int = 3):
    kernel = torch.full((ksize, ksize), 1.0 / (ksize * ksize), dtype=torch.float32,
                        device=img.device)
    return _depthwise(img, kernel)
