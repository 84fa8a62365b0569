"""Device-resident image warping (counterpart of ops/image_warp.py).

* ``crop_resize_cubic_mxu`` — fused crop + cubic resize + ImageNet
  normalisation of a batch of uint8 canvases, as OUT = Wy @ IMG @ Wx^T per
  image and channel. Catmull-Rom taps (a = -0.75, cv2's cubic kernel) with
  cv2's half-pixel coordinate mapping, edge replication at the crop border
  and zeros outside the real image, exactly as the JAX function.
* ``upsample_bilinear_align_corners`` — torch ``UpsamplingBilinear2d``
  semantics as two dense per-axis matmuls whose weights take the input's
  dtype, as the JAX version does.
* ``rotate_shear3_bmm`` — the train-time rotation of a batch of crops about
  their centres, as the Paeth three-shear decomposition with the JAX
  version's widened canvas and cv2 ``BORDER_CONSTANT`` taps. The JAX version
  writes each shear as a dense per-row matrix product (a TPU form); here each
  output sample gathers its 2 (bilinear) or 4 (cubic) taps, which are the
  only non-zero entries of that matrix.
* ``rotate_shear3`` — the same three shears with the JAX ``rotate_shear3``
  ("shear" form) border rule, the semantics of the rotation kernel
  (ops/pallas_rotate.py); it differs from ``rotate_shear3_bmm`` at content
  edges.
* ``affine_warp_bilinear`` / ``affine_warp_cubic`` — inverse-affine
  bilinear / bicubic (cv2 INTER_CUBIC) warp of a batch, one (2, 3)
  output-to-source matrix per image, taps outside the image zero.
* ``resize_bicubic_torch`` / ``resize_bilinear_torch`` — feature-map
  resizes with torch's ``F.interpolate(align_corners=False)`` semantics
  (half-pixel centres, no antialiasing) as two dense per-axis matmuls
  whose weights take the input's dtype, as the JAX versions write them.
"""
from __future__ import annotations

import numpy as np
import torch

from .precision import highest_precision

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_TAP_OFFSETS = (-1.0, 0.0, 1.0, 2.0)


def _cubic_weights(t, a=-0.75):
    """Cubic kernel weights (..., 4) for taps at offsets (-1, 0, 1, 2)
    relative to floor(x), with t = frac(x)."""
    def k(s):
        s = torch.abs(s)
        w1 = ((a + 2.0) * s - (a + 3.0)) * s * s + 1.0  # |s| <= 1
        w2 = ((a * s - 5.0 * a) * s + 8.0 * a) * s - 4.0 * a  # 1 < |s| < 2
        return torch.where(s <= 1.0, w1, torch.where(s < 2.0, w2, 0.0))

    return torch.stack([k(t + 1.0), k(t), k(1.0 - t), k(2.0 - t)], dim=-1)


def _axis_samples(out_size, c0, c1):
    """Source coordinates (B, S) for one axis: c0 + (d+0.5)*scale - 0.5."""
    scale = (c1 - c0) / out_size
    d = torch.arange(out_size, dtype=torch.float32, device=c0.device)
    return c0[:, None] + (d[None, :] + 0.5) * scale[:, None] - 0.5


def _gather_taps_1d(coords, canvas_lo, canvas_hi, img_extent):
    """Tap indices (B, S, 4), inside-image mask (B, S, 4) and cubic weights
    (B, S, 4) for fractional source coordinates (B, S)."""
    base = torch.floor(coords)
    w = _cubic_weights(coords - base)
    offsets = torch.tensor(_TAP_OFFSETS, dtype=coords.dtype, device=coords.device)
    taps = base[..., None] + offsets
    # Replicate at the crop edge (cv2.resize border behaviour on the crop).
    lo = torch.ceil(canvas_lo)[:, None, None]
    hi = torch.floor(canvas_hi - 1e-3)[:, None, None]
    taps = torch.minimum(torch.maximum(taps, lo), hi)
    # Zero outside the real image (pad-to-square canvas contract).
    inside = (taps >= 0) & (taps <= img_extent - 1)
    idx = torch.clamp(taps, 0, img_extent - 1).to(torch.int64)
    return idx, inside.to(torch.float32), w


def _axis_weight_matrix(out_size, c0, c1, extent):
    """Dense (B, out_size, extent) cubic interpolation matrix for one axis;
    row i holds the 4 tap weights of output sample i (repeated clipped
    taps add up, as the JAX one-hot contraction does)."""
    coords = _axis_samples(out_size, c0, c1)
    idx, inside, w = _gather_taps_1d(coords, c0, c1, extent)
    wm = (w * inside).reshape(coords.shape[0], -1)
    mat = torch.zeros(coords.shape[0], out_size, extent,
                      dtype=torch.float32, device=coords.device)
    flat = mat.view(coords.shape[0], out_size * extent)
    rows = torch.arange(out_size, device=coords.device)[None, :, None] * extent
    flat.scatter_add_(1, (rows + idx).reshape(coords.shape[0], -1), wm)
    return mat


@highest_precision()
def crop_resize_cubic_mxu(image, clip_bbox, out_size=256, normalize=True):
    """Fused crop + cubic resize (+ /255 and ImageNet normalisation).

    Args:
        image: (B, H, W, 3) uint8 or float canvases.
        clip_bbox: (B, 4) float [x1, y1, x2, y2] crop boxes in canvas
            pixels; they may extend beyond the image (outside reads zero).
        out_size: output side length S.
    Returns:
        (B, S, S, 3) float32.
    """
    _, H, W, _ = image.shape
    img = image.to(torch.float32)
    bb = clip_bbox.to(torch.float32)
    Wx = _axis_weight_matrix(out_size, bb[:, 0], bb[:, 2], W)  # (B, S, W)
    Wy = _axis_weight_matrix(out_size, bb[:, 1], bb[:, 3], H)  # (B, S, H)
    horiz = torch.einsum("bsw,bhwc->bhsc", Wx, img)  # (B, H, S, 3)
    out = torch.einsum("bsh,bhtc->bstc", Wy, horiz)  # (B, S, S, 3)
    if normalize:
        mean = torch.tensor(IMAGENET_MEAN, dtype=out.dtype, device=out.device)
        std = torch.tensor(IMAGENET_STD, dtype=out.dtype, device=out.device)
        out = (out / 255.0 - mean) / std
    return out


def _shear_weights(d, cubic: bool):
    """Interpolation weight of a tap at signed distance ``d``: the bilinear
    tent or cv2's INTER_CUBIC Keys kernel (a = -0.75), in the JAX
    ``_shear_rows_bmm`` form."""
    ad = torch.abs(d)
    if not cubic:
        return torch.clamp(1.0 - ad, 0.0, 1.0)
    a = -0.75
    near = (a + 2.0) * ad ** 3 - (a + 3.0) * ad ** 2 + 1.0
    far = a * ad ** 3 - 5.0 * a * ad ** 2 + 8.0 * a * ad - 4.0 * a
    return torch.where(ad <= 1.0, near, torch.where(ad < 2.0, far, 0.0))


def _shear_rows_bmm(im, shifts, out_w: int, cubic: bool):
    """Per-row fractional shift of (N, R, Win, C) rows by ``shifts`` (N, R):
    out[n, r, x] = sum_w K(x + shifts[n, r] - w) * im[n, r, w], taps outside
    [0, Win) reading zero. Returns (N, R, out_w, C) float32."""
    N, R, in_w, C = im.shape
    x = torch.arange(out_w, dtype=torch.float32, device=im.device)
    src = x + shifts[..., None]  # (N, R, out_w)
    offsets = (-1.0, 0.0, 1.0, 2.0) if cubic else (0.0, 1.0)
    taps = torch.floor(src)[..., None] + torch.tensor(offsets, dtype=torch.float32,
                                                      device=im.device)
    w = _shear_weights(src[..., None] - taps, cubic)
    w = w * ((taps >= 0) & (taps <= in_w - 1))
    idx = torch.clamp(taps, 0, in_w - 1).to(torch.int64)
    idx = idx.reshape(N, R, -1, 1).expand(-1, -1, -1, C)
    vals = torch.gather(im, 2, idx).reshape(N, R, out_w, len(offsets), C)
    return (w[..., None] * vals).sum(dim=3)


def rotate_shear3_bmm(image, theta, cubic: bool = False):
    """Rotate (N, S, S, C) crops about their centre (S-1)/2 by ``theta`` (N,)
    radians, |theta| <= pi/2, in the direction of the keypoint map
    kp' = R(theta)(kp - c) + c: R(t) = Shx(a) Shy(b) Shx(a) with
    a = -tan(t/2), b = sin(t), on a canvas widened to S + 2 * ceil(S/2) so
    that nothing landing in the output is clipped. Returns float32."""
    N, S = image.shape[0], image.shape[1]
    img = image.to(torch.float32)
    theta = theta.to(torch.float32)
    c = (S - 1.0) / 2.0
    a = -torch.tan(theta / 2.0)[:, None]
    b = torch.sin(theta)[:, None]
    pad = (S + 1) // 2
    Wp = S + 2 * pad
    y = torch.arange(S, dtype=torch.float32, device=img.device)
    xp = torch.arange(Wp, dtype=torch.float32, device=img.device)

    out1 = _shear_rows_bmm(img, -pad - a * (y - c), Wp, cubic)  # (N, S, Wp, C)
    out2 = _shear_rows_bmm(out1.transpose(1, 2), -b * (xp - (c + pad)), S,
                           cubic).transpose(1, 2)  # (N, S, Wp, C)
    return _shear_rows_bmm(out2, pad - a * (y - c), S, cubic)  # (N, S, S, C)


def _shear_rows(im, shifts, out_w: int, lo: int, hi: int, cubic: bool):
    """Per-row fractional shift of (N, R, Win, C) rows by ``shifts`` (N, R)
    with the JAX ``_shear_rows`` semantics: out[n, r, x] blends the 2 or 4
    taps around base = x + clip(floor(shifts[n, r]), lo, hi), taps outside
    [0, Win) reading zero, and is zero outright once the base tap itself
    leaves [0, Win). Returns (N, R, out_w, C) float32."""
    N, R, in_w, C = im.shape
    m = torch.floor(shifts)
    t = shifts - m
    base = torch.arange(out_w, dtype=torch.float32, device=im.device) \
        + torch.clamp(m, lo, hi)[..., None]  # (N, R, out_w)
    if cubic:
        w = _cubic_weights(t)[:, :, None, :]
        offsets = _TAP_OFFSETS
    else:
        w = torch.stack([1.0 - t, t], dim=-1)[:, :, None, :]
        offsets = (0.0, 1.0)
    taps = base[..., None] + torch.tensor(offsets, dtype=torch.float32, device=im.device)
    inside = (taps >= 0) & (taps <= in_w - 1)
    idx = torch.clamp(taps, 0, in_w - 1).to(torch.int64).reshape(N, R, -1, 1).expand(-1, -1, -1, C)
    vals = torch.gather(im, 2, idx).reshape(N, R, out_w, len(offsets), C)
    vals = vals * inside[..., None]
    out = w[..., 0, None] * vals[..., 0, :]
    for j in range(1, len(offsets)):
        out = out + w[..., j, None] * vals[..., j, :]
    return out * ((base >= 0) & (base <= in_w - 1))[..., None]


def rotate_shear3(image, theta, cubic: bool = False):
    """Rotate (N, S, S, C) crops about their centres by ``theta`` (N,)
    radians, |theta| <= pi/2: the JAX ``rotate_shear3`` (the "shear" form,
    and the semantics of its Pallas kernel ``rotate_shear3_pallas``) as a
    plain gather. Same shears, canvas and taps as ``rotate_shear3_bmm``; the
    two differ at content edges only: here a sample is zero once its base
    tap floor(x + shift) leaves the input row, where the bmm form keeps that
    sample's taps that still lie inside. Returns float32."""
    N, S = image.shape[0], image.shape[1]
    img = image.to(torch.float32)
    theta = theta.to(torch.float32)
    c = (S - 1.0) / 2.0
    a = -torch.tan(theta / 2.0)[:, None]
    b = torch.sin(theta)[:, None]
    pad = (S + 1) // 2
    Wp = S + 2 * pad
    y = torch.arange(S, dtype=torch.float32, device=img.device)
    xp = torch.arange(Wp, dtype=torch.float32, device=img.device)

    out1 = _shear_rows(img, -pad - a * (y - c), Wp, -S - 1, 0, cubic)  # (N, S, Wp, C)
    out2 = _shear_rows(out1.transpose(1, 2), -b * (xp - (c + pad)), S, -S - 1, S + 1,
                       cubic).transpose(1, 2)  # (N, S, Wp, C)
    return _shear_rows(out2, pad - a * (y - c), S, -1, S + 1, cubic)  # (N, S, S, C)


def affine_warp_bilinear(images, matrices, out_size: int = 256, normalize: bool = True):
    """Inverse-affine bilinear warp of a batch: out[b, y, x] =
    img_b(M_b @ [x, y, 1]) with (B, 2, 3) output-to-source ``matrices`` in
    pixel coordinates; each of the four taps outside the image reads zero.
    (B, H, W, C) -> (B, S, S, C) float32, optionally /255 and
    ImageNet-normalised."""
    B, H, W, C = images.shape
    flat = images.to(torch.float32).reshape(B, H * W, C)
    m = matrices.to(torch.float32)[:, :, :, None, None]  # (B, 2, 3, 1, 1)
    d = torch.arange(out_size, dtype=torch.float32, device=images.device)
    dx, dy = d[None, :], d[:, None]
    sx = m[:, 0, 0] * dx + m[:, 0, 1] * dy + m[:, 0, 2]  # (B, S, S)
    sy = m[:, 1, 0] * dx + m[:, 1, 1] * dy + m[:, 1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    tx, ty = sx - x0, sy - y0

    def sample(xi, yi):
        inside = (xi >= 0) & (xi <= W - 1) & (yi >= 0) & (yi <= H - 1)
        xc = torch.clamp(xi, 0, W - 1).to(torch.int64)
        yc = torch.clamp(yi, 0, H - 1).to(torch.int64)
        idx = (yc * W + xc).reshape(B, -1, 1).expand(-1, -1, C)
        v = torch.gather(flat, 1, idx).reshape(B, out_size, out_size, C)
        return v * inside[..., None]

    out = (sample(x0, y0) * ((1 - tx) * (1 - ty))[..., None]
           + sample(x0 + 1, y0) * (tx * (1 - ty))[..., None]
           + sample(x0, y0 + 1) * ((1 - tx) * ty)[..., None]
           + sample(x0 + 1, y0 + 1) * (tx * ty)[..., None])
    if normalize:
        mean = torch.tensor(IMAGENET_MEAN, dtype=out.dtype, device=out.device)
        std = torch.tensor(IMAGENET_STD, dtype=out.dtype, device=out.device)
        out = (out / 255.0 - mean) / std
    return out


def affine_warp_cubic(images, matrices, out_size: int = 256, normalize: bool = False):
    """Inverse-affine bicubic warp of a batch (the JAX ``affine_warp_cubic``,
    cv2.warpAffine INTER_CUBIC with BORDER_CONSTANT 0): out[b, y, x] =
    img_b(M_b @ [x, y, 1]) through separable 4 x 4 Catmull-Rom taps
    (a = -0.75), each tap outside the image reading zero. (B, H, W, C) ->
    (B, S, S, C) float32, optionally /255 and ImageNet-normalised."""
    B, H, W, C = images.shape
    flat = images.to(torch.float32).reshape(B, H * W, C)
    m = matrices.to(torch.float32)[:, :, :, None, None]  # (B, 2, 3, 1, 1)
    d = torch.arange(out_size, dtype=torch.float32, device=images.device)
    dx, dy = d[None, :], d[:, None]
    sx = m[:, 0, 0] * dx + m[:, 0, 1] * dy + m[:, 0, 2]  # (B, S, S)
    sy = m[:, 1, 0] * dx + m[:, 1, 1] * dy + m[:, 1, 2]
    x0, y0 = torch.floor(sx), torch.floor(sy)
    wx, wy = _cubic_weights(sx - x0), _cubic_weights(sy - y0)  # (B, S, S, 4)
    out = torch.zeros(B, out_size, out_size, C, dtype=torch.float32, device=images.device)
    for j in range(4):  # y taps
        yi = y0 + (j - 1.0)
        in_y = (yi >= 0) & (yi <= H - 1)
        yc = torch.clamp(yi, 0, H - 1).to(torch.int64)
        row = torch.zeros_like(out)
        for i in range(4):  # x taps
            xi = x0 + (i - 1.0)
            in_x = (xi >= 0) & (xi <= W - 1)
            xc = torch.clamp(xi, 0, W - 1).to(torch.int64)
            idx = (yc * W + xc).reshape(B, -1, 1).expand(-1, -1, C)
            v = torch.gather(flat, 1, idx).reshape(B, out_size, out_size, C)
            row = row + v * (in_x & in_y)[..., None] * wx[..., i, None]
        out = out + row * wy[..., j, None]
    if normalize:
        mean = torch.tensor(IMAGENET_MEAN, dtype=out.dtype, device=out.device)
        std = torch.tensor(IMAGENET_STD, dtype=out.dtype, device=out.device)
        out = (out / 255.0 - mean) / std
    return out


def _align_corners_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) linear-interpolation matrix with
    align_corners=True: output i samples input i*(n_in-1)/(n_out-1)."""
    if n_in == 1 or n_out == 1:
        return np.full((n_out, n_in), 1.0 / n_in, np.float32)
    pos = np.arange(n_out) * (n_in - 1) / (n_out - 1)
    lo = np.minimum(np.floor(pos).astype(np.int64), n_in - 2)
    frac = (pos - lo).astype(np.float32)
    mat = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    mat[rows, lo] = 1.0 - frac
    mat[rows, lo + 1] += frac
    return mat


def upsample_bilinear_align_corners(x, scale: int = 2):
    """torch ``nn.UpsamplingBilinear2d(scale)`` (align_corners=True) on an
    NCHW tensor: (B, C, H, W) -> (B, C, H*scale, W*scale)."""
    _, _, h, w = x.shape
    my = torch.as_tensor(_align_corners_matrix(h, h * scale), device=x.device).to(x.dtype)
    mx = torch.as_tensor(_align_corners_matrix(w, w * scale), device=x.device).to(x.dtype)
    y = torch.einsum("ph,bchw->bcpw", my, x)
    return torch.einsum("qw,bcpw->bcpq", mx, y)


def _halfpixel_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) linear-interpolation matrix with half-pixel
    centres, edge-clamped and without antialiasing (torch ``bilinear``,
    ``align_corners=False``), weights formed in float64."""
    pos = np.clip((np.arange(n_out) + 0.5) * n_in / n_out - 0.5, 0.0, n_in - 1)
    lo = np.minimum(np.floor(pos).astype(np.int64), max(n_in - 2, 0))
    frac = (pos - lo).astype(np.float32)
    mat = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    mat[rows, lo] = 1.0 - frac
    mat[rows, np.minimum(lo + 1, n_in - 1)] += frac
    return mat


def _halfpixel_cubic_matrix(n_in: int, n_out: int) -> np.ndarray:
    """Dense (n_out, n_in) bicubic matrix (a = -0.75) with half-pixel
    centres, edge-clamped taps and no antialiasing (torch ``bicubic``,
    ``align_corners=False``), weights formed in float64."""
    a = -0.75

    def k(d):
        d = np.abs(d)
        near = ((a + 2.0) * d - (a + 3.0)) * d * d + 1.0
        far = ((a * d - 5.0 * a) * d + 8.0 * a) * d - 4.0 * a
        return np.where(d <= 1.0, near, np.where(d < 2.0, far, 0.0))

    pos = (np.arange(n_out) + 0.5) * n_in / n_out - 0.5
    base = np.floor(pos).astype(np.int64)
    frac = pos - base
    w = np.stack([k(frac + 1.0), k(frac), k(1.0 - frac), k(2.0 - frac)], -1)
    mat = np.zeros((n_out, n_in), np.float32)
    for tap in range(4):
        np.add.at(mat, (np.arange(n_out), np.clip(base - 1 + tap, 0, n_in - 1)),
                  w[:, tap].astype(np.float32))
    return mat


def _resize(x, my: np.ndarray, mx: np.ndarray):
    """Y = My @ X @ Mx^T per (batch, channel) plane of an NCHW tensor, the
    matrices in x's dtype."""
    my = torch.as_tensor(my, device=x.device).to(x.dtype)
    mx = torch.as_tensor(mx, device=x.device).to(x.dtype)
    return torch.einsum("qw,bcpw->bcpq", mx, torch.einsum("ph,bchw->bcpw", my, x))


def resize_bicubic_torch(x, out_h: int, out_w: int):
    """``F.interpolate(mode="bicubic", align_corners=False)`` of an NCHW
    tensor to (out_h, out_w), as two per-axis matrix products: the RT-DETR
    PAN's 0.5x downsample. (PyTorch's CUDA bicubic kernel gives each thread
    one output pixel and loops over batch and channels.)"""
    _, _, h, w = x.shape
    return _resize(x, _halfpixel_cubic_matrix(h, out_h), _halfpixel_cubic_matrix(w, out_w))


def resize_bilinear_torch(x, out_h: int, out_w: int):
    """``F.interpolate(mode="bilinear", align_corners=False)`` of an NCHW
    tensor to (out_h, out_w), as two per-axis matrix products."""
    _, _, h, w = x.shape
    return _resize(x, _halfpixel_matrix(h, out_h), _halfpixel_matrix(w, out_w))
