"""Train-time augmentation on the device (counterpart of data/augment.py
``augment_batch``), driven by an explicit ``torch.Generator``:

1. flip / scale / shift / crop-resize fold into one separable warp per
   image: two dense per-axis interpolation matrices (``_axis_matrix``)
   applied as batched matrix products;
2. a fixed-count subset of round(p_rotate * B) images is rotated about the
   crop centre, keypoints with it: ``rotate_impl="bmm"``
   (``ops.image_warp.rotate_shear3_bmm``), ``"pallas"``
   (``ops.pallas_rotate.rotate_shear3_pallas``: the rotation kernel K3 on
   the GPU, the "shear" semantics) or ``"shear"``
   (``ops.image_warp.rotate_shear3``) for limits up to 90 degrees;
   ``"gather"``, and any route past 90 degrees, takes the inverse-affine
   warp (``affine_warp_cubic`` or ``affine_warp_bilinear``);
3. the photometric family (blur, motion / median / box blur, gaussian
   noise, JPEG, ISO noise, cutout, edge truncation) runs on fixed-count
   subsets (``_apply_subset``);
4. ImageNet normalisation.

``augment_batch_pallas`` is the JAX package's fused variant: one bilinear
affine warp per image (flip, rotation and scale / shift in one matrix), then
blur, noise, cutout, truncation and normalisation in one pass of the
photometric kernel K4 (``ops.pallas_augment``). ``augment_sample`` augments
one sample: one affine warp, then the whole corruption family, each op
gated by its own draw.

Keypoints ride the same maps analytically. Every draw comes from the
generator, on its device (the images' device); the draws and their
application are separate functions (``geometry_draw``,
``pallas_augment_draw``, ``sample_draw``), so a test can replay another
generator's draws.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from ..ops.image_warp import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    _cubic_weights,
    affine_warp_bilinear,
    affine_warp_cubic,
    rotate_shear3,
    rotate_shear3_bmm,
)
from ..ops.photometric import (
    box_blur,
    iso_noise,
    iso_noise_draw,
    jpeg_artifacts,
    median_blur3,
    motion_blur,
    motion_blur_draw,
)
from ..ops.precision import highest_precision


class AugmentConfig(NamedTuple):
    """The JAX ``AugmentConfig``, field for field."""
    out_size: int = 256
    interp: str = "bilinear"  # or "cubic" (cv2 INTER_CUBIC taps)
    p_hflip: float = 0.5
    p_rotate: float = 0.4
    rotate_limit_deg: float = 90.0
    p_affine: float = 0.1
    affine_scale_jitter: float = 0.1
    affine_shift_jitter: float = 0.05
    p_blur: float = 0.3
    p_blur_family: float = 0.2  # OneOf(motion .5, median .25, box .25)
    motion_blur_max_ksize: int = 7
    p_noise: float = 0.2
    noise_sigma_max: float = 12.75
    p_jpeg: float = 0.1
    jpeg_quality_min: float = 20.0
    jpeg_quality_max: float = 99.0
    p_iso: float = 0.2
    iso_color_shift: Tuple[float, float] = (0.01, 0.05)
    iso_intensity: Tuple[float, float] = (0.1, 0.5)
    p_cutout: float = 0.1
    cutout_holes: int = 10
    cutout_max: int = 40
    p_trunc: float = 0.2
    trunc_ratio: float = 0.2
    rotate_impl: str = "bmm"  # or "pallas" (K3), "shear", "gather" (the affine warp)


def _uniform(generator, shape, lo, hi):
    return lo + (hi - lo) * torch.rand(shape, generator=generator, device=generator.device,
                                     dtype=torch.float32)


def _apply_subset(generator, imgs, p: float, fn, draw=None):
    """Apply ``fn(sub, params)`` to exactly round(p * B) images chosen
    uniformly without replacement, ``params`` = ``draw(generator, n)`` (a
    tuple of tensors with n leading rows, or None): the marginal
    probability per image is p, only the count is fixed."""
    B = imgs.shape[0]
    n = int(round(p * B))
    if n == 0:
        return imgs
    idx = torch.randperm(B, generator=generator, device=generator.device)[:n]
    params = draw(generator, n) if draw is not None else ()
    return imgs.index_copy(0, idx, fn(imgs[idx], *params))


def _cutout(x, holes_xy, holes_wh):
    """Zero the union of rectangles [x0, x0 + w) x [y0, y0 + h) per image;
    holes_xy, holes_wh (n, holes, 2) integers."""
    S = x.shape[1]
    ar = torch.arange(S, device=x.device)
    x0, y0 = holes_xy[..., 0, None, None], holes_xy[..., 1, None, None]
    w, h = holes_wh[..., 0, None, None], holes_wh[..., 1, None, None]
    xx, yy = ar[None, None, None, :], ar[None, None, :, None]
    hit = (xx >= x0) & (xx < x0 + w) & (yy >= y0) & (yy < y0 + h)
    return torch.where(hit.any(dim=1)[..., None], 0.0, x)


def _truncate(x, th, tw, u):
    """Edge blanking: for u < 0.25 the top th rows and left tw columns, for
    u > 0.75 the bottom th rows and right tw columns; th, tw, u (n,)."""
    S = x.shape[1]
    ar = torch.arange(S, device=x.device)
    xx, yy = ar[None, None, :], ar[None, :, None]
    th, tw, u = th[:, None, None], tw[:, None, None], u[:, None, None]
    top = (yy < th) | (xx < tw)
    bottom = (yy >= S - th) | (xx >= S - tw)
    mask = torch.where(u < 0.25, top, (u > 0.75) & bottom)
    return torch.where(mask[..., None], 0.0, x)


def _photometric_batch(generator, imgs, cfg: AugmentConfig):
    """The corruption family on (B, S, S, 3) crops in [0, 255]."""
    S = cfg.out_size
    g = generator
    imgs = _apply_subset(g, imgs, cfg.p_blur, box_blur)
    k = cfg.motion_blur_max_ksize
    imgs = _apply_subset(g, imgs, cfg.p_blur_family * 0.5,
                         lambda x, ksize, theta: motion_blur(x, ksize, theta, k),
                         lambda g, n: motion_blur_draw(g, n, k))
    imgs = _apply_subset(g, imgs, cfg.p_blur_family * 0.25, median_blur3)
    imgs = _apply_subset(g, imgs, cfg.p_blur_family * 0.25, box_blur)

    def noise_draw(g, n):
        sigma = _uniform(g, (n, 1, 1, 1), 0.0, cfg.noise_sigma_max)
        return (torch.randn((n,) + imgs.shape[1:], generator=g, device=g.device,
                            dtype=torch.float32) * sigma,)

    imgs = _apply_subset(g, imgs, cfg.p_noise, lambda x, noise: x + noise, noise_draw)
    imgs = _apply_subset(g, imgs, cfg.p_jpeg, lambda x, quality: jpeg_artifacts(
        torch.clamp(x, 0.0, 255.0), quality),
        lambda g, n: (_uniform(g, (n,), cfg.jpeg_quality_min, cfg.jpeg_quality_max),))
    imgs = _apply_subset(g, imgs, cfg.p_iso, lambda x, *iso: iso_noise(
        torch.clamp(x, 0.0, 255.0), *iso),
        lambda g, n: iso_noise_draw(g, n, S, cfg.iso_color_shift, cfg.iso_intensity))

    def cutout_draw(g, n):
        dev = g.device
        return (torch.randint(0, S, (n, cfg.cutout_holes, 2), generator=g, device=dev),
                torch.randint(1, cfg.cutout_max, (n, cfg.cutout_holes, 2), generator=g,
                              device=dev))

    imgs = _apply_subset(g, imgs, cfg.p_cutout, _cutout, cutout_draw)

    def trunc_draw(g, n):
        dev = g.device
        hi = max(int(S * cfg.trunc_ratio), 1)
        return (torch.randint(0, hi, (n,), generator=g, device=dev),
                torch.randint(0, hi, (n,), generator=g, device=dev),
                torch.rand(n, generator=g, device=dev, dtype=torch.float32))

    imgs = _apply_subset(g, imgs, cfg.p_trunc, _truncate, trunc_draw)
    return torch.clamp(imgs, 0.0, 255.0)


def _axis_matrix(S: int, a, b, extent: int, cubic: bool):
    """Dense (B, S, extent) interpolation matrices for the source
    coordinates a * d + b, d = 0 .. S-1, with (B,) a and b. Taps outside
    [0, extent) read zero (BORDER_CONSTANT)."""
    d = torch.arange(S, dtype=torch.float32, device=a.device)
    coords = a[:, None] * d + b[:, None]
    base = torch.floor(coords)
    t = coords - base
    if cubic:
        w = _cubic_weights(t)
        offsets = (-1.0, 0.0, 1.0, 2.0)
    else:
        w = torch.stack([1.0 - t, t], dim=-1)
        offsets = (0.0, 1.0)
    taps = base[..., None] + torch.tensor(offsets, dtype=torch.float32, device=a.device)
    w = w * ((taps >= 0) & (taps <= extent - 1))
    idx = torch.clamp(taps, 0, extent - 1).to(torch.int64)
    B = a.shape[0]
    mat = torch.zeros(B, S * extent, dtype=torch.float32, device=a.device)
    rows = torch.arange(S, device=a.device)[None, :, None] * extent
    mat.scatter_add_(1, (rows + idx).reshape(B, -1), w.reshape(B, -1))
    return mat.reshape(B, S, extent)


def geometry_draw(generator, B: int, cfg: AugmentConfig = AugmentConfig()):
    """The random draws of ``augment_batch``'s geometry, in its order: per
    image a flip flag, an affine flag, a scale jitter and a unit shift (B, 2),
    then the rotated subset's indices (n_rot,) and angles in radians."""
    g, dev = generator, generator.device
    draws = {
        "do_flip": torch.rand(B, generator=g, device=dev) < cfg.p_hflip,
        "do_aff": torch.rand(B, generator=g, device=dev) < cfg.p_affine,
        "jitter": _uniform(g, (B,), -cfg.affine_scale_jitter, cfg.affine_scale_jitter),
        "shift": _uniform(g, (B, 2), -1.0, 1.0),
    }
    n_rot = int(round(cfg.p_rotate * B))
    if n_rot > 0 and cfg.rotate_limit_deg > 0:
        draws["rot_idx"] = torch.randperm(B, generator=g, device=dev)[:n_rot]
        draws["thetas"] = _uniform(g, (n_rot,), -cfg.rotate_limit_deg,
                                   cfg.rotate_limit_deg) * (math.pi / 180.0)
    return draws


def _rotate_affine(images, thetas, cubic: bool):
    """Rotate (n, S, S, 3) crops about their centres by ``thetas`` (n,)
    radians with the inverse-affine warp: src = R(-theta) (out - c) + c."""
    S = images.shape[1]
    c = (S - 1.0) / 2.0
    cos, sin = torch.cos(thetas), torch.sin(thetas)
    M = torch.stack([torch.stack([cos, sin, c - cos * c - sin * c], -1),
                     torch.stack([-sin, cos, c + sin * c - cos * c], -1)], 1)
    warp = affine_warp_cubic if cubic else affine_warp_bilinear
    return warp(images, M, S, normalize=False)


def _rotation(cfg: AugmentConfig):
    """The rotation of ``cfg.rotate_impl``, as the JAX package routes it: the
    three-shear forms up to 90 degrees, else the inverse-affine warp."""
    if cfg.rotate_impl not in ("bmm", "pallas", "shear", "gather"):
        raise ValueError(f"rotate_impl is 'bmm', 'pallas', 'shear' or 'gather', "
                         f"not {cfg.rotate_impl!r}")
    if cfg.rotate_limit_deg <= 90.0 and cfg.rotate_impl != "gather":
        if cfg.rotate_impl == "pallas":
            raise ValueError("the reference copy has no rotation kernel")
        return {"bmm": rotate_shear3_bmm, "shear": rotate_shear3}[cfg.rotate_impl]
    return _rotate_affine


@highest_precision()
def augment_batch(generator, images, clip_bboxes, landmarks,
                  cfg: AugmentConfig = AugmentConfig(), geometry=None):
    """Augment a batch.

    Args:
        generator: a ``torch.Generator`` on the images' device.
        images: (B, P, P, 3) uint8 canvases.
        clip_bboxes: (B, 4) crop boxes [x1, y1, x2, y2] in canvas pixels.
        landmarks: (B, K, 2) landmark pixels in canvas coordinates.
        geometry: the geometric draws (``geometry_draw``); drawn from the
            generator when None.
    Returns:
        (B, S, S, 3) ImageNet-normalised crops and (B, K, 2) keypoints in
        [0, 1] crop coordinates (they may leave [0, 1]). The normalisation
        constants take PyTorch's default dtype, as the JAX ones take float64
        under x64.
    """
    rotate = _rotation(cfg)
    g, dev = generator, images.device
    B, H, W = images.shape[:3]
    S = cfg.out_size
    cubic = cfg.interp == "cubic"
    draws = geometry if geometry is not None else geometry_draw(g, B, cfg)

    # Separable flip / scale / shift / crop map per image: src = a * d + b.
    bb = clip_bboxes.to(torch.float32)
    x1, y1, x2, y2 = bb.unbind(-1)
    w, h = x2 - x1, y2 - y1
    cx, cy = (x1 + x2 - 1.0) / 2.0, (y1 + y2 - 1.0) / 2.0
    do_flip, do_aff = draws["do_flip"], draws["do_aff"]
    scale = torch.where(do_aff, 1.0 + draws["jitter"], 1.0)
    shift = draws["shift"] * cfg.affine_shift_jitter * torch.stack([w, h], -1)
    shift = torch.where(do_aff[:, None], shift, 0.0)
    a0x, a0y = w / S, h / S
    ax = a0x / scale
    bx = cx + (x1 + 0.5 * a0x - 0.5 - cx) / scale - shift[:, 0]
    ay = a0y / scale
    by = cy + (y1 + 0.5 * a0y - 0.5 - cy) / scale - shift[:, 1]
    ax = torch.where(do_flip, -ax, ax)
    bx = torch.where(do_flip, 2.0 * cx - bx, bx)

    Wx = _axis_matrix(S, ax, bx, W, cubic)  # (B, S, W)
    Wy = _axis_matrix(S, ay, by, H, cubic)  # (B, S, H)
    tmp = torch.einsum("bsh,bhwc->bswc", Wy, images.to(torch.float32))
    warped = torch.einsum("bxw,bswc->bsxc", Wx, tmp)
    lm = landmarks.to(torch.promote_types(landmarks.dtype, torch.float32))
    kp = torch.stack([(lm[..., 0] - bx[:, None]) / ax[:, None],
                      (lm[..., 1] - by[:, None]) / ay[:, None]], dim=-1)

    # Rotation of a fixed-count subset about the crop centre.
    if "rot_idx" in draws:
        idx, thetas = draws["rot_idx"], draws["thetas"]
        warped = warped.index_copy(0, idx, rotate(warped[idx], thetas, cubic))
        c = (S - 1.0) / 2.0
        cos, sin = torch.cos(thetas)[:, None], torch.sin(thetas)[:, None]
        rel = kp[idx] - c
        kp = kp.index_copy(0, idx, torch.stack(
            [cos * rel[..., 0] - sin * rel[..., 1] + c,
             sin * rel[..., 0] + cos * rel[..., 1] + c], dim=-1))

    out = _photometric_batch(g, warped, cfg)
    mean = torch.tensor(IMAGENET_MEAN, device=dev)
    std = torch.tensor(IMAGENET_STD, device=dev)
    return (out / 255.0 - mean) / std, kp / S


def pallas_augment_draw(generator, B: int, cfg: AugmentConfig = AugmentConfig()):
    """The random draws of ``augment_batch_pallas``: per image the affine
    parameters (flip flag, rotation angle in radians or 0, scale, affine
    flag and unit shift (B, 2)), the photometric scalars (B, 8) =
    [do_blur, sigma, do_noise, do_cut, do_trunc, trunc_sel, th, tw], the
    cutout holes (B, NH, 4) = (x, y, w, h) and a noise seed (a 0-d int64
    tensor on the generator's device, read by the kernel there)."""
    g, dev = generator, generator.device
    S = cfg.out_size

    def bern(p):
        return torch.rand(B, generator=g, device=dev) < p

    do_flip = bern(cfg.p_hflip)
    do_rot = bern(cfg.p_rotate)
    theta = _uniform(g, (B,), -cfg.rotate_limit_deg, cfg.rotate_limit_deg) * (math.pi / 180.0)
    do_aff = bern(cfg.p_affine)
    jitter = _uniform(g, (B,), -cfg.affine_scale_jitter, cfg.affine_scale_jitter)
    shift = _uniform(g, (B, 2), -1.0, 1.0)
    hi = max(int(S * cfg.trunc_ratio), 1)
    scalars = torch.stack([
        bern(cfg.p_blur).float(),
        _uniform(g, (B,), 0.0, cfg.noise_sigma_max),
        bern(cfg.p_noise).float(),
        bern(cfg.p_cutout).float(),
        bern(cfg.p_trunc).float(),
        torch.rand(B, generator=g, device=dev),
        torch.randint(0, hi, (B,), generator=g, device=dev).float(),
        torch.randint(0, hi, (B,), generator=g, device=dev).float(),
    ], dim=1)
    holes = torch.cat([
        torch.randint(0, S, (B, cfg.cutout_holes, 2), generator=g, device=dev),
        torch.randint(1, cfg.cutout_max, (B, cfg.cutout_holes, 2), generator=g, device=dev),
    ], dim=-1).to(torch.int32)
    return {
        "do_flip": do_flip,
        "theta": torch.where(do_rot, theta, 0.0),
        "do_aff": do_aff,
        "scale": torch.where(do_aff, 1.0 + jitter, 1.0),
        "shift": shift,
        "scalars": scalars,
        "holes": holes,
        "seed": torch.randint(0, 2 ** 31 - 1, (), generator=g, device=dev),
    }


def _sample_affine(clip_bboxes, draws, cfg: AugmentConfig):
    """Compose flip / rotation / scale / shift / crop-resize into (B, 2, 3)
    output-to-source matrices in canvas pixels, and the (B, 2, 2) inverse
    of their linear part for the keypoint forward map (the JAX
    ``_sample_affine``, batched)."""
    S = cfg.out_size
    bb = clip_bboxes.to(torch.float32)
    x1, y1, x2, y2 = bb.unbind(-1)
    w, h = x2 - x1, y2 - y1
    cx, cy = (x1 + x2 - 1.0) / 2.0, (y1 + y2 - 1.0) / 2.0
    theta = draws["theta"].to(torch.float32)
    scale = draws["scale"].to(torch.float32)
    shift = torch.where(draws["do_aff"][:, None],
                        draws["shift"] * cfg.affine_shift_jitter * torch.stack([w, h], -1), 0.0)

    a_x, a_y = w / S, h / S
    b_x, b_y = x1 + 0.5 * a_x - 0.5, y1 + 0.5 * a_y - 0.5
    cos_t, sin_t = torch.cos(theta) / scale, torch.sin(theta) / scale
    m00, m01 = cos_t * a_x, sin_t * a_y
    m10, m11 = -sin_t * a_x, cos_t * a_y
    t0 = cos_t * (b_x - cx) + sin_t * (b_y - cy) + cx - shift[:, 0]
    t1 = -sin_t * (b_x - cx) + cos_t * (b_y - cy) + cy - shift[:, 1]
    flip = draws["do_flip"]
    m00, m01 = torch.where(flip, -m00, m00), torch.where(flip, -m01, m01)
    t0 = torch.where(flip, 2.0 * cx - t0, t0)
    M = torch.stack([torch.stack([m00, m01, t0], -1), torch.stack([m10, m11, t1], -1)], 1)

    det = m00 * m11 - m01 * m10
    det = torch.where(torch.abs(det) < 1e-9, 1e-9, det)
    inv = torch.stack([torch.stack([m11 / det, -m01 / det], -1),
                       torch.stack([-m10 / det, m00 / det], -1)], 1)
    return M, inv


def _forward_keypoints(landmarks, M, inv):
    """(B, K, 2) canvas landmarks through the output-to-source maps ``M``
    backwards: inv @ (landmark - translation), in output pixels."""
    rel = landmarks.to(torch.float32) - M[:, None, :, 2]
    return torch.stack([inv[:, None, 0, 0] * rel[..., 0] + inv[:, None, 0, 1] * rel[..., 1],
                        inv[:, None, 1, 0] * rel[..., 0] + inv[:, None, 1, 1] * rel[..., 1]], -1)


@highest_precision()
def sample_draw(generator, cfg: AugmentConfig = AugmentConfig()):
    """The random draws of ``augment_sample`` for one sample: the affine
    parameters (flip, rotation angle in radians or 0, scale, affine flag,
    unit shift (2,)) and each photometric op's gate and parameters."""
    g, dev = generator, generator.device
    S, NH = cfg.out_size, cfg.cutout_holes

    def u(shape=(), lo=0.0, hi=1.0):
        return _uniform(g, shape, lo, hi)

    def bern(p):
        return u() < p

    do_rot = bern(cfg.p_rotate)
    theta = u((), -cfg.rotate_limit_deg, cfg.rotate_limit_deg) * (math.pi / 180.0)
    do_aff = bern(cfg.p_affine)
    jitter = u((), -cfg.affine_scale_jitter, cfg.affine_scale_jitter)
    ksize, mtheta = motion_blur_draw(g, 1, cfg.motion_blur_max_ksize)
    hi = max(int(S * cfg.trunc_ratio), 1)
    return {
        "do_flip": bern(cfg.p_hflip),
        "theta": torch.where(do_rot, theta, 0.0),
        "do_aff": do_aff,
        "scale": torch.where(do_aff, 1.0 + jitter, 1.0),
        "shift": u((2,), -1.0, 1.0),
        "do_blur": bern(cfg.p_blur),
        "do_fam": bern(cfg.p_blur_family), "u_fam": u(),
        "motion": (ksize[0], mtheta[0]),
        "do_noise": bern(cfg.p_noise),
        "noise": torch.randn(S, S, 3, generator=g, device=dev) * u((), 0.0, cfg.noise_sigma_max),
        "do_jpeg": bern(cfg.p_jpeg), "quality": u((), cfg.jpeg_quality_min, cfg.jpeg_quality_max),
        "do_iso": bern(cfg.p_iso),
        "iso": tuple(t[0] for t in iso_noise_draw(g, 1, S, cfg.iso_color_shift,
                                                   cfg.iso_intensity)),
        "do_cut": bern(cfg.p_cutout),
        "holes_xy": torch.randint(0, S, (NH, 2), generator=g, device=dev),
        "holes_wh": torch.randint(1, cfg.cutout_max, (NH, 2), generator=g, device=dev),
        "do_trunc": bern(cfg.p_trunc),
        "trunc": (torch.randint(0, hi, (), generator=g, device=dev),
                  torch.randint(0, hi, (), generator=g, device=dev), u()),
    }


def _photometric_sample(img, d, cfg: AugmentConfig):
    """The corruption family on one (1, S, S, 3) crop in [0, 255], every op
    computed and kept where its gate is drawn (the JAX ``_photometric``)."""
    img = torch.where(d["do_blur"], box_blur(img), img)
    if cfg.p_blur_family > 0:
        ksize, theta = d["motion"]
        fam = torch.where(d["u_fam"] < 0.5, motion_blur(img, ksize[None], theta[None],
                                                        cfg.motion_blur_max_ksize),
                          torch.where(d["u_fam"] < 0.75, median_blur3(img), box_blur(img)))
        img = torch.where(d["do_fam"], fam, img)
    img = torch.where(d["do_noise"], img + d["noise"], img)
    if cfg.p_jpeg > 0:
        img = torch.where(d["do_jpeg"],
                          jpeg_artifacts(torch.clamp(img, 0.0, 255.0), d["quality"][None]), img)
    if cfg.p_iso > 0:
        cs, it, lum, hue = d["iso"]
        img = torch.where(d["do_iso"], iso_noise(torch.clamp(img, 0.0, 255.0), cs[None],
                                                 it[None], lum[None], hue[None]), img)
    img = torch.where(d["do_cut"], _cutout(img, d["holes_xy"][None], d["holes_wh"][None]), img)
    th, tw, u = d["trunc"]
    img = torch.where(d["do_trunc"], _truncate(img, th[None], tw[None], u[None]), img)
    return torch.clamp(img, 0.0, 255.0)


@highest_precision()
def augment_sample(generator, image_buf, clip_bbox, landmarks_buf,
                   cfg: AugmentConfig = AugmentConfig(), draws=None):
    """Augment one sample (the JAX ``augment_sample``): one affine warp
    (flip, rotation, scale / shift and the crop resize in one matrix;
    ``interp="cubic"``: ``affine_warp_cubic``), the corruption family, and
    ImageNet normalisation.

    Args:
        generator: a ``torch.Generator`` on the image's device.
        image_buf: (P, P, 3) uint8 canvas; clip_bbox (4,) its crop box;
            landmarks_buf (K, 2) landmark pixels, all in canvas coordinates.
        draws: ``sample_draw``'s draws; drawn from the generator when None.
    Returns:
        (S, S, 3) normalised crop and (K, 2) keypoints in [0, 1] crop
        coordinates (they may leave [0, 1]).
    """
    S = cfg.out_size
    d = draws if draws is not None else sample_draw(generator, cfg)
    M, inv = _sample_affine(clip_bbox[None], {k: d[k][None] for k in (
        "do_flip", "theta", "do_aff", "scale", "shift")}, cfg)
    warp = affine_warp_cubic if cfg.interp == "cubic" else affine_warp_bilinear
    img = _photometric_sample(warp(image_buf[None], M, S, normalize=False), d, cfg)
    mean = torch.tensor(IMAGENET_MEAN, device=img.device)
    std = torch.tensor(IMAGENET_STD, device=img.device)
    kp = _forward_keypoints(landmarks_buf[None], M, inv)
    return ((img / 255.0 - mean) / std)[0], (kp[0] + 0.0) / S
