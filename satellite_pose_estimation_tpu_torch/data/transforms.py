"""Composable host transforms of the detection task (counterpart of
data/transforms.py, a copy of its numpy code).

Transforms are host functions over a sample dict {image (H, W, 3) uint8,
boxes? (normalised cxcywh), labels?, landmarks?}, registered by name and
composed from the reference's YAML ``ops:`` lists:

    transforms = Compose.from_config([
        {"type": "RandomHorizontalFlip", "p": 0.5},
        {"type": "Resize", "size": 640},
        {"type": "Normalize"},
    ], rng=np.random.RandomState(0))

Every random op draws from the one ``np.random.RandomState`` the composer is
given, in the JAX package's order, so a pipeline gives the JAX package's
samples under the same seed. ``Resize`` and the photometric hue step call
OpenCV (``cv2``, imported where they run), as the JAX package's do; every
other op is numpy. The SPEED train path uses the device augmentation
(data/augment.py) instead.
"""
from __future__ import annotations

from typing import Callable, Dict, List

import numpy as np

TRANSFORMS: Dict[str, Callable] = {}


def register_transform(fn=None, *, name=None):
    def wrap(f):
        TRANSFORMS[name or f.__name__] = f
        return f

    return wrap(fn) if fn else wrap


class Compose:
    def __init__(self, transforms: List[Callable]):
        self.transforms = transforms

    @classmethod
    def from_config(cls, ops: List[dict], rng=None):
        rng = rng or np.random.RandomState(0)
        built = []
        for op in ops:
            kwargs = dict(op)
            kind = kwargs.pop("type")
            built.append(TRANSFORMS[kind](rng=rng, **kwargs))
        return cls(built)

    def __call__(self, sample: dict) -> dict:
        for t in self.transforms:
            sample = t(sample)
        return sample


@register_transform(name="Resize")
def _resize(size, rng=None):
    # int -> square; (h, w) sequence accepted like torchvision's size=[640, 640]
    th, tw = (size, size) if isinstance(size, int) else tuple(size)

    def apply(sample):
        import cv2

        img = sample["image"]
        H, W = img.shape[:2]
        sample = dict(sample)
        sample["image"] = cv2.resize(img, (tw, th),
                                     interpolation=cv2.INTER_LINEAR)
        if "landmarks" in sample:
            lm = np.asarray(sample["landmarks"], np.float64)
            sample["landmarks"] = lm * [tw / W, th / H]
        # normalized boxes are resize-invariant
        return sample

    return apply


@register_transform(name="RandomHorizontalFlip")
def _hflip(p: float = 0.5, rng=None):
    def apply(sample):
        if rng.rand() >= p:
            return sample
        sample = dict(sample)
        img = sample["image"]
        W = img.shape[1]
        sample["image"] = img[:, ::-1].copy()
        if "landmarks" in sample:
            lm = np.asarray(sample["landmarks"], np.float64).copy()
            lm[:, 0] = W - 1 - lm[:, 0]
            sample["landmarks"] = lm
        if "boxes" in sample and len(sample["boxes"]):
            b = np.asarray(sample["boxes"], np.float64).copy()  # cxcywh norm
            b[:, 0] = 1.0 - b[:, 0]
            sample["boxes"] = b
        return sample

    return apply


@register_transform(name="Normalize")
def _normalize(mean=(0.485, 0.456, 0.406), std=(0.229, 0.224, 0.225),
               rng=None):
    mean = np.asarray(mean, np.float32)
    std = np.asarray(std, np.float32)

    def apply(sample):
        sample = dict(sample)
        sample["image"] = (
            sample["image"].astype(np.float32) / 255.0 - mean
        ) / std
        return sample

    return apply


@register_transform(name="Pad")
def _pad(size: int, rng=None):
    def apply(sample):
        sample = dict(sample)
        img = sample["image"]
        H, W = img.shape[:2]
        out = np.zeros((size, size) + img.shape[2:], img.dtype)
        out[:min(H, size), :min(W, size)] = img[:size, :size]
        sample["image"] = out
        return sample

    return apply


def _boxes_abs_xyxy(boxes: np.ndarray, W: int, H: int) -> np.ndarray:
    """Normalized cxcywh -> absolute xyxy."""
    b = np.asarray(boxes, np.float64)
    cx, cy, w, h = b[:, 0] * W, b[:, 1] * H, b[:, 2] * W, b[:, 3] * H
    return np.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2], axis=1)


def _boxes_norm_cxcywh(xyxy: np.ndarray, W: int, H: int) -> np.ndarray:
    """Absolute xyxy -> normalized cxcywh."""
    b = np.asarray(xyxy, np.float64)
    return np.stack(
        [(b[:, 0] + b[:, 2]) / 2 / W, (b[:, 1] + b[:, 3]) / 2 / H,
         (b[:, 2] - b[:, 0]) / W, (b[:, 3] - b[:, 1]) / H], axis=1)


@register_transform(name="EmptyTransform")
def _empty(rng=None):
    """Identity placeholder (R2/src/data/transforms.py:63-72)."""
    return lambda sample: sample


@register_transform(name="ToImageTensor")
def _to_image_tensor(rng=None):
    """Registered for config parity; arrays are already tensors here."""
    return lambda sample: sample


@register_transform(name="ConvertDtype")
def _convert_dtype(rng=None):
    """uint8 [0,255] -> float32 [0,1] (torchvision ConvertDtype)."""

    def apply(sample):
        sample = dict(sample)
        img = sample["image"]
        if img.dtype == np.uint8:
            sample["image"] = img.astype(np.float32) / 255.0
        return sample

    return apply


@register_transform(name="RandomPhotometricDistort")
def _photometric_distort(brightness=(0.875, 1.125), contrast=(0.5, 1.5),
                         saturation=(0.5, 1.5), hue=(-0.05, 0.05),
                         p: float = 0.5, rng=None):
    """SSD photometric distortion (R2/src/data/transforms.py:27 registers
    torchvision v2's RandomPhotometricDistort): brightness scale, contrast
    (randomly before or after color ops), saturation, hue rotation, and a
    random channel permutation — each gated independently at ``p``.
    Image-only; boxes/landmarks untouched.
    """

    def _contrast(img):
        f = rng.uniform(*contrast)
        gray_mean = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                     + 0.114 * img[..., 2]).mean()
        return gray_mean + f * (img - gray_mean)

    def apply(sample):
        sample = dict(sample)
        img = sample["image"].astype(np.float32)
        if rng.rand() < p:
            img = img * rng.uniform(*brightness)
        contrast_first = rng.rand() < 0.5
        if contrast_first and rng.rand() < p:
            img = _contrast(img)
        if rng.rand() < p:
            f = rng.uniform(*saturation)
            gray = (0.299 * img[..., 0] + 0.587 * img[..., 1]
                    + 0.114 * img[..., 2])[..., None]
            img = gray + f * (img - gray)
        if rng.rand() < p:
            import cv2

            shift = rng.uniform(*hue)  # fraction of the full hue circle
            hsv = cv2.cvtColor(
                np.clip(img, 0, 255).astype(np.uint8), cv2.COLOR_RGB2HSV
            ).astype(np.int16)
            hsv[..., 0] = (hsv[..., 0] + int(round(shift * 180))) % 180
            img = cv2.cvtColor(hsv.astype(np.uint8),
                               cv2.COLOR_HSV2RGB).astype(np.float32)
        if not contrast_first and rng.rand() < p:
            img = _contrast(img)
        if rng.rand() < p:
            img = img[..., rng.permutation(3)]
        sample["image"] = np.clip(img, 0, 255).astype(sample["image"].dtype)
        return sample

    return apply


@register_transform(name="RandomIoUCrop")
def _iou_crop(min_scale: float = 0.3, max_scale: float = 1.0,
              min_aspect_ratio: float = 0.5, max_aspect_ratio: float = 2.0,
              sampler_options=None, trials: int = 40, p: float = 1.0,
              rng=None):
    """SSD-style min-IoU random crop (R2/src/data/transforms.py:109-137
    subclasses torchvision's RandomIoUCrop adding the ``p`` gate).

    Picks a min-jaccard threshold from ``sampler_options`` (>=1.0 entries
    mean "no crop"), then up to ``trials`` random crops until one contains
    at least one box center and overlaps every center-contained box with
    IoU >= threshold. Boxes are shifted to the crop frame but NOT filtered
    — compose with SanitizeBoundingBox, as the reference pipelines do.
    """
    options = list(sampler_options if sampler_options is not None
                   else [0.0, 0.1, 0.3, 0.5, 0.7, 0.9, 1.0])

    def apply(sample):
        if rng.rand() >= p:
            return sample
        boxes = np.asarray(sample.get("boxes", np.zeros((0, 4))))
        if not len(boxes):
            return sample
        min_jaccard = options[rng.randint(len(options))]
        if min_jaccard >= 1.0:
            return sample
        img = sample["image"]
        H, W = img.shape[:2]
        xyxy = _boxes_abs_xyxy(boxes, W, H)
        cx, cy = (xyxy[:, 0] + xyxy[:, 2]) / 2, (xyxy[:, 1] + xyxy[:, 3]) / 2
        for _ in range(trials):
            r = min_scale + (max_scale - min_scale) * rng.rand(2)
            new_w, new_h = int(W * r[0]), int(H * r[1])
            if not (min_aspect_ratio < new_w / max(new_h, 1)
                    < max_aspect_ratio):
                continue
            left = int(rng.rand() * (W - new_w))
            top = int(rng.rand() * (H - new_h))
            right, bottom = left + new_w, top + new_h
            within = (left < cx) & (cx < right) & (top < cy) & (cy < bottom)
            if not within.any():
                continue
            # IoU of each center-contained box with the crop window
            ix = (np.minimum(xyxy[within, 2], right)
                  - np.maximum(xyxy[within, 0], left)).clip(0)
            iy = (np.minimum(xyxy[within, 3], bottom)
                  - np.maximum(xyxy[within, 1], top)).clip(0)
            inter = ix * iy
            area_box = ((xyxy[within, 2] - xyxy[within, 0])
                        * (xyxy[within, 3] - xyxy[within, 1]))
            iou = inter / (area_box + new_w * new_h - inter)
            if iou.max() < min_jaccard:
                continue
            sample = dict(sample)
            sample["image"] = img[top:bottom, left:right].copy()
            shifted = xyxy - [left, top, left, top]
            sample["boxes"] = _boxes_norm_cxcywh(shifted, new_w, new_h)
            return sample
        return sample

    return apply


@register_transform(name="RandomCrop")
def _random_crop(size, rng=None):
    """Random fixed-size crop, zero-padding if the image is smaller."""
    if isinstance(size, int):
        size = (size, size)
    th, tw = size

    def apply(sample):
        sample = dict(sample)
        img = sample["image"]
        H, W = img.shape[:2]
        if H < th or W < tw:
            padded = np.zeros((max(H, th), max(W, tw)) + img.shape[2:],
                              img.dtype)
            padded[:H, :W] = img
            if "boxes" in sample and len(sample["boxes"]):
                xyxy = _boxes_abs_xyxy(sample["boxes"], W, H)
                sample["boxes"] = _boxes_norm_cxcywh(
                    xyxy, padded.shape[1], padded.shape[0])
            img, (H, W) = padded, padded.shape[:2]
        top = rng.randint(0, H - th + 1)
        left = rng.randint(0, W - tw + 1)
        sample["image"] = img[top:top + th, left:left + tw].copy()
        if "boxes" in sample and len(sample["boxes"]):
            xyxy = _boxes_abs_xyxy(sample["boxes"], W, H)
            sample["boxes"] = _boxes_norm_cxcywh(
                xyxy - [left, top, left, top], tw, th)
        if "landmarks" in sample:
            sample["landmarks"] = (
                np.asarray(sample["landmarks"], np.float64) - [left, top])
        return sample

    return apply


@register_transform(name="SanitizeBoundingBox")
def _sanitize(min_size: float = 1.0, rng=None):
    """Drop boxes smaller than ``min_size`` px or centered off-image, and
    their labels (torchvision SanitizeBoundingBox, registered at
    R2/src/data/transforms.py:34)."""

    def apply(sample):
        boxes = np.asarray(sample.get("boxes", np.zeros((0, 4))))
        if not len(boxes):
            return sample
        sample = dict(sample)
        H, W = sample["image"].shape[:2]
        keep = ((boxes[:, 2] * W >= min_size) & (boxes[:, 3] * H >= min_size)
                & (boxes[:, 0] > 0) & (boxes[:, 0] < 1)
                & (boxes[:, 1] > 0) & (boxes[:, 1] < 1))
        sample["boxes"] = boxes[keep]
        if "labels" in sample:
            sample["labels"] = np.asarray(sample["labels"])[keep]
        return sample

    return apply


@register_transform(name="ConvertBox")
def _convert_box(out_fmt: str = "", normalize: bool = False, rng=None):
    """Box-format conversion (R2/src/data/transforms.py:138-160). Samples
    natively carry normalized cxcywh, so ``out_fmt='cxcywh', normalize=True``
    (the shipped det-config terminal op) is the identity; ``out_fmt='xyxy'``
    emits absolute corners for tooling and must be the last op."""

    def apply(sample):
        if not out_fmt or not len(sample.get("boxes", ())):
            return sample
        sample = dict(sample)
        H, W = sample["image"].shape[:2]
        if out_fmt == "xyxy":
            xyxy = _boxes_abs_xyxy(sample["boxes"], W, H)
            sample["boxes"] = xyxy / ([W, H, W, H] if normalize else 1.0)
        elif out_fmt != "cxcywh":
            raise ValueError(f"unsupported out_fmt {out_fmt!r}")
        return sample

    return apply


@register_transform(name="PadToSize")
def _pad_to_size(spatial_size, fill: float = 0, rng=None):
    """Pad bottom/right to a fixed spatial size, rescaling normalized boxes
    to the new base and recording the applied padding like the reference
    (R2/src/data/transforms.py:75-106 stores it in the target dict)."""
    if isinstance(spatial_size, int):
        spatial_size = (spatial_size, spatial_size)
    th, tw = spatial_size

    def apply(sample):
        sample = dict(sample)
        img = sample["image"]
        H, W = img.shape[:2]
        out = np.full((max(th, H), max(tw, W)) + img.shape[2:], fill,
                      img.dtype)
        out[:H, :W] = img
        sample["image"] = out
        sample["padding"] = [0, 0, max(tw - W, 0), max(th - H, 0)]
        nh, nw = out.shape[:2]
        if "boxes" in sample and len(sample["boxes"]):
            b = np.asarray(sample["boxes"], np.float64).copy()
            b[:, 0] *= W / nw
            b[:, 2] *= W / nw
            b[:, 1] *= H / nh
            b[:, 3] *= H / nh
            sample["boxes"] = b
        return sample

    return apply


@register_transform(name="RandomZoomOut")
def _zoom_out(p: float = 0.5, max_scale: float = 2.0, fill: float = 0,
              rng=None):
    def apply(sample):
        if rng.rand() >= p:
            return sample
        sample = dict(sample)
        img = sample["image"]
        H, W = img.shape[:2]
        scale = rng.uniform(1.0, max_scale)
        nh, nw = int(H * scale), int(W * scale)
        canvas = np.full((nh, nw) + img.shape[2:], fill, img.dtype)
        oy, ox = rng.randint(0, nh - H + 1), rng.randint(0, nw - W + 1)
        canvas[oy:oy + H, ox:ox + W] = img
        sample["image"] = canvas
        if "boxes" in sample and len(sample["boxes"]):
            b = np.asarray(sample["boxes"], np.float64).copy()
            b[:, 0] = (b[:, 0] * W + ox) / nw
            b[:, 1] = (b[:, 1] * H + oy) / nh
            b[:, 2] = b[:, 2] * W / nw
            b[:, 3] = b[:, 3] * H / nh
            sample["boxes"] = b
        return sample

    return apply
