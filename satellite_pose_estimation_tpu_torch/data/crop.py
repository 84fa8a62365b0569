"""Crop-box geometry — numerically exact ports of the reference formulas
(counterpart of data/crop.py).

These run on host (they are cheap per-image scalar math); the actual pixel
work (crop + resize + normalize) happens on the device (ops/image_warp.py)
using the boxes computed here.

Parity contracts:
* generate_clip_bbox_val       — R1/datasets/speed.py:246-260
* generate_clip_bbox_train     — R1/datasets/speed.py:262-291 (truncnorm
  jittered center/scale, int truncation, ceil half-scale, clip to image)
* generate_clip_bbox_submission— R1/datasets/speed.py:92-108 (int-truncated
  square box, NOT clipped; pad-to-square canvas semantics)
"""
from __future__ import annotations

import numpy as np


def generate_clip_bbox_val(bbox, image_size):
    """Square 1.2x box around the GT bbox, clipped to the image. Returns
    float (4,) [x1, y1, x2, y2]."""
    x1, y1, x2, y2 = bbox
    bw, bh = x2 - x1, y2 - y1
    scale = max(bw, bh) * 1.2
    xc, yc = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    half = scale / 2.0
    clip = np.asarray([xc - half, yc - half, xc + half, yc + half], np.float64)
    clip[0::2] = clip[0::2].clip(0, image_size[0])
    clip[1::2] = clip[1::2].clip(0, image_size[1])
    return clip


def truncnorm_sample(loc, clip, rng):
    """Truncated normal in [mu-3s, mu+3s], s = clip/3 (R1/datasets/speed.py:
    297-303). Implemented by rejection so only numpy RNG is needed."""
    sigma = clip / 3.0
    if sigma <= 0:
        return float(loc)
    while True:
        x = rng.normal(loc, sigma)
        if abs(x - loc) <= 3.0 * sigma:
            return float(x)


def generate_clip_bbox_train(bbox, image_size, rng, alpha=0.2, beta=0.2):
    """Random zoom-in crop box for training: center jittered by
    truncnorm(+-alpha*wh), scale jittered by truncnorm(+-beta*scale), int
    truncation, ceil half-scale, clip to image."""
    x1, y1, x2, y2 = bbox
    bw, bh = x2 - x1, y2 - y1
    scale = max(bw, bh) * 1.2

    xc = int(truncnorm_sample((x1 + x2) / 2.0, bw * alpha, rng))
    yc = int(truncnorm_sample((y1 + y2) / 2.0, bh * alpha, rng))
    scale = int(truncnorm_sample(scale, scale * beta, rng))
    half = np.ceil(scale / 2.0)

    clip = np.asarray([xc - half, yc - half, xc + half, yc + half], np.float64)
    clip[0::2] = clip[0::2].clip(0, image_size[0])
    clip[1::2] = clip[1::2].clip(0, image_size[1])
    return clip


def generate_clip_bbox_submission(bbox):
    """Detector-box crop for submission: square int box of side
    int(1.2*max(wh)) anchored at int top-left; may extend outside the image
    (the crop is placed on a zero canvas, preserving aspect ratio)."""
    x1, y1, x2, y2 = bbox
    bw, bh = x2 - x1, y2 - y1
    scale = max(bw, bh) * 1.2
    xc, yc = (x1 + x2) / 2.0, (y1 + y2) / 2.0
    half = scale / 2.0
    xi, yi = int(xc - half), int(yc - half)
    si = int(scale)
    return np.asarray([xi, yi, xi + si, yi + si], np.float64)


def bbox_area(bbox):
    """Area proxy used by the adaptive reprojection threshold of the
    self-assessment solver. The reference computes
    sqrt((x2 - x1) * y2 - y1)   — note the parenthesisation: y2 is inside
    the product, y1 subtracted after (R2/src/data/speed/speed_dataset.py:
    370-374). We reproduce the shipped behavior exactly, since that is what
    trained checkpoints were evaluated with.
    """
    return float(np.sqrt((bbox[2] - bbox[0]) * bbox[3] - bbox[1]))
