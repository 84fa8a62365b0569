"""Inputs of the detection train cell, made on the device from ``--seed``:
COCO-like padded targets, images that show them normalised as
``DetSolver`` normalises them, and the order in which a run takes the
published multi-scale sizes.

Targets (parameters in the traffic file's ``targets``): per image a count
of boxes from a geometric law of mean ``mean_count`` (COCO train2017's 7.3
boxes an image), at least 1 and at most ``max_count`` (its largest, 93),
padded to ``max_targets`` with label -1 and zero boxes; classes over
``num_classes`` with ``person_share`` of them class 0 (COCO's "person") and
the rest uniform over the others; normalised cxcywh boxes whose areas fall
small / medium / large (under 32², under 96², over 96² pixels of a 640
image, COCO's bins) in the shares ``area_shares``, the side uniform in log
scale inside its bin, the aspect ratio log-uniform in ``aspect``, and the
box inside the image. Every seed gives the same sizes; only the values
differ.
"""
from __future__ import annotations

import math

import inputs

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
# Box sides (square root of the area) at the edges of COCO's area bins, in
# units of a 640-pixel image: 4 px (the smallest box kept), 32, 96, and the
# image's side.
AREA_EDGES = (4 / 640, 32 / 640, 96 / 640, 1.0)


def size_order(seed: int, sizes) -> list:
    """The published size list in an order shuffled from ``seed``; a run
    takes it pass after pass, so any len(sizes) consecutive steps hold
    every size in its published share."""
    import torch
    gen = torch.Generator().manual_seed(inputs.derive(seed, inputs.SAMPLE))
    return [int(sizes[i]) for i in torch.randperm(len(sizes), generator=gen)]


def coco_targets(torch, gen, n: int, max_targets: int, p: dict, device):
    """(labels (n, T) int32 padded with -1, boxes (n, T, 4) float32
    normalised cxcywh, zero where padded), T = ``max_targets``."""
    f32 = dict(device=device, dtype=torch.float32)
    T = max_targets
    # a geometric count of mean mean_count, at least 1, at most max_count
    u = torch.rand(n, generator=gen, **f32).clamp_min(1e-12)
    q = 1.0 - 1.0 / p["mean_count"]
    count = (1 + torch.floor(torch.log(u) / math.log(q))).clamp(1, min(p["max_count"], T))
    real = torch.arange(T, device=device)[None] < count[:, None]

    person = torch.rand(n, T, generator=gen, **f32) < p["person_share"]
    other = torch.randint(1, p["num_classes"], (n, T), generator=gen, device=device)
    labels = torch.where(person, 0, other)

    shares = torch.tensor(p["area_shares"], **f32)
    bin_ = torch.multinomial(shares / shares.sum(), n * T, replacement=True,
                             generator=gen).view(n, T)
    edges = torch.log(torch.tensor(AREA_EDGES, **f32))
    lo, hi = edges[bin_], edges[bin_ + 1]
    side = torch.exp(lo + (hi - lo) * torch.rand(n, T, generator=gen, **f32))
    a_lo, a_hi = math.log(p["aspect"][0]), math.log(p["aspect"][1])
    ratio = torch.exp(a_lo + (a_hi - a_lo) * torch.rand(n, T, generator=gen, **f32))
    wh = torch.stack([side * ratio.sqrt(), side / ratio.sqrt()], -1).clamp(max=1.0)
    centre = wh / 2 + (1.0 - wh) * torch.rand(n, T, 2, generator=gen, **f32)
    boxes = torch.cat([centre, wh], -1)
    labels = torch.where(real, labels, -1).to(torch.int32)
    return labels, torch.where(real[..., None], boxes, 0.0)


def normalised_images(torch, gen, labels, boxes, size: int, p: dict, device):
    """(n, size, size, 3) float32 images of the targets ``labels`` /
    ``boxes``, / 255, less the ImageNet mean, over its standard deviation
    (``DetSolver``'s ``_prep_image``): each real box filled, the larger
    first, with its class's colour (one table of ``num_classes`` drawn per
    call) over a background level drawn per image from ``background``,
    textured by random pixels at ``texture`` of the level. Each image's
    answers are its own, so a target given to the wrong image shows (on
    random pixels alone a random-weight model answers every image nearly
    alike)."""
    n = labels.shape[0]
    f32 = dict(device=device, dtype=torch.float32)
    noise = torch.randint(0, 256, (n, size, size, 3), generator=gen, device=device,
                          dtype=torch.uint8).to(torch.float32)
    colour = 40.0 + 215.0 * torch.rand(p["num_classes"], 3, generator=gen, **f32)
    lo, hi = p["background"]
    level = (lo + (hi - lo) * torch.rand(n, 1, 1, 1, generator=gen, **f32)).expand(
        n, size, size, 3)
    xyxy = torch.cat([boxes[..., :2] - boxes[..., 2:] / 2,
                      boxes[..., :2] + boxes[..., 2:] / 2], -1) * size
    centres = torch.arange(size, **f32) + 0.5
    area = torch.where(labels >= 0, boxes[..., 2] * boxes[..., 3], -1.0)
    rows = torch.arange(n, device=device)
    for t in area.argsort(dim=1, descending=True).unbind(1):  # the larger first
        x1, y1, x2, y2 = xyxy[rows, t].unbind(-1)
        inside = (((centres >= y1[:, None]) & (centres < y2[:, None]))[:, :, None]
                  & ((centres >= x1[:, None]) & (centres < x2[:, None]))[:, None, :]
                  & (labels[rows, t] >= 0)[:, None, None])
        fill = colour[labels[rows, t].clamp(min=0).long()]  # (n, 3)
        level = torch.where(inside[..., None], fill[:, None, None, :], level)
    pix = (level * (1.0 + p["texture"] * (noise / 255.0 - 0.5))).round().clamp(0, 255)
    mean = torch.tensor(IMAGENET_MEAN, device=device)
    std = torch.tensor(IMAGENET_STD, device=device)
    return (pix / 255.0 - mean) / std


def batch_pools(torch, seed: int, sizes, count: int, n: int, max_targets: int, p: dict,
                image: dict, device) -> dict:
    """{size: ``count`` distinct batches {"images", "labels", "boxes"} of
    ``n`` images} for each distinct size of ``sizes``, in the order the
    sizes first appear; ``p`` draws the targets and ``image`` the pixels."""
    image = dict(image, num_classes=p["num_classes"])
    gen = torch.Generator(device=device).manual_seed(inputs.derive(seed, inputs.DATA))
    pools = {}
    for size in dict.fromkeys(sizes):
        pools[size] = []
        for _ in range(count):
            labels, boxes = coco_targets(torch, gen, n, max_targets, p, device)
            images = normalised_images(torch, gen, labels, boxes, size, image, device)
            pools[size].append({"images": images, "labels": labels, "boxes": boxes})
    return pools
