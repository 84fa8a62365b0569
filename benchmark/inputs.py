"""Weights and inputs made on the device from ``--seed``.

Weights: one normal draw on the device for all of a model's tensors, cut
into the leaves in their registration order: matrices and kernels at
variance 1 / fan-in (the program's LeCun scale), norm scales 1 + 0.1 n,
biases and shifts 0.1 n, BatchNorm running means 0.1 n and variances
1 + 0.1 |n|; a configuration may scale named leaves (``weights.scale`` in
its file: the RT-DETR's last norm of each residual branch at 0.1, as
zero-init-residual training starts, since a deep random network whose
BatchNorm takes batch statistics is chaotic and turns any rounding into an
O(1) difference). Both sides (the program and the plain reference) are built
with the same modules' names and filled from the same seed, so they hold
the same weights.

Inputs: uint8 canvases of the loader's pack size, and per image a SPEED
pose (a random attitude, the target 4-30 m away and inside the 1920 x 1200
frame) whose 11 Tango points project inside a square crop box, packed as
the loader packs a crop (decimated by the least power of two that fits the
canvas). A traffic file's ``image`` picks the pixels: ``noise`` (the
default; random pixels) or ``scene``, a lit target on a dark background
drawn from the pose, so that each image's answers are its own (on pixels
that are all alike a random-weight model answers every image nearly alike,
and an answer given to the wrong image would pass for right). Every seed
gives the same sizes; only the values differ.
"""
from __future__ import annotations

import math
import re

# SPEED camera (geometry/camera.py): focal length in pixels and the frame.
FOCAL_PX = 0.0176 / 5.86e-6
FRAME_W, FRAME_H = 1920, 1200


def derive(seed: int, stream: int) -> int:
    """The seed of one random stream of a run (weights, data, augmentation,
    dropout, sampling), each its own for any ``--seed`` up to 2**60."""
    return (int(seed) * 8 + stream) % (2 ** 63)


WEIGHTS, DATA, AUGMENT, DROPOUT, SAMPLE = range(5)
SCENE_GRID, SCENE_CHUNK = 64, 32  # render_scene's coarse grid and images at a time


def named_tensors(model):
    """The leaves the seed fills, in registration order: parameters, then
    floating-point buffers."""
    out = list(model.named_parameters())
    out += [(n, b) for n, b in model.named_buffers() if b.is_floating_point()]
    return out


def seeded_values(torch, leaves, seed: int, device, scaled=()):
    """(name, value) of each leaf of ``leaves`` ((name, shape) pairs in
    registration order) as ``fill_weights`` sets it from ``seed``, one leaf
    at a time, from one draw; a leaf whose name matches a pattern of
    ``scaled`` ((regex, factor) pairs) is multiplied by its factor."""
    rules = [(re.compile(pattern), factor) for pattern, factor in scaled]
    total = sum(math.prod(shape) for _, shape in leaves)
    gen = torch.Generator(device=device).manual_seed(derive(seed, WEIGHTS))
    flat = torch.randn(total, generator=gen, device=device, dtype=torch.float32)
    off = 0
    for name, shape in leaves:
        n = math.prod(shape)
        x = flat[off:off + n].view(shape)
        off += n
        leaf = name.rsplit(".", 1)[-1]
        if len(shape) >= 2:
            value = x * (1.0 / math.sqrt(n // shape[0]))
        elif leaf == "running_var":
            value = 1.0 + 0.1 * x.abs()
        elif leaf == "weight":
            value = 1.0 + 0.1 * x
        else:  # biases, shifts, running means
            value = 0.1 * x
        for pattern, factor in rules:
            if pattern.search(name):
                value = value * factor
        yield name, value


def fill_weights(torch, model, seed: int, device, scaled=()) -> list:
    """Fill ``model`` (built on the meta device, then ``to_empty``) from
    ``seed`` in one draw; returns the (name, shape) of each leaf filled, in
    order."""
    leaves = named_tensors(model)
    shapes = [(n, tuple(t.shape)) for n, t in leaves]
    with torch.no_grad():
        for (_, t), (_, value) in zip(leaves, seeded_values(torch, shapes, seed, device,
                                                           scaled)):
            t.copy_(value)
        for _, b in model.named_buffers():
            if not b.is_floating_point():
                b.zero_()
    return shapes


def build_filled(torch, make, seed: int, device, scaled=()):
    """``make()`` on the meta device, moved to ``device`` empty and filled
    from ``seed``: no leaf is drawn on the host."""
    with torch.device("meta"):
        model = make()
    model = model.to_empty(device=device)
    return model, fill_weights(torch, model, seed, device, scaled)


def _quat_to_rotmat(torch, q):
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).view(*q.shape[:-1], 3, 3)


def make_batch(torch, gen, n: int, pack: int, world, device, scene=None) -> dict:
    """One batch of ``n`` images: canvases (n, pack, pack, 3) uint8, crop
    boxes in the canvas (clip_bbox_buf) and in the frame (clip_bbox), the
    ground-truth pose (quat_gt, tvec_gt), the 11 landmarks in the canvas
    (landmarks_buf), their labels and the keypoint box's area. ``scene``
    (the parameters of ``render_scene``) draws a lit target instead of
    random pixels."""
    f32 = dict(device=device, dtype=torch.float32)
    quat = torch.randn(n, 4, generator=gen, **f32)
    quat = quat / quat.norm(dim=-1, keepdim=True)
    tz = 4.0 + 26.0 * torch.rand(n, generator=gen, **f32)
    tx = (torch.rand(n, generator=gen, **f32) - 0.5) * 0.4 * tz
    ty = (torch.rand(n, generator=gen, **f32) - 0.5) * 0.24 * tz
    tvec = torch.stack([tx, ty, tz], dim=-1)
    cam = torch.einsum("nij,kj->nki", _quat_to_rotmat(torch, quat), world) + tvec[:, None]
    pix = cam[..., :2] / cam[..., 2:3] * FOCAL_PX
    pix = pix + torch.tensor([FRAME_W / 2, FRAME_H / 2], **f32)
    lo, hi = pix.amin(1), pix.amax(1)
    centre = (lo + hi) / 2
    side = (hi - lo).amax(-1) * (1.2 + 0.3 * torch.rand(n, generator=gen, **f32)) + 8.0
    x1y1 = centre - side[:, None] / 2
    clip = torch.cat([x1y1, x1y1 + side[:, None]], dim=-1)
    # The loader's decimation: the least power of two that fits the canvas.
    step = torch.exp2(torch.ceil(torch.log2((side + 2.0) / pack)).clamp_min(0.0))
    origin = torch.floor(x1y1)
    box_buf = torch.cat([(x1y1 - origin), (x1y1 - origin + side[:, None])], dim=-1) / step[:, None]
    landmarks = (pix - origin[:, None]) / step[:, None, None]
    image = torch.randint(0, 256, (n, pack, pack, 3), generator=gen, device=device,
                          dtype=torch.uint8)
    if scene is not None:
        image = render_scene(torch, gen, image, landmarks, (side / step), scene)
    return {
        "image": image, "clip_bbox_buf": box_buf, "clip_bbox": clip,
        "quat_gt": quat, "tvec_gt": tvec, "landmarks_buf": landmarks,
        "labels": torch.arange(world.shape[0], device=device).repeat(n, 1),
        "bbox_area": (hi - lo).prod(-1),
    }


def render_scene(torch, gen, noise, landmarks, side, p: dict):
    """Canvases of a lit target on a dark background, from the pose: a body
    around the landmarks' centre and a bright spot at each landmark, with
    radii in shares of the crop's side (``body_radius``, ``spot_radius``),
    lit per image at a level drawn from ``target`` over a background level
    drawn from ``background`` (0-255), tinted per channel, and textured by
    ``noise`` (the random canvases, at ``texture`` of the level). The shape
    is drawn on a coarse grid of ``SCENE_GRID`` cells a side and scaled up,
    ``SCENE_CHUNK`` images at a time to bound the memory it takes."""
    F = torch.nn.functional
    n, pack = noise.shape[0], noise.shape[1]
    f32 = dict(device=noise.device, dtype=torch.float32)
    lo = p["background"][0] + (p["background"][1] - p["background"][0]) * torch.rand(
        n, generator=gen, **f32)
    hi = p["target"][0] + (p["target"][1] - p["target"][0]) * torch.rand(n, generator=gen, **f32)
    tint = 1.0 - p["tint"] * torch.rand(n, 3, generator=gen, **f32)
    g = SCENE_GRID
    centres = (torch.arange(g, **f32) + 0.5) * (pack / g)
    grid = torch.stack(torch.meshgrid(centres, centres, indexing="xy"), dim=-1)  # (g, g, xy)
    out = torch.empty_like(noise)
    for a in range(0, n, SCENE_CHUNK):
        b = min(a + SCENE_CHUNK, n)
        lm = landmarks[a:b]
        d2 = (grid[None, :, :, None, :] - lm[:, None, None, :, :]).square().sum(-1)
        spot = torch.exp(-d2 / (2.0 * (p["spot_radius"] * side[a:b, None, None, None]) ** 2))
        dc = (grid[None] - lm.mean(1)[:, None, None, :]).square().sum(-1)
        body = 0.6 * torch.exp(-dc / (2.0 * (p["body_radius"] * side[a:b, None, None]) ** 2))
        shape = torch.maximum(spot.amax(-1), body)[:, None]
        shape = F.interpolate(shape, size=(pack, pack), mode="bilinear", align_corners=False)
        tex = noise[a:b].float() / 255.0 - 0.5
        level = (lo[a:b, None, None, None]
                 + (hi - lo)[a:b, None, None, None] * shape[:, 0, :, :, None]
                 * tint[a:b, None, None, :])
        pix = level * (1.0 + p["texture"] * tex)
        out[a:b] = pix.round().clamp(0, 255).to(torch.uint8)
    return out


def batch_pool(torch, seed: int, count: int, n: int, pack: int, world, device,
               image=None) -> list:
    """``count`` distinct batches of ``n`` images from ``seed``; ``image``
    (a traffic file's, or None for random pixels) picks the pixels."""
    image = image or {"kind": "noise"}
    if image["kind"] not in ("noise", "scene"):
        raise ValueError(f"unknown image kind {image['kind']!r}")
    scene = image if image["kind"] == "scene" else None
    gen = torch.Generator(device=device).manual_seed(derive(seed, DATA))
    return [make_batch(torch, gen, n, pack, world, device, scene) for _ in range(count)]
