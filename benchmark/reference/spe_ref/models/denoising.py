"""Contrastive denoising query groups (CDN) for RT-DETR training
(counterpart of models/denoising.py).

The static layout of the JAX package: a speed target set has T = 11
landmarks per image, so G = num_denoising // T groups (at least one) of
[T positives | T negatives] sit ahead of the matching queries, the
positives of group g at queries g * 2T + [0, T).

* Label noise: each dn query's label flips to a random class with
  probability ``label_noise_ratio / 2`` (never a padded target, label -1,
  which embeds as the table's last row).
* Contrastive coordinate noise: per coordinate a magnitude u in [0, 1)
  times ``diff`` for positives and (u + 1) in [1, 2) for negatives, with a
  random sign; ``diff`` is 0.1 * ``point_noise_scale`` for 2-D points, and
  0.5 * wh * scale on each corner for 4-D cxcywh boxes (applied in xyxy).
* A (N, N) block mask, True = blocked, N = 2GT + num_queries: each group
  sees itself and the matching queries; the matching queries see no dn
  query.

The random draws (``draw_denoising_noise``) are split from the
deterministic assembly (``assemble_denoising_group``), so a test can hand
the assembler the draws another generator made.
"""
from __future__ import annotations

import torch


def _cxcywh_to_xyxy(b):
    return torch.cat([b[..., :2] - b[..., 2:] / 2, b[..., :2] + b[..., 2:] / 2], -1)


def _xyxy_to_cxcywh(b):
    return torch.cat([(b[..., :2] + b[..., 2:]) / 2, b[..., 2:] - b[..., :2]], -1)


def _num_groups(num_denoising: int, num_targets: int) -> int:
    return max(num_denoising // num_targets, 1)


def draw_denoising_noise(generator, labels: torch.Tensor, box_dim: int, num_denoising: int,
                         num_classes: int, label_noise_ratio: float = 0.5):
    """The draws of one CDN group build for ``labels`` (B, T), on their
    device from ``generator`` (None: the device's default generator):
    ``flip`` (B, 2G, T) bool, with probability ``label_noise_ratio / 2``;
    ``rand_labels`` (B, 2G, T) int64 in [0, num_classes); ``u`` (B, 2G, T,
    box_dim) float32 in [0, 1); ``sign`` (B, 2G, T, box_dim) float32 of
    +-1."""
    B, T = labels.shape
    G = _num_groups(num_denoising, T)
    kw = dict(generator=generator, device=labels.device)
    flip = torch.rand(B, 2 * G, T, dtype=torch.float32, **kw) < label_noise_ratio * 0.5
    rand_labels = torch.randint(0, num_classes, (B, 2 * G, T), **kw)
    u = torch.rand(B, 2 * G, T, box_dim, dtype=torch.float32, **kw)
    sign = torch.randint(0, 2, (B, 2 * G, T, box_dim), **kw).to(torch.float32) * 2 - 1
    return flip, rand_labels, u, sign


def assemble_denoising_group(draws, labels: torch.Tensor, points: torch.Tensor,
                             class_embed: torch.Tensor, num_queries: int, num_classes: int,
                             num_denoising: int = 100, point_noise_scale: float = 1.0):
    """The CDN group of ``labels`` (B, T) and normalised ``points`` (B, T,
    D) (D = 2: xy; D = 4: cxcywh) from ``draws`` (``draw_denoising_noise``)
    and the ``class_embed`` table (num_classes + 1, C). The noised points
    take the dtype of ``points`` and ``u`` promoted, as in JAX.

    Returns (dn_embed (B, 2GT, C), dn_points_unact (B, 2GT, D),
    attn_mask (N, N) bool, True = blocked, dn_meta {"dn_num_group": G,
    "dn_num_split": (2GT, num_queries)})."""
    flip, rand_labels, u, sign = draws
    B, T = labels.shape
    D = points.shape[-1]
    G = _num_groups(num_denoising, T)
    n_dn = 2 * G * T
    pad = labels < 0
    lab = torch.where(pad, num_classes, labels).to(torch.int64)[:, None].expand(B, 2 * G, T)
    lab = torch.where(flip & ~pad[:, None], rand_labels, lab)

    pts = points[:, None].expand(B, 2 * G, T, D)
    neg = (torch.arange(2 * G, device=points.device) % 2).to(points.dtype)[None, :, None, None]
    magnitude = (u + neg) * sign  # [0, 1) positives, [1, 2) negatives, signed
    if D == 4:
        diff = (pts[..., 2:] * 0.5).repeat(1, 1, 1, 2) * point_noise_scale
        xyxy = (_cxcywh_to_xyxy(pts) + magnitude * diff).clamp(0.0, 1.0)
        noised = _xyxy_to_cxcywh(xyxy)
    else:
        noised = (pts + magnitude * (0.1 * point_noise_scale)).clamp(0.0, 1.0)
    noised = noised.reshape(B, n_dn, D)
    eps = 1e-5
    dn_points_unact = torch.log(noised.clamp(min=eps) / (1.0 - noised).clamp(min=eps))
    dn_embed = class_embed[lab.reshape(B, n_dn)]

    n = n_dn + num_queries
    group = torch.arange(n_dn, device=points.device) // (2 * T)
    mask = torch.zeros(n, n, dtype=torch.bool, device=points.device)
    mask[:n_dn, :n_dn] = group[:, None] != group[None, :]
    mask[n_dn:, :n_dn] = True
    return dn_embed, dn_points_unact, mask, {"dn_num_group": G,
                                             "dn_num_split": (n_dn, num_queries)}


def build_denoising_group(generator, labels, points, class_embed, num_queries: int,
                          num_classes: int, num_denoising: int = 100,
                          label_noise_ratio: float = 0.5, point_noise_scale: float = 1.0):
    """Draw from ``generator`` and assemble one CDN group build (the JAX
    ``build_denoising_group`` with a ``torch.Generator`` for its key)."""
    draws = draw_denoising_noise(generator, labels, points.shape[-1], num_denoising,
                                 num_classes, label_noise_ratio)
    return assemble_denoising_group(draws, labels, points, class_embed, num_queries,
                                    num_classes, num_denoising, point_noise_scale)
