"""2D positional encodings (counterpart of models/position_encoding.py).

* ``PositionEmbeddingSine``: with no padding mask (every crop is fully
  valid) the normalised cumulative sum of the reference reduces to a linear
  ramp, computed in closed form.
* ``PositionEmbeddingLearned``: 50-row learned row / column tables.
* ``build_2d_sincos_position_embedding``: the RT-DETR AIFI embedding.
"""
from __future__ import annotations

import math

import torch
from torch import nn


class PositionEmbeddingSine(nn.Module):
    """Normalised sine embedding, temperature 10000, scale 2 pi."""

    temperature = 10000.0
    scale = 2 * math.pi

    def __init__(self, num_pos_feats=128):
        super().__init__()
        self.num_pos_feats = num_pos_feats

    def forward(self, h: int, w: int, device=None, dtype=torch.float32):
        """Returns (h, w, 2*num_pos_feats) position features."""
        y_embed = torch.arange(1, h + 1, dtype=torch.float32, device=device)[:, None].expand(h, w)
        x_embed = torch.arange(1, w + 1, dtype=torch.float32, device=device)[None, :].expand(h, w)
        eps = 1e-6
        y_embed = y_embed / (h + eps) * self.scale
        x_embed = x_embed / (w + eps) * self.scale

        dim_t = torch.arange(self.num_pos_feats, dtype=torch.float32, device=device)
        dim_t = self.temperature ** (2 * torch.div(dim_t, 2, rounding_mode="floor")
                                     / self.num_pos_feats)

        pos_x = x_embed[:, :, None] / dim_t
        pos_y = y_embed[:, :, None] / dim_t
        # Interleave sin on even dims, cos on odd dims.
        pos_x = torch.stack([pos_x[:, :, 0::2].sin(), pos_x[:, :, 1::2].cos()],
                            dim=3).reshape(h, w, -1)
        pos_y = torch.stack([pos_y[:, :, 0::2].sin(), pos_y[:, :, 1::2].cos()],
                            dim=3).reshape(h, w, -1)
        return torch.cat([pos_y, pos_x], dim=-1).to(dtype)


class PositionEmbeddingLearned(nn.Module):
    """Learned embedding: ``col_embed[:w]`` and ``row_embed[:h]`` (50 rows
    each of num_pos_feats/2, flax's ``uniform(1.0)`` init U[0, 1))
    broadcast over the grid and concatenated, x half first."""

    def __init__(self, num_pos_feats=256, generator=None):
        super().__init__()
        self.row_embed = nn.Parameter(torch.empty(50, num_pos_feats // 2))
        self.col_embed = nn.Parameter(torch.empty(50, num_pos_feats // 2))
        with torch.no_grad():
            self.row_embed.uniform_(0.0, 1.0, generator=generator)
            self.col_embed.uniform_(0.0, 1.0, generator=generator)

    def forward(self, h: int, w: int, device=None, dtype=torch.float32):
        """Returns (h, w, num_pos_feats) position features."""
        x_emb = self.col_embed[:w][None].expand(h, -1, -1)
        y_emb = self.row_embed[:h][:, None].expand(-1, w, -1)
        return torch.cat([x_emb, y_emb], dim=-1).to(dtype)


def build_2d_sincos_position_embedding(w: int, h: int, embed_dim: int = 256,
                                       temperature: float = 10000.0, device=None):
    """RT-DETR AIFI flavour: [sin(wx), cos(wx), sin(wy), cos(wy)] blocks of
    embed_dim / 4 over the grid, float32 (h*w, embed_dim). As in the JAX
    version (and the reference), the grid is meshed (w, h) with "ij"
    indexing, so the rows run over w first."""
    grid_w = torch.arange(w, dtype=torch.float32, device=device)
    grid_h = torch.arange(h, dtype=torch.float32, device=device)
    grid_w, grid_h = torch.meshgrid(grid_w, grid_h, indexing="ij")
    pos_dim = embed_dim // 4
    omega = torch.arange(pos_dim, dtype=torch.float32, device=device) / pos_dim
    omega = 1.0 / (temperature ** omega)
    out_w = grid_w.reshape(-1)[:, None] * omega[None, :]
    out_h = grid_h.reshape(-1)[:, None] * omega[None, :]
    return torch.cat([out_w.sin(), out_w.cos(), out_h.sin(), out_h.cos()], dim=1)
