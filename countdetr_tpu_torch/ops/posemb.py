"""Sinusoidal position embeddings and the grid anchor prior
(countdetr_tpu/ops/posemb.py; reference transformer.py:472-501).

All arithmetic is float32, as in the JAX package: ``dim_t`` is a float32
power, positions are float32.
"""

from __future__ import annotations

import math

import torch


def pos2posemb1d(pos: torch.Tensor, num_pos_feats: int = 256,
                 temperature: float = 10000.0) -> torch.Tensor:
    """pos (...,) -> (..., num_pos_feats): sin on even slots, cos on odd."""
    pos = pos.float() * (2.0 * math.pi)
    dim_t = torch.arange(num_pos_feats, dtype=torch.float32, device=pos.device)
    dim_t = torch.pow(
        torch.tensor(temperature, dtype=torch.float32, device=pos.device),
        2.0 * torch.floor(dim_t / 2.0) / num_pos_feats,
    )
    pos_x = pos[..., None] / dim_t
    emb = torch.stack([torch.sin(pos_x[..., 0::2]), torch.cos(pos_x[..., 1::2])], dim=-1)
    return emb.reshape(*emb.shape[:-2], num_pos_feats)


def pos2posemb2d(pos: torch.Tensor, num_pos_feats: int = 128,
                 temperature: float = 10000.0) -> torch.Tensor:
    """pos (..., 2) as [x, y] -> (..., 2 * num_pos_feats), in (y, x) order
    (reference transformer.py:481)."""
    emb_x = pos2posemb1d(pos[..., 0], num_pos_feats, temperature)
    emb_y = pos2posemb1d(pos[..., 1], num_pos_feats, temperature)
    return torch.cat([emb_y, emb_x], dim=-1)


def mask2pos(mask: torch.Tensor):
    """(B, H, W) padding mask (True = pad) -> (pos_col (B, H), pos_row (B, W)),
    the normalized coordinates (cumsum(valid) - 0.5) / num_valid."""
    not_mask = ~mask
    y_embed = torch.cumsum(not_mask[:, :, 0].float(), dim=1)
    x_embed = torch.cumsum(not_mask[:, 0, :].float(), dim=1)
    y_embed = (y_embed - 0.5) / y_embed[:, -1:]
    x_embed = (x_embed - 0.5) / x_embed[:, -1:]
    return y_embed, x_embed


def grid_reference_points(num_position: int, device="cpu") -> torch.Tensor:
    """sqrt(n) x sqrt(n) grid of anchors in [0, 1]^2, meshgrid 'ij' order:
    x-major, [(x0, y0), (x0, y1), ...]. Returns (n, 2)."""
    n = round(math.sqrt(num_position))
    x = (torch.arange(n, dtype=torch.float32, device=device) + 0.5) / n
    xv, yv = torch.meshgrid(x, x, indexing="ij")
    return torch.stack([xv.reshape(-1), yv.reshape(-1)], dim=-1)
