"""Sine positional encodings of the fusion transformer (port of
df3d/models/fusion/position_encoding.py).

DETR convention: interleaved sin/cos, temperature 10000, scale 2*pi. The
learned depth-bin embedding is not on the CenterPoint + 3D-DF path and is
not ported.
"""

from __future__ import annotations

import math

import torch

_TWO_PI = 2 * math.pi


def _sine_embed(x: torch.Tensor, num_feats: int,
                temperature: float = 10000.0) -> torch.Tensor:
    """x (...,) scaled positions -> (..., num_feats) interleaved sin/cos."""
    i = torch.arange(num_feats, device=x.device)
    dim_t = temperature ** (2 * (i // 2) / num_feats).to(torch.float32)
    pos = x[..., None] / dim_t
    sin = torch.sin(pos[..., 0::2])
    cos = torch.cos(pos[..., 1::2])
    return torch.stack([sin, cos], -1).reshape(*x.shape, num_feats)


def position_embedding_sine_2d(h: int, w: int, num_pos_feats: int,
                               device=None) -> torch.Tensor:
    """Dense 2D sine map -> (h, w, 2 * num_pos_feats); normalize=True."""
    eps = 1e-6
    y = ((torch.arange(h, dtype=torch.float32, device=device) + 1)
         / (h + eps) * _TWO_PI)
    x = ((torch.arange(w, dtype=torch.float32, device=device) + 1)
         / (w + eps) * _TWO_PI)
    pos_y = _sine_embed(y, num_pos_feats)[:, None, :].expand(h, w, -1)
    pos_x = _sine_embed(x, num_pos_feats)[None, :, :].expand(h, w, -1)
    return torch.cat([pos_y, pos_x], -1)


def position_embedding_sine_sparse(coords: torch.Tensor,
                                   num_pos_feats: int) -> torch.Tensor:
    """coords (..., 2) normalized [0, 1] image (x, y) -> (..., 2 *
    num_pos_feats)."""
    x = coords[..., 0] * _TWO_PI
    y = coords[..., 1] * _TWO_PI
    return torch.cat([_sine_embed(y, num_pos_feats),
                      _sine_embed(x, num_pos_feats)], -1)


def position_embedding_sine_depth(depth: torch.Tensor, num_pos_feats: int,
                                  max_depth: float = 60.0) -> torch.Tensor:
    """depth (...,) meters -> (..., num_pos_feats) (SineSparseDepth)."""
    return _sine_embed(depth / max_depth * _TWO_PI, num_pos_feats)
