"""MSDeformAttn module with the dual-query extension (port of
df3d/models/fusion/msda_module.py).

Value and output projections, per-head sampling-offset and attention-weight
predictors, and the paper's dual-query mix (q_method in {gating, sum,
image}; q_rep_place a subset of {offset, weight}) of the LiDAR query with
the image query before the offsets and weights are predicted. The sampling
core is `ops.msda.ms_deform_attn`: the hand-written kernel K2 on CUDA
tensors, its plain version on CPU tensors.

Sampling-offset columns are ordered ((h*L + l)*P + p)*2 + xy and attention
columns (h*L + l)*P + p, as in the JAX package, so both are plain views.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from df3d_torch.ops.msda import ms_deform_attn


def offset_bias_grid(n_heads: int, n_levels: int,
                     n_points: int) -> torch.Tensor:
    """The deformable-DETR direction grid that initialises the
    sampling-offset bias (the JAX package's `_offset_bias_init`)."""
    thetas = np.arange(n_heads) * (2.0 * np.pi / n_heads)
    grid = np.stack([np.cos(thetas), np.sin(thetas)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    grid = np.tile(grid[:, None, None, :], (1, n_levels, n_points, 1))
    grid = grid * (np.arange(n_points) + 1)[None, None, :, None]
    return torch.tensor(grid.reshape(-1), dtype=torch.float32)


class MSDeformAttnModule(nn.Module):
    def __init__(self, d_model: int = 256, n_levels: int = 4,
                 n_heads: int = 8, n_points: int = 4,
                 q_method: Optional[str] = None,
                 q_rep_place: tuple = ("weight",)):
        super().__init__()
        if q_method not in (None, "gating", "sum", "image"):
            raise ValueError(q_method)
        self.d_model, self.n_levels = d_model, n_levels
        self.n_heads, self.n_points = n_heads, n_points
        self.q_method, self.q_rep_place = q_method, tuple(q_rep_place)
        self.value_proj = nn.Linear(d_model, d_model)
        if q_method == "gating":
            self.q_gate = nn.Linear(d_model, 1)
            self.i_gate = nn.Linear(d_model, 1)
        self.sampling_offsets = nn.Linear(
            d_model, n_heads * n_levels * n_points * 2)
        self.attention_weights = nn.Linear(
            d_model, n_heads * n_levels * n_points)
        self.output_proj = nn.Linear(d_model, d_model)

    def forward(self, query: torch.Tensor, reference_points: torch.Tensor,
                value_flatten: torch.Tensor, spatial_shapes: Sequence[tuple],
                i_query: Optional[torch.Tensor] = None,
                value_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """query (B, Q, C); reference_points (B, Q, L, 2) normalized [0, 1];
        value_flatten (B, LenV, C); value_mask (B, LenV) True = valid."""
        b, q, _ = query.shape
        nh, nl, npnt = self.n_heads, self.n_levels, self.n_points
        value = self.value_proj(value_flatten)
        if value_mask is not None:
            value = value * value_mask[..., None]

        weight_query = query
        if self.q_method is not None:
            if i_query is None:
                raise ValueError("q_method needs the image query")
            if self.q_method == "gating":
                g_q = torch.sigmoid(self.q_gate(query))
                g_i = torch.sigmoid(self.i_gate(i_query))
                # ms_deform_attn.py:139: gated sum minus the originals
                new_query = query * g_q + i_query * g_i - query - i_query
            elif self.q_method == "sum":
                new_query = query + i_query
            else:
                new_query = i_query
            if "offset" in self.q_rep_place:
                query = new_query
            if "weight" in self.q_rep_place:
                weight_query = new_query

        offsets = self.sampling_offsets(query).view(b, q, nh, nl, npnt, 2)
        attn = self.attention_weights(weight_query).view(b, q, nh, nl * npnt)
        attn = torch.softmax(attn, -1).view(b, q, nh, nl, npnt)
        inv_norm = torch.tensor(
            [[1.0 / w, 1.0 / h] for h, w in spatial_shapes],
            dtype=offsets.dtype, device=offsets.device)
        loc = (reference_points[:, :, None, :, None, :]
               + offsets * inv_norm[:, None, :])
        out = ms_deform_attn(
            value.view(b, -1, nh, self.d_model // nh), spatial_shapes,
            loc.contiguous(), attn.contiguous())
        return self.output_proj(out)
