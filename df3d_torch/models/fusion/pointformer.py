"""3D local self-attention over voxel queries, "LT" in the paper (port of
df3d/models/fusion/pointformer.py).

Furthest-point-sampled centers, ball-query neighborhoods of fixed size, a
positional MLP on relative xyz, a small pre-norm transformer encoder over
each neighborhood, then the enhanced features go back onto the point set
('replace': the last write in flat (center, slot) order wins, as the JAX
package's scatter does on the CPU; 'sum': features plus the mean of the
contributions).

Two places where a literal translation would differ from flax, both kept
here: LayerNorm eps is flax's 1e-6, and masked attention logits are filled
with finfo(f32).min as flax does (`models.attention`), so a neighborhood
whose mask is all False gets uniform weights instead of the NaN that -inf
would give.
"""

from __future__ import annotations

import math

import torch
from torch import nn

from df3d_torch.models.attention import LN_EPS, FlaxMultiHeadAttention
from df3d_torch.ops.pointops import ball_query, furthest_point_sample


def scatter_rows_last(base: torch.Tensor, index: torch.Tensor,
                      src: torch.Tensor) -> torch.Tensor:
    """out = base with out[b, index[b, t]] = src[b, t], the highest t
    winning where an index repeats; index == base.shape[1] is dropped.
    Deterministic on every device (no reliance on scatter write order).
    base (B, M, C), index (B, T) int, src (B, T, C)."""
    b, m, c = base.shape
    t = index.shape[1]
    pos = torch.arange(t, device=index.device).expand(b, t)
    winner = torch.full((b, m + 1), -1, dtype=torch.long, device=index.device)
    winner.scatter_reduce_(1, index.long(), pos, "amax")
    winner = winner[:, :m]
    rows = src.gather(1, winner.clamp_min(0)[..., None].expand(b, m, c))
    return torch.where((winner >= 0)[..., None], rows, base)


class PreNormEncoderLayer(nn.Module):
    """LN -> MHA -> residual, LN -> FF -> residual."""

    def __init__(self, d_model: int, nhead: int = 4,
                 dim_feedforward: int | None = None):
        super().__init__()
        dff = dim_feedforward or 2 * d_model
        self.norm1 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.mha = FlaxMultiHeadAttention(d_model, nhead)
        self.norm2 = nn.LayerNorm(d_model, eps=LN_EPS)
        self.ff1 = nn.Linear(d_model, dff)
        self.ff2 = nn.Linear(dff, d_model)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        x = x + self.mha(self.norm1(x), mask=mask)
        return x + self.ff2(torch.relu(self.ff1(self.norm2(x))))


class LocalTransformer(nn.Module):
    def __init__(self, npoint: int = 2048, radius: float = 2.0,
                 nsample: int = 32, d_model: int = 64, num_layers: int = 2,
                 nhead: int = 4, feat_agg_method: str = "replace",
                 fps_chunks: int | None = None):
        super().__init__()
        if feat_agg_method not in ("replace", "sum"):
            raise ValueError(feat_agg_method)
        self.npoint, self.radius, self.nsample = npoint, radius, nsample
        self.feat_agg_method = feat_agg_method
        # None: the JAX package's chunked FPS (sequential depth ~32)
        self.fps_chunks = (math.gcd(npoint, max(1, npoint // 32))
                           if fps_chunks is None else fps_chunks)
        self.pe0 = nn.Linear(3, d_model // 2)
        self.pe1 = nn.Linear(d_model // 2, d_model)
        self.num_layers = num_layers
        for i in range(num_layers):
            self.add_module(f"enc{i}", PreNormEncoderLayer(d_model, nhead))

    def forward(self, xyz: torch.Tensor, features: torch.Tensor,
                valid: torch.Tensor) -> torch.Tensor:
        """xyz (B, N, 3) metric voxel centers; features (B, N, C); valid
        (B, N). Returns the updated features (B, N, C)."""
        b, n, c = features.shape
        centers_idx = furthest_point_sample(xyz, valid, self.npoint,
                                            self.fps_chunks)
        rows = torch.arange(b, device=xyz.device)[:, None]
        centers = xyz[rows, centers_idx]                       # (B, S, 3)
        idx, mask = ball_query(centers, xyz, valid, self.radius,
                               self.nsample)                   # (B, S, K)
        g_xyz = xyz[rows[..., None], idx] - centers[:, :, None, :]
        g_feat = features[rows[..., None], idx]                # (B, S, K, C)

        h = g_feat + self.pe1(torch.relu(self.pe0(g_xyz.to(g_feat.dtype))))
        for i in range(self.num_layers):
            h = getattr(self, f"enc{i}")(h, mask)
        h = torch.where(mask[..., None], h, 0.0)

        flat_idx = torch.where(mask, idx, n).reshape(b, -1)   # n: dropped
        flat_feat = h.reshape(b, -1, c)
        if self.feat_agg_method == "replace":
            out = scatter_rows_last(features, flat_idx, flat_feat)
        else:
            acc = features.new_zeros(b, n + 1, c).scatter_add_(
                1, flat_idx[..., None].expand(-1, -1, c), flat_feat)
            cnt = features.new_zeros(b, n + 1).scatter_add_(
                1, flat_idx, torch.ones_like(flat_idx, dtype=features.dtype))
            out = features + acc[:, :n] / cnt[:, :n, None].clamp_min(1.0)
        return torch.where(valid[..., None], out, 0.0)
