"""Voxel and pillar feature encoders (port of df3d/models/vfe.py).

`mean_vfe` (the mean of each voxel's points; the voxelizer fuses it on the
path), `PillarVFE` (PointPillars' PFN layer) and `pillar_scatter` (pillars
onto the dense BEV canvas).
"""

from __future__ import annotations

import torch
from torch import nn

from df3d_torch.models.fusion.pointformer import scatter_rows_last
from df3d_torch.models.layers import MaskedBatchNorm


def mean_vfe(point_feats: torch.Tensor,
             num_points: torch.Tensor) -> torch.Tensor:
    """(V, P, F) points per voxel and (V,) counts -> (V, F) means (zero for
    an empty voxel)."""
    mask = (torch.arange(point_feats.shape[1], device=point_feats.device)
            < num_points[:, None])
    s = torch.where(mask[..., None], point_feats, 0.0).sum(1)
    return s / num_points[:, None].clamp_min(1)


class PillarVFE(nn.Module):
    """Points per pillar (B, V, P, F) -> pillar features (B, V, C). Each
    point gets, after its own F features, its offset from the pillar's
    point mean (3) and from the pillar centre in x and y (2: the JAX
    package's choice, where pcdet also offsets z); then `pfn_linear` (no
    bias), `pfn_bn` (BatchNorm over the valid points of the batch), ReLU,
    and a max over the pillar's points, zero for an empty pillar."""

    def __init__(self, in_features: int, num_filters: int = 64,
                 voxel_size=(0.16, 0.16, 4.0),
                 pc_range=(0.0, -39.68, -3.0, 69.12, 39.68, 1.0)):
        super().__init__()
        self.voxel_size, self.pc_range = voxel_size, pc_range
        self.pfn_linear = nn.Linear(in_features + 5, num_filters, bias=False)
        self.pfn_bn = MaskedBatchNorm(num_filters)

    def forward(self, points: torch.Tensor, num_points: torch.Tensor,
                coords: torch.Tensor) -> torch.Tensor:
        """points (B, V, P, F); num_points (B, V); coords (B, V, 3) (z, y,
        x)."""
        b, v, p, _ = points.shape
        mask = (torch.arange(p, device=points.device)[None, None]
                < num_points[..., None])
        xyz = points[..., :3]
        cnt = num_points.clamp_min(1)[..., None, None].to(points.dtype)
        mean = torch.where(mask[..., None], xyz, 0.0).sum(
            2, keepdim=True) / cnt
        f_cluster = xyz - mean
        cx = ((coords[..., 2:3].to(points.dtype) + 0.5) * self.voxel_size[0]
              + self.pc_range[0])
        cy = ((coords[..., 1:2].to(points.dtype) + 0.5) * self.voxel_size[1]
              + self.pc_range[1])
        f_center = torch.stack([xyz[..., 0] - cx, xyz[..., 1] - cy], -1)
        feats = torch.cat([points, f_cluster, f_center], -1)
        feats = torch.where(mask[..., None], feats, 0.0)
        h = self.pfn_linear(feats)
        h = self.pfn_bn(h.reshape(b, v * p, -1),
                        mask.reshape(b, v * p)).reshape(b, v, p, -1)
        h = torch.relu(h)
        h = torch.where(mask[..., None], h, -1e9).amax(2)
        return torch.where(num_points[..., None] > 0, h, 0.0)


def pillar_scatter(pillar_feats: torch.Tensor, coords: torch.Tensor,
                   grid_yx) -> torch.Tensor:
    """(B, V, C) pillar features and (B, V, 3) (z, y, x) coords -> the dense
    BEV canvas (B, H, W, C). Rows with coords[..., 0] < 0 are dropped; where
    two rows share a pillar the later one wins, on every device."""
    hh, ww = grid_yx
    b, _, c = pillar_feats.shape
    valid = coords[..., 0] >= 0
    flat = torch.where(valid, coords[..., 1].long() * ww + coords[..., 2],
                       hh * ww)
    canvas = scatter_rows_last(pillar_feats.new_zeros(b, hh * ww, c), flat,
                               pillar_feats)
    return canvas.view(b, hh, ww, c)
