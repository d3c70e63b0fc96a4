"""PV-RCNN's VoxelSetAbstraction (port of df3d/models/pfe.py).

Keypoints by exact furthest point sampling of the raw cloud; per keypoint
(a) the raw points within a radius, (b) the voxels of each sparse backbone
stage within its radius (ball query, shared MLP, max pool: pointnet2's SA
layers) and (c) the BEV map sampled bilinearly at the keypoint; the
concatenation goes through one Linear + ReLU to the keypoint features.

Two empty-group rules, as the JAX package has them: the raw branch keeps
-1e9 where no point lies within reach (its `isfinite` test passes -1e9
through), the voxel scales zero anything at or below -1e8. Voxel centres
round as XLA computes them under `jit` (`calib.voxel_centers_fma`), and the
ball query ranks distances as XLA does (`pointops.ball_query`), so the
neighbour sets equal the JAX package's on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from df3d_torch.core.calib import voxel_centers_fma
from df3d_torch.models.fusion.projection import sample_image_features
from df3d_torch.ops.pointops import ball_query, furthest_point_sample
from df3d_torch.utils import stages


@dataclasses.dataclass(frozen=True)
class VSAScaleCfg:
    feature_key: str
    downsample: int
    radius: float
    nsample: int = 16
    mlp: tuple = (32, 32)


@dataclasses.dataclass(frozen=True)
class VSAConfig:
    num_keypoints: int = 2048
    raw_radius: float = 0.4
    raw_nsample: int = 16
    raw_mlp: tuple = (16, 16)
    scales: tuple = (
        VSAScaleCfg("conv1", 1, 0.4),
        VSAScaleCfg("conv2", 2, 0.8),
        VSAScaleCfg("conv3", 4, 1.2),
        VSAScaleCfg("conv4", 8, 2.4),
    )
    bev_stride: int = 8
    out_channels: int = 128


def gather_rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x (B, N, C), idx (B, ...) int -> (B, ..., C): x[b, idx[b, ...]]."""
    b, c = x.shape[0], x.shape[-1]
    flat = idx.reshape(b, -1, 1).expand(-1, -1, c)
    return x.gather(1, flat).view(*idx.shape, c)


def _group(kp, xyz, feats, valid, radius, nsample):
    """Ball-query group of each keypoint: relative xyz then features of its
    first `nsample` neighbours -> ((B, K, ns, 3 + C), mask (B, K, ns))."""
    idx, mask = ball_query(kp, xyz, valid, radius, nsample)
    rel = gather_rows(xyz, idx) - kp[:, :, None]
    return torch.cat([rel, gather_rows(feats, idx)], -1), mask


class VoxelSetAbstraction(nn.Module):
    """`point_features`: channels of the raw points past xyz;
    `scale_channels`: each `cfg.scales` stage's feature channels by key;
    `bev_channels`: the BEV map's. flax's layer names: `raw_mlp0`,
    `raw_mlp1`, `<key>_mlp0`, `<key>_mlp1`, `vsa_out`."""

    def __init__(self, cfg: VSAConfig, voxel_size, pc_range,
                 point_features: int, scale_channels: dict,
                 bev_channels: int):
        super().__init__()
        self.cfg, self.voxel_size, self.pc_range = cfg, voxel_size, pc_range
        self.raw_mlp0 = nn.Linear(3 + point_features, cfg.raw_mlp[0])
        self.raw_mlp1 = nn.Linear(cfg.raw_mlp[0], cfg.raw_mlp[1])
        width = cfg.raw_mlp[1]
        for s in cfg.scales:
            setattr(self, f"{s.feature_key}_mlp0",
                    nn.Linear(3 + scale_channels[s.feature_key], s.mlp[0]))
            setattr(self, f"{s.feature_key}_mlp1",
                    nn.Linear(s.mlp[0], s.mlp[1]))
            width += s.mlp[1]
        self.vsa_out = nn.Linear(width + bev_channels, cfg.out_channels)

    def forward(self, points: torch.Tensor, points_valid: torch.Tensor,
                ms_features: dict, bev: torch.Tensor):
        """points (B, P, 3+F); points_valid (B, P); ms_features the sparse
        stages by key; bev (B, H, W, C) channel-last -> (keypoints (B, K,
        3), features (B, K, out_channels))."""
        c = self.cfg
        xyz = points[..., :3]
        idx = furthest_point_sample(xyz, points_valid, c.num_keypoints)
        keypoints = gather_rows(xyz, idx)
        stages.mark("pfe_fps")

        g, m = _group(keypoints, xyz, points[..., 3:], points_valid,
                      c.raw_radius, c.raw_nsample)
        h = self.raw_mlp1(torch.relu(self.raw_mlp0(g)))
        h = torch.where(m[..., None], h, -1e9).amax(2)
        gathered = [torch.where(torch.isfinite(h), h, 0.0)]

        for s in c.scales:
            st = ms_features[s.feature_key]
            centres = voxel_centers_fma(st.coords, self.voxel_size,
                                        self.pc_range, s.downsample)
            g, m = _group(keypoints, centres, st.features, st.valid,
                          s.radius, s.nsample)
            h = getattr(self, f"{s.feature_key}_mlp0")(g)
            h = getattr(self, f"{s.feature_key}_mlp1")(torch.relu(h))
            h = torch.where(m[..., None], h, -1e9).amax(2)
            gathered.append(torch.where(h <= -1e8, 0.0, h))
        stages.mark("pfe_ball_query")

        bh, bw = bev.shape[1:3]
        px = (keypoints[..., 0] - self.pc_range[0]) / (
            self.voxel_size[0] * c.bev_stride)
        py = (keypoints[..., 1] - self.pc_range[1]) / (
            self.voxel_size[1] * c.bev_stride)
        uv = torch.stack([px / bw, py / bh], -1)
        gathered.append(sample_image_features(
            bev, uv, torch.ones(keypoints.shape[:2], dtype=torch.bool,
                                device=bev.device)))
        out = torch.relu(self.vsa_out(torch.cat(gathered, -1)))
        stages.mark("pfe_bev_sample")
        return keypoints, out
