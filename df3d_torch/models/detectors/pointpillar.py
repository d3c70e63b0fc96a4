"""PointPillars (port of df3d/models/detectors/pointpillar.py): pcdet's
PointPillar on KITTI. Points per pillar -> `PillarVFE` -> `pillar_scatter`
onto the BEV canvas -> `BEVBackbone` (3 / 5 / 5 convs at strides 2, 2, 2,
each upsampled to 128) -> `AnchorHeadSingle`, whose anchor decode and
losses are Voxel R-CNN's RPN's.

The JAX package has no pillar voxelizer (its voxelizer returns means), and
neither has the port: the caller gives each pillar's points.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from df3d_torch.models.detectors.centerpoint import init_detector_weights
from df3d_torch.models.heads.anchor_head import (
    AnchorClassCfg, AnchorHeadSingle, generate_anchors,
)
from df3d_torch.models.layers import flax_dense_init_
from df3d_torch.models.necks import BEVBackbone
from df3d_torch.models.vfe import PillarVFE, pillar_scatter
from df3d_torch.utils import stages

KITTI_CAR_PILLAR = AnchorClassCfg(
    name="Car", size=(3.9, 1.6, 1.56), bottom_height=-1.78,
    matched_threshold=0.6, unmatched_threshold=0.45)


@dataclasses.dataclass(frozen=True)
class PointPillarConfig:
    """The JAX package's `PointPillarConfig` (pcdet's pointpillar.yaml)."""

    pc_range: tuple = (0.0, -39.68, -3.0, 69.12, 39.68, 1.0)
    voxel_size: tuple = (0.16, 0.16, 4.0)
    grid_size: tuple = (1, 496, 432)   # (Z=1, Y, X)
    max_voxels: int = 16_000
    max_points_per_voxel: int = 32
    num_point_features: int = 4
    pillar_channels: int = 64
    anchor_classes: tuple = (KITTI_CAR_PILLAR,)
    out_size_factor: int = 2

    @property
    def bev_size_xy(self):
        return (self.grid_size[2] // self.out_size_factor,
                self.grid_size[1] // self.out_size_factor)


class PointPillars(nn.Module):
    """Build, call `init_weights` (or load a state dict), `.eval()`."""

    def __init__(self, cfg: PointPillarConfig):
        super().__init__()
        self.cfg = cfg
        self.vfe = PillarVFE(cfg.num_point_features, cfg.pillar_channels,
                             cfg.voxel_size, cfg.pc_range)
        self.neck = BEVBackbone(
            cfg.pillar_channels, layer_nums=(3, 5, 5),
            layer_strides=(2, 2, 2), num_filters=(64, 128, 256),
            upsample_strides=(1, 2, 4), num_upsample_filters=(128, 128, 128))
        n_cls = len(cfg.anchor_classes)
        self.dense_head = AnchorHeadSingle(
            384, n_cls, n_cls * len(cfg.anchor_classes[0].rotations))
        anchors = generate_anchors(cfg.bev_size_xy, cfg.pc_range,
                                   cfg.anchor_classes)
        self.register_buffer("anchors",
                             torch.from_numpy(anchors.reshape(-1, 7)),
                             persistent=False)

    def forward(self, voxel_points: torch.Tensor, num_points: torch.Tensor,
                coords: torch.Tensor) -> dict:
        """voxel_points (B, V, P, F) each pillar's points; num_points (B,
        V); coords (B, V, 3) (z, y, x), z 0, -1 rows padding -> the anchor
        head's "cls", "box" and "dir" (B, A, .)."""
        pillars = self.vfe(voxel_points, num_points, coords)
        bev = pillar_scatter(pillars, coords, self.cfg.grid_size[1:])
        stages.mark("vfe")
        bev = self.neck(bev)
        stages.mark("neck")
        cls, box, dirp = self.dense_head(bev)
        stages.mark("head")
        return {"cls": cls, "box": box, "dir": dirp}

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "PointPillars":
        """Random weights drawn like the flax initializers: He
        truncated-normal for the neck, flax's Dense initializer for the PFN
        layer and the anchor head (its class bias at the -log 99 prior),
        identity norms."""
        init_detector_weights(self, "dense_head.", generator)
        for part in (self.vfe, self.dense_head):
            flax_dense_init_(part, generator)
        self.dense_head.conv_cls.bias.fill_(-math.log(99.0))
        return self
