"""PV-RCNN (port of df3d/models/detectors/pv_rcnn.py): Voxel R-CNN's first
stage (`VoxelBackBone8x` -> BEV neck -> `AnchorHeadSingle`) plus
VoxelSetAbstraction keypoints (`pfe`) and `PointHeadSimple`, whose sigmoid
weights the keypoint features; `PVRCNNRoIHead` pools the keypoint features
around each RoI's grid points.

The serving path, as the JAX package composes it: `PVRCNN` ->
`voxel_rcnn.proposal_layer` on its "cls", "box" and "dir" with `cfg.base`
-> `PVRCNNRoIHead` (-> `voxel_rcnn_post_processing` for final boxes).
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from df3d_torch.models.backbones_3d import VoxelBackBone8x
from df3d_torch.models.detectors.centerpoint import init_detector_weights
from df3d_torch.models.detectors.voxel_rcnn import (
    VoxelRCNNConfig, build_anchors,
)
from df3d_torch.models.heads.anchor_head import AnchorHeadSingle
from df3d_torch.models.heads.point_head import PointHeadSimple
from df3d_torch.models.layers import flax_dense_init_
from df3d_torch.models.necks import BEVBackbone
from df3d_torch.models.pfe import VSAConfig, VoxelSetAbstraction, gather_rows
from df3d_torch.ops.roi_ops import (
    collect_local_voxels, grid_ball_query, roi_grid_points,
)
from df3d_torch.ops.sparse import SparseTensor
from df3d_torch.utils import stages


@dataclasses.dataclass(frozen=True)
class PVRCNNConfig:
    """The JAX package's `PVRCNNConfig`: KITTI's Voxel R-CNN geometry, 2048
    keypoints, a 6^3 RoI grid pooling 16 keypoints within 0.8 m from the
    256 nearest the RoI centre."""

    base: VoxelRCNNConfig = VoxelRCNNConfig()
    vsa: VSAConfig = VSAConfig()
    roi_grid_size: int = 6
    roi_radius: float = 0.8
    roi_nsample: int = 16
    roi_max_local: int = 256


class PVRCNN(nn.Module):
    """The first stage and the keypoints. Build, call `init_weights` (or
    load a state dict), `.eval()`."""

    def __init__(self, cfg: PVRCNNConfig):
        super().__init__()
        self.cfg = cfg
        base = cfg.base
        self.backbone = VoxelBackBone8x(base.num_point_features)
        bev_channels = 128 * VoxelBackBone8x.out_depth(base.sparse_shape[0])
        self.neck = BEVBackbone(
            bev_channels, layer_nums=(5, 5), layer_strides=(1, 2),
            num_filters=(64, 128), upsample_strides=(1, 2),
            num_upsample_filters=(128, 128))
        n_cls = len(base.anchor_classes)
        self.dense_head = AnchorHeadSingle(
            256, n_cls, n_cls * len(base.anchor_classes[0].rotations))
        channels = dict(zip(("conv1", "conv2", "conv3", "conv4"),
                            VoxelBackBone8x.CHANNELS))
        self.pfe = VoxelSetAbstraction(
            cfg.vsa, base.voxel_size, base.pc_range,
            base.num_point_features - 3, channels, 256)
        self.point_head = PointHeadSimple(cfg.vsa.out_channels)
        self.register_buffer("anchors", build_anchors(base), persistent=False)

    def forward(self, voxel_features: torch.Tensor,
                voxel_coords: torch.Tensor, points: torch.Tensor,
                points_valid: torch.Tensor):
        """voxel_features (B, V, F), voxel_coords (B, V, 3) key-sorted with
        -1 padding rows; points (B, P, 3+F) and points_valid (B, P), the
        raw cloud the keypoints come from.

        Returns (preds, overflow): preds holds the anchor head's "cls",
        "box" and "dir", the backbone's stages "ms", "keypoints" (B, K, 3),
        the weighted "kp_feats" (B, K, C) and "point_fg_logits" (B, K)."""
        base = self.cfg.base
        st = SparseTensor(voxel_features, voxel_coords, base.sparse_shape)
        caps = tuple(min(c, voxel_features.shape[1]) for c in base.stage_caps)
        bev, ms, overflow = self.backbone(st, caps)
        bev = self.neck(bev)
        stages.mark("neck")
        cls, box, dirp = self.dense_head(bev)
        stages.mark("rpn")
        keypoints, kp_feats = self.pfe(points, points_valid, ms, bev)
        fg_logits = self.point_head(kp_feats)
        kp_feats = kp_feats * torch.sigmoid(fg_logits)[..., None]
        stages.mark("point_head")
        return {"cls": cls, "box": box, "dir": dirp, "ms": ms,
                "keypoints": keypoints, "kp_feats": kp_feats,
                "point_fg_logits": fg_logits}, overflow

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "PVRCNN":
        """Random weights drawn like the flax initializers: He-normal taps
        for the sparse convs, He truncated-normal for the neck, flax's
        Dense initializer for the anchor head, the keypoint layers and the
        point head (the anchor head's class bias at the -log 99 prior),
        identity norms."""
        init_detector_weights(self, "dense_head.", generator)
        for part in (self.dense_head, self.pfe, self.point_head):
            flax_dense_init_(part, generator)
        self.dense_head.conv_cls.bias.fill_(-math.log(99.0))
        return self


class PVRCNNRoIHead(nn.Module):
    """Keypoint RoI grid pooling and the cls / reg branches. Per RoI: its
    grid points (`roi_grid_size`^3), the `roi_max_local` keypoints nearest
    its centre within 4 m, then per grid point the first `roi_nsample` of
    those within `roi_radius`; relative xyz and the keypoint's features
    through `pool_mlp` + ReLU, a max over the neighbours (empty groups 0),
    flattened grid-major then channel; two Linear + ReLU of 256, then
    `cls_pred` and `reg_pred`, both zero where the RoI is masked."""

    def __init__(self, cfg: PVRCNNConfig, kp_channels: int | None = None):
        super().__init__()
        self.cfg = cfg
        c = cfg.vsa.out_channels if kp_channels is None else kp_channels
        self.pool_mlp = nn.Linear(3 + c, 64)
        self.shared_fc0 = nn.Linear(cfg.roi_grid_size ** 3 * 64, 256)
        self.shared_fc1 = nn.Linear(256, 256)
        self.cls_pred = nn.Linear(256, 1)
        self.reg_pred = nn.Linear(256, 7)

    def forward(self, rois: torch.Tensor, roi_mask: torch.Tensor,
                keypoints: torch.Tensor, kp_feats: torch.Tensor):
        """rois (B, R, 7), roi_mask (B, R), keypoints (B, K, 3), kp_feats
        (B, K, C) -> (cls (B, R, 1), reg (B, R, 7))."""
        c = self.cfg
        grid = roi_grid_points(rois, c.roi_grid_size)          # (B, R, G, 3)
        every = torch.ones(keypoints.shape[:2], dtype=torch.bool,
                           device=keypoints.device)
        lidx, lmask = collect_local_voxels(rois[..., :3], keypoints, every,
                                           4.0, c.roi_max_local)
        nidx, nmask = grid_ball_query(grid, keypoints, lidx, lmask,
                                      c.roi_radius, c.roi_nsample)
        rel = gather_rows(keypoints, nidx) - grid[..., None, :]
        grouped = torch.cat([rel, gather_rows(kp_feats, nidx)], -1)
        h = torch.relu(self.pool_mlp(grouped))
        h = torch.where(nmask[..., None], h, -1e9).amax(3)
        h = torch.where(h <= -1e8, 0.0, h)
        h = h.reshape(*h.shape[:2], -1)
        h = torch.relu(self.shared_fc0(h))
        h = torch.relu(self.shared_fc1(h))
        m = roi_mask[..., None].to(h.dtype)
        out = self.cls_pred(h) * m, self.reg_pred(h) * m
        stages.mark("roi_head")
        return out

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "PVRCNNRoIHead":
        """flax's Dense initializer on every layer."""
        flax_dense_init_(self, generator)
        return self
