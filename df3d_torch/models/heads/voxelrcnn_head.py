"""Voxel R-CNN's second stage, its serving half (port of
df3d/models/heads/voxelrcnn_head.py): `VoxelRCNNHead` and
`decode_rcnn_boxes`.

Per scale (conv2, conv3, conv4 at strides 2, 4, 8; pcdet's
NeighborVoxelSAModuleMSG): `mlp_in` (Linear, no bias, + BN) on the voxel
features; per RoI grid point its neighbours (`ops.roi_ops`); `mlp_pos`
(Linear, no bias, + BN) on their offsets, added, ReLU, max-pool over the
neighbours; `mlp_out` (Linear, no bias, + BN + ReLU). Then the shared, cls
and reg FC stacks (Linear, no bias, + BN + ReLU) and the two predictors.
Every norm is `MaskedBatchNorm` at the JAX package's eps 1e-3 (torch's
default is 1e-5). ROI sampling, targets and losses (training) are not
ported yet.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from df3d_torch.core.box_coders import ResidualCoder
from df3d_torch.core.boxes import rotate_points_along_z
from df3d_torch.core.calib import voxel_centers_fma
from df3d_torch.models.backbones_3d import VoxelBackBone8x
from df3d_torch.models.layers import MaskedBatchNorm
from df3d_torch.ops.roi_ops import (
    collect_local_voxels, grid_ball_query, roi_grid_points,
)

CODER = ResidualCoder()
STAGE_CHANNELS = dict(zip(("conv1", "conv2", "conv3", "conv4"),
                          VoxelBackBone8x.CHANNELS))


@dataclasses.dataclass(frozen=True)
class RoIPoolScaleCfg:
    feature_key: str      # 'conv2' | 'conv3' | 'conv4'
    downsample: int       # 2 / 4 / 8
    radius: float         # POOL_RADIUS
    nsample: int = 16
    mlp: tuple = (32, 32)


@dataclasses.dataclass(frozen=True)
class VoxelRCNNHeadCfg:
    """The serving fields of the JAX package's `VoxelRCNNHeadCfg` (its
    ROI-sampling and loss fields belong to training)."""

    grid_size: int = 6
    scales: tuple = (
        RoIPoolScaleCfg("conv2", 2, 0.4),
        RoIPoolScaleCfg("conv3", 4, 0.8),
        RoIPoolScaleCfg("conv4", 8, 1.6),
    )
    max_local: int = 256      # stage-1 cap of voxels near a ROI
    coarse_radius: float = 4.0
    shared_fc: tuple = (256, 256)
    cls_fc: tuple = (256, 256)
    reg_fc: tuple = (256, 256)


class VoxelRCNNHead(nn.Module):
    """forward(rois (B, R, 7), roi_mask (B, R), ms_features {stage:
    SparseTensor}) -> (cls (B, R, 1), reg (B, R, 7)), zero for masked
    RoIs."""

    def __init__(self, cfg: VoxelRCNNHeadCfg, voxel_size, pc_range):
        super().__init__()
        self.cfg = cfg
        self.voxel_size, self.pc_range = tuple(voxel_size), tuple(pc_range)
        pooled = 0
        for s in cfg.scales:
            k, (c0, c1) = s.feature_key, s.mlp
            setattr(self, f"{k}_mlp_in",
                    nn.Linear(STAGE_CHANNELS[k], c0, bias=False))
            setattr(self, f"{k}_bn_in", MaskedBatchNorm(c0))
            setattr(self, f"{k}_mlp_pos", nn.Linear(3, c0, bias=False))
            setattr(self, f"{k}_bn_pos", MaskedBatchNorm(c0))
            setattr(self, f"{k}_mlp_out", nn.Linear(c0, c1, bias=False))
            setattr(self, f"{k}_bn_out", MaskedBatchNorm(c1))
            pooled += c1
        c = pooled * cfg.grid_size ** 3
        for stack in ("shared", "cls", "reg"):
            widths = getattr(cfg, f"{stack}_fc")
            w_in = c if stack == "shared" else cfg.shared_fc[-1]
            for i, ch in enumerate(widths):
                setattr(self, f"{stack}_fc{i}", nn.Linear(w_in, ch,
                                                          bias=False))
                setattr(self, f"{stack}_bn{i}", MaskedBatchNorm(ch))
                w_in = ch
        self.cls_pred = nn.Linear(cfg.cls_fc[-1], 1)
        self.reg_pred = nn.Linear(cfg.reg_fc[-1], 7)

    def _pool(self, s: RoIPoolScaleCfg, rois, roi_mask, st):
        """One scale's pooled grid features (B, R, G, mlp[1])."""
        c = self.cfg
        k = s.feature_key
        feats = getattr(self, f"{k}_bn_in")(
            getattr(self, f"{k}_mlp_in")(st.features), st.valid)
        xyz = voxel_centers_fma(st.coords, self.voxel_size, self.pc_range,
                                s.downsample)
        grid = roi_grid_points(rois, c.grid_size)               # (B, R, G, 3)
        lidx, lmask = collect_local_voxels(rois[..., :3], xyz, st.valid,
                                           c.coarse_radius, c.max_local)
        nidx, nmask = grid_ball_query(grid, xyz, lidx, lmask, s.radius,
                                      s.nsample)                # (B, R, G, K)
        b, r, g, _ = nidx.shape
        rows = torch.arange(b, device=nidx.device).view(b, 1, 1, 1)
        pos = getattr(self, f"{k}_bn_pos")(getattr(self, f"{k}_mlp_pos")(
            xyz[rows, nidx] - grid[..., None, :]), nmask)
        h = torch.relu(feats[rows, nidx] + pos)
        h = torch.where(nmask[..., None], h, -1e9).amax(3)
        h = torch.where(h <= -1e8, 0.0, h)
        h = getattr(self, f"{k}_mlp_out")(h)
        gmask = roi_mask[:, :, None].expand(b, r, g)
        return torch.relu(getattr(self, f"{k}_bn_out")(h, gmask))

    def _fc(self, stack: str, h, rmask):
        for i in range(len(getattr(self.cfg, f"{stack}_fc"))):
            h = getattr(self, f"{stack}_fc{i}")(h)
            h = torch.relu(getattr(self, f"{stack}_bn{i}")(h, rmask))
        return h

    def forward(self, rois: torch.Tensor, roi_mask: torch.Tensor,
                ms_features: dict):
        roi_mask = roi_mask.bool()
        pooled = [self._pool(s, rois, roi_mask, ms_features[s.feature_key])
                  for s in self.cfg.scales]
        feat = torch.cat(pooled, -1)                  # (B, R, G, sum C)
        feat = feat.reshape(*feat.shape[:2], -1)      # grid-major
        shared = self._fc("shared", feat, roi_mask)
        m = roi_mask[..., None].to(feat.dtype)
        cls = self.cls_pred(self._fc("cls", shared, roi_mask)) * m
        reg = self.reg_pred(self._fc("reg", shared, roi_mask)) * m
        return cls, reg


def decode_rcnn_boxes(rois: torch.Tensor,
                      reg_preds: torch.Tensor) -> torch.Tensor:
    """RoI-frame residuals -> world boxes: decoded against the RoI moved to
    the origin with heading 0, rotated by the RoI's heading and moved back.
    (..., 7) each."""
    rois_anchor = torch.cat([torch.zeros_like(rois[..., :3]), rois[..., 3:6],
                             torch.zeros_like(rois[..., 6:])], -1)
    local = CODER.decode(reg_preds, rois_anchor)
    xyz = rotate_points_along_z(local[..., None, 0:3], rois[..., 6])[..., 0, :]
    return torch.cat([xyz + rois[..., :3], local[..., 3:6],
                      local[..., 6:] + rois[..., 6:]], -1)
