"""Voxel R-CNN's second stage (port of df3d/models/heads/voxelrcnn_head.py):
`VoxelRCNNHead` and `decode_rcnn_boxes` (serving); the proposal target
layer `sample_rois_for_training`, `canonical_reg_targets` and `rcnn_loss`
(training).

Per scale (conv2, conv3, conv4 at strides 2, 4, 8; pcdet's
NeighborVoxelSAModuleMSG): `mlp_in` (Linear, no bias, + BN) on the voxel
features; per RoI grid point its neighbours (`ops.roi_ops`); `mlp_pos`
(Linear, no bias, + BN) on their offsets, added, ReLU, max-pool over the
neighbours; `mlp_out` (Linear, no bias, + BN + ReLU). Then the shared, cls
and reg FC stacks (Linear, no bias, + BN + ReLU) and the two predictors.
Every norm is `MaskedBatchNorm` at the JAX package's eps 1e-3 (torch's
default is 1e-5); in training they normalise with the batch statistics of
the valid rows (voxels, neighbours, the sampled RoIs). The max-pool is
`amax`, which splits a tie's gradient evenly, as JAX's `max` does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from df3d_torch.core.box_coders import ResidualCoder
from df3d_torch.core.boxes import boxes_to_corners_3d, rotate_points_along_z
from df3d_torch.core.calib import voxel_centers_fma
from df3d_torch.core.iou import iou_3d
from df3d_torch.core.nms import top_k_stable
from df3d_torch.models.losses import weighted_smooth_l1
from df3d_torch.models.backbones_3d import VoxelBackBone8x
from df3d_torch.models.layers import MaskedBatchNorm, promoted
from df3d_torch.ops.roi_ops import (
    collect_local_voxels, grid_ball_query, roi_grid_points,
)
from df3d_torch.parallel import ddp

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
    # proposal target layer
    roi_per_image: int = 128
    fg_ratio: float = 0.5
    reg_fg_thresh: float = 0.55
    cls_fg_thresh: float = 0.75
    cls_bg_thresh: float = 0.25
    # losses
    cls_weight: float = 1.0
    reg_weight: float = 1.0
    corner_weight: float = 1.0
    code_weights: tuple = (1.0,) * 7


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
        mlp_in = getattr(self, f"{k}_mlp_in")
        feats = getattr(self, f"{k}_bn_in")(
            mlp_in(promoted(st.features, mlp_in)), st.valid)
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


def sample_rois_for_training(rois, roi_scores, roi_mask, gt_boxes, gt_valid,
                             noise, cfg: VoxelRCNNHeadCfg) -> dict:
    """The proposal target layer, batched: rois (B, R0, 7), roi_scores and
    roi_mask (B, R0), gt_boxes (B, M, 7), gt_valid (B, M), noise (B, R0)
    (the JAX package draws it as uniform(key_b) * 1e-3 per sample; it
    breaks ties among equal IoUs). Each RoI's best 3D IoU over the valid
    gts ranks it as foreground (>= reg_fg_thresh) or background; the
    `roi_per_image * fg_ratio` best foreground and the rest background RoIs
    are kept (ties to the lower index), a slot with no RoI of its kind
    masked. -> dict rois (B, R, 7), roi_scores, cls_targets (IoU mapped
    linearly from [cls_bg_thresh, cls_fg_thresh] to [0, 1]), reg_valid,
    gt_of_roi (B, R, 7), mask (B, R)."""
    iou = iou_3d(rois, gt_boxes)
    iou = torch.where(gt_valid[:, None, :] & roi_mask[:, :, None].bool(),
                      iou, torch.full_like(iou, -1.0))
    max_iou, gt_idx = iou.max(-1)
    n_fg = int(cfg.roi_per_image * cfg.fg_ratio)
    n_bg = cfg.roi_per_image - n_fg
    neg = torch.full_like(max_iou, -1.0)
    fg_score = torch.where(max_iou >= cfg.reg_fg_thresh, max_iou + noise, neg)
    bg_score = torch.where((max_iou < cfg.reg_fg_thresh) & roi_mask.bool(),
                           1.0 - max_iou + noise, neg)
    fg_val, fg_sel = top_k_stable(fg_score, n_fg)
    bg_val, bg_sel = top_k_stable(bg_score, n_bg)
    sel = torch.cat([fg_sel, bg_sel], -1)
    sel_valid = torch.cat([fg_val > 0, bg_val > 0], -1)
    s_iou = max_iou.gather(1, sel)
    cls_t = ((s_iou - cfg.cls_bg_thresh)
             / (cfg.cls_fg_thresh - cfg.cls_bg_thresh)).clamp(0.0, 1.0)
    gt_sel = gt_idx.gather(1, sel)
    return {
        "rois": rois.gather(1, sel[..., None].expand(-1, -1, 7)),
        "roi_scores": roi_scores.gather(1, sel),
        "cls_targets": cls_t,
        "reg_valid": (s_iou >= cfg.reg_fg_thresh) & sel_valid,
        "gt_of_roi": gt_boxes.gather(1, gt_sel[..., None].expand(-1, -1, 7)),
        "mask": sel_valid,
    }


def canonical_reg_targets(rois: torch.Tensor,
                          gt_of_roi: torch.Tensor) -> torch.Tensor:
    """The gt encoded in its RoI's canonical frame (pcdet's
    roi_head_template assign_targets): centre moved by the RoI's and
    rotated by minus its heading, and the heading difference flipped by pi
    when the RoI is anti-aligned with its gt (in (pi/2, 3 pi/2)), so that
    the target stays in [-pi/2, pi/2]. (..., 7) each."""
    rois_anchor = torch.cat([torch.zeros_like(rois[..., :3]), rois[..., 3:6],
                             torch.zeros_like(rois[..., 6:])], -1)
    rel = gt_of_roi[..., :3] - rois[..., :3]
    xyz = rotate_points_along_z(rel[..., None, :], -rois[..., 6])[..., 0, :]
    h = torch.remainder(gt_of_roi[..., 6] - rois[..., 6], 2 * math.pi)
    opposite = (h > math.pi * 0.5) & (h < math.pi * 1.5)
    h = torch.where(opposite, torch.remainder(h + math.pi, 2 * math.pi), h)
    h = torch.where(h > math.pi, h - 2 * math.pi, h)
    heading = h.clamp(-math.pi / 2, math.pi / 2)
    local_gt = torch.cat([xyz, gt_of_roi[..., 3:6], heading[..., None]], -1)
    return CODER.encode(local_gt, rois_anchor)


def rcnn_loss(cls_preds, reg_preds, targets: dict, cfg: VoxelRCNNHeadCfg):
    """The RCNN head's losses: binary cross entropy of the cls logit
    against the IoU target over the sampled RoIs; smooth-L1 of the
    residuals against `canonical_reg_targets` and the corner loss (Huber at
    1 m on the mean corner distance of the decoded box to the gt or the gt
    turned by pi, whichever is nearer), both over the RoIs with a
    regression target; both counts over the global batch
    (`parallel.ddp.global_sum`). -> (total, logs: rcnn_cls_loss,
    rcnn_reg_loss, rcnn_corner_loss, rcnn_loss)."""
    mask = targets["mask"].to(cls_preds.dtype)
    cls = cls_preds[..., 0]
    # maximum, not clamp: a logit at 0 sends half its gradient each way, as
    # in JAX
    bce = (torch.maximum(cls, torch.zeros_like(cls))
           - cls * targets["cls_targets"]
           + torch.log1p(torch.exp(-cls.abs())))
    cls_loss = (bce * mask).sum() / ddp.global_sum(
        mask.sum()).clamp_min(1.0)

    reg_t = canonical_reg_targets(targets["rois"], targets["gt_of_roi"])
    reg_m = targets["reg_valid"].to(reg_preds.dtype)
    n_reg = ddp.global_sum(reg_m.sum()).clamp_min(1.0)
    loc = weighted_smooth_l1(reg_preds, reg_t, reg_m,
                             code_weights=cfg.code_weights).sum() / n_reg

    c_pred = boxes_to_corners_3d(decode_rcnn_boxes(targets["rois"],
                                                   reg_preds))
    gt = targets["gt_of_roi"]
    gt_flip = torch.cat([gt[..., :6], gt[..., 6:] + math.pi], -1)
    cd = torch.minimum(
        torch.linalg.vector_norm(c_pred - boxes_to_corners_3d(gt), dim=-1),
        torch.linalg.vector_norm(c_pred - boxes_to_corners_3d(gt_flip),
                                 dim=-1)).mean(-1)
    corner = torch.where(cd < 1.0, 0.5 * cd ** 2, cd - 0.5)
    corner_loss = (corner * reg_m).sum() / n_reg

    total = (cfg.cls_weight * cls_loss + cfg.reg_weight * loc
             + cfg.corner_weight * corner_loss)
    return total, {"rcnn_cls_loss": cls_loss, "rcnn_reg_loss": loc,
                   "rcnn_corner_loss": corner_loss, "rcnn_loss": total}
