"""Voxel R-CNN's anchor RPN head (port of df3d/models/heads/anchor_head.py):
`AnchorClassCfg`, `generate_anchors`, `AnchorHeadSingle` and
`anchor_head_decode` (serving); `assign_anchor_targets`,
`add_sin_difference` and `anchor_head_loss` (training).

Anchors are flattened location-major, in (y, x, class, rotation) order: the
order in which a channel-last 1x1 conv's output, reshaped to (B, H*W*A,
.), lists its per-anchor predictions. The head's 1x1 convs run here as
`nn.Linear` on the channel-last BEV map, so the reshape reads the same
order (an NCHW conv would have to be permuted first).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from df3d_torch.core.box_coders import ResidualCoder
from df3d_torch.core.boxes import limit_period
from df3d_torch.core.iou import iou_nearest_bev
from df3d_torch.models.losses import sigmoid_focal_loss, weighted_smooth_l1
from df3d_torch.parallel import ddp


# pcdet's direction classifier: two bins, headings offset by ~pi/4
NUM_DIR_BINS = 2
DIR_OFFSET = 0.78539
# pcdet's LOSS_WEIGHTS of the anchor head (kitti_models/voxel_rcnn_car.yaml)
CLS_WEIGHT, LOC_WEIGHT, DIR_WEIGHT = 1.0, 2.0, 0.2


@dataclasses.dataclass(frozen=True)
class AnchorClassCfg:
    name: str
    size: tuple          # (dx, dy, dz)
    bottom_height: float
    matched_threshold: float     # target assignment: positive at or above
    unmatched_threshold: float   # negative below; ignored in between
    rotations: tuple = (0.0, 1.5707963)


def generate_anchors(grid_size_xy: tuple, pc_range,
                     classes: Sequence[AnchorClassCfg]) -> np.ndarray:
    """-> (ny, nx, num_classes, num_rot, 7) float32 (pcdet's
    AnchorGenerator): anchor centres on the corners of the BEV grid, z at
    the class's box centre."""
    nx, ny = grid_size_xy
    all_anchors = []
    for cfg in classes:
        x_stride = (pc_range[3] - pc_range[0]) / (nx - 1)
        y_stride = (pc_range[4] - pc_range[1]) / (ny - 1)
        xs = pc_range[0] + np.arange(nx) * x_stride
        ys = pc_range[1] + np.arange(ny) * y_stride
        z = cfg.bottom_height + cfg.size[2] / 2
        xx, yy, rr = np.meshgrid(xs, ys, np.asarray(cfg.rotations),
                                 indexing="ij")
        a = np.stack([xx, yy, np.full_like(xx, z),
                      np.full_like(xx, cfg.size[0]),
                      np.full_like(xx, cfg.size[1]),
                      np.full_like(xx, cfg.size[2]), rr], axis=-1)
        all_anchors.append(a.transpose(1, 0, 2, 3))  # (ny, nx, R, 7)
    return np.stack(all_anchors, axis=2).astype(np.float32)


class AnchorHeadSingle(nn.Module):
    """1x1 conv heads over the channel-last BEV map (pcdet's
    anchor_head_single.py): class logits, box residuals and direction-bin
    logits per anchor."""

    def __init__(self, in_channels: int, num_classes: int,
                 num_anchors_per_loc: int):
        super().__init__()
        self.num_classes = num_classes
        n = num_anchors_per_loc
        self.conv_cls = nn.Linear(in_channels, n * num_classes)
        self.conv_box = nn.Linear(in_channels, n * 7)
        self.conv_dir = nn.Linear(in_channels, n * NUM_DIR_BINS)

    def forward(self, bev: torch.Tensor):
        """bev (B, H, W, C) -> cls (B, H*W*A, ncls), box (B, H*W*A, 7),
        dir (B, H*W*A, 2)."""
        b = bev.shape[0]
        return (self.conv_cls(bev).reshape(b, -1, self.num_classes),
                self.conv_box(bev).reshape(b, -1, 7),
                self.conv_dir(bev).reshape(b, -1, NUM_DIR_BINS))


def anchor_head_decode(cls_preds, box_preds, dir_preds, anchors,
                       coder: ResidualCoder):
    """Residuals decoded at every anchor, the heading snapped to the
    predicted direction bin (period pi, offset DIR_OFFSET; the first bin
    wins a tie). -> (scores (B, A, ncls) sigmoid, boxes (B, A, 7))."""
    boxes = coder.decode(box_preds, anchors[None])
    dir_bin = dir_preds.argmax(-1)
    rot = limit_period(boxes[..., 6] - DIR_OFFSET, 0.0, math.pi)
    heading = rot + DIR_OFFSET + math.pi * dir_bin
    boxes = torch.cat([boxes[..., :6], heading[..., None]], -1)
    return torch.sigmoid(cls_preds), boxes


def assign_anchor_targets(anchors: torch.Tensor, gt_boxes: torch.Tensor,
                          gt_mask: torch.Tensor, matched_thr: float,
                          unmatched_thr: float, coder: ResidualCoder):
    """One class's anchor assignment (pcdet's AxisAlignedTargetAssigner):
    anchors (A, 7), gt_boxes (M, 7), gt_mask (M,) valid and of this class.
    By `iou_nearest_bev`, an anchor is positive (1) at or above
    `matched_thr` to its best gt, negative (0) below `unmatched_thr`,
    ignored (-1) between; each gt's best anchor is forced positive when it
    overlaps some gt (two gts may force one anchor). Ties go to the lower
    index. -> (labels (A,) int32, reg_targets (A, 7) zero off the
    positives, best gt index (A,))."""
    a = anchors.shape[0]
    iou = iou_nearest_bev(anchors, gt_boxes)
    iou = torch.where(gt_mask[None, :], iou, torch.full_like(iou, -1.0))
    best_gt_iou, best_gt_idx = iou.max(1)
    labels = torch.full((a,), -1, dtype=torch.int32, device=anchors.device)
    labels = torch.where(best_gt_iou < unmatched_thr,
                         torch.zeros_like(labels), labels)
    labels = torch.where(best_gt_iou >= matched_thr,
                         torch.ones_like(labels), labels)
    force = torch.zeros(a, dtype=torch.bool, device=anchors.device)
    force[iou.argmax(0)[gt_mask]] = True
    labels = torch.where(force & (best_gt_iou > 0), torch.ones_like(labels),
                         labels)
    reg_targets = coder.encode(gt_boxes[best_gt_idx], anchors)
    reg_targets = reg_targets * (labels == 1)[:, None]
    return labels, reg_targets, best_gt_idx


def add_sin_difference(pred_rot: torch.Tensor, target_rot: torch.Tensor):
    """sin(a - b) = sin a cos b - cos a sin b, as the two terms the heading
    channel's smooth-L1 compares."""
    return (torch.sin(pred_rot) * torch.cos(target_rot),
            torch.cos(pred_rot) * torch.sin(target_rot))


def direction_targets(rot_gt: torch.Tensor) -> torch.Tensor:
    """The direction bin of a heading: floor(limit_period(rot -
    DIR_OFFSET, 0, 2 pi) / pi), clipped to the two bins."""
    rot = limit_period(rot_gt - DIR_OFFSET, 0.0, 2 * math.pi)
    return torch.floor(rot / math.pi).long().clamp(0, NUM_DIR_BINS - 1)


def anchor_head_loss(cls_preds, box_preds, dir_preds, labels, reg_targets,
                     anchors, gt_classes_per_anchor, num_classes: int):
    """pcdet's anchor_head_template get_loss, batched (B, A, .): focal loss
    on positives and negatives over each sample's positive count (at least
    1), smooth-L1 on the positives' residuals with the heading compared as
    sin(a - b), and the direction bins' cross entropy on the positives;
    each summed and divided by B (the global batch's, under
    `parallel.ddp.data_parallel`), weighted 1, 2 and 0.2. -> (total, logs:
    rpn_cls_loss, rpn_loc_loss, rpn_dir_loss, rpn_loss)."""
    b = labels.shape[0] * ddp.world_size()  # the global batch
    pos = (labels == 1).to(cls_preds.dtype)
    neg = (labels == 0).to(cls_preds.dtype)
    num_pos = pos.sum(1, keepdim=True).clamp_min(1.0)

    cls_t = torch.where(labels == 1, gt_classes_per_anchor.long() + 1,
                        torch.zeros_like(labels, dtype=torch.long))
    one_hot = F.one_hot(cls_t, num_classes + 1)[..., 1:].to(cls_preds.dtype)
    cls_loss = sigmoid_focal_loss(cls_preds, one_hot,
                                  (pos + neg) / num_pos).sum() / b

    reg_w = pos / num_pos
    p_sin, t_sin = add_sin_difference(box_preds[..., 6], reg_targets[..., 6])
    p = torch.cat([box_preds[..., :6], p_sin[..., None]], -1)
    t = torch.cat([reg_targets[..., :6], t_sin[..., None]], -1)
    loc_loss = weighted_smooth_l1(p, t, reg_w).sum() / b

    dir_t = direction_targets(reg_targets[..., 6] + anchors[None, :, 6])
    ce = -torch.gather(F.log_softmax(dir_preds, -1), -1, dir_t[..., None])
    dir_loss = (ce[..., 0] * reg_w).sum() / b
    total = (CLS_WEIGHT * cls_loss + LOC_WEIGHT * loc_loss
             + DIR_WEIGHT * dir_loss)
    return total, {"rpn_cls_loss": cls_loss, "rpn_loc_loss": loc_loss,
                   "rpn_dir_loss": dir_loss, "rpn_loss": total}
