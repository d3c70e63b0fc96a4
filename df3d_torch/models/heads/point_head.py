"""PV-RCNN's keypoint head (port of df3d/models/heads/point_head.py):
pcdet's PointHeadSimple, an MLP over the keypoint features that predicts
foreground, supervised by point-in-enlarged-gt-box labels; its sigmoid
re-weights the keypoint features before the RoI head (predicted keypoint
weighting)."""

from __future__ import annotations

import torch
from torch import nn

from df3d_torch.core.boxes import enlarge_box3d, points_in_boxes


class PointHeadSimple(nn.Module):
    """(B, K, C) keypoint features -> (B, K) foreground logits: Linear +
    ReLU per `hidden` width (flax's `fc<i>`), then `cls`."""

    def __init__(self, in_channels: int, hidden=(256, 256)):
        super().__init__()
        widths = (in_channels, *hidden)
        for i, (a, b) in enumerate(zip(widths[:-1], widths[1:])):
            setattr(self, f"fc{i}", nn.Linear(a, b))
        self.num_hidden = len(hidden)
        self.cls = nn.Linear(widths[-1], 1)

    def forward(self, point_feats: torch.Tensor) -> torch.Tensor:
        h = point_feats
        for i in range(self.num_hidden):
            h = torch.relu(getattr(self, f"fc{i}")(h))
        return self.cls(h)[..., 0]


def point_fg_labels(keypoints: torch.Tensor, gt_boxes: torch.Tensor,
                    gt_valid: torch.Tensor,
                    extra_width=(0.2, 0.2, 0.2)) -> torch.Tensor:
    """1.0 where a keypoint lies inside a valid gt box grown by
    `extra_width`, faces included. keypoints (B, K, 3), gt_boxes (B, M,
    7+), gt_valid (B, M) -> (B, K) f32."""
    big = enlarge_box3d(gt_boxes[..., :7], extra_width)
    inside = points_in_boxes(keypoints, big) & gt_valid[:, None, :]
    return inside.any(-1).to(torch.float32)


def point_cls_loss(logits: torch.Tensor, labels: torch.Tensor,
                   valid: torch.Tensor | None = None) -> torch.Tensor:
    """Focal BCE (alpha 0.25, gamma 2) averaged over the (valid)
    keypoints, pcdet's point segmentation loss."""
    p = torch.sigmoid(logits)
    pt = labels * p + (1 - labels) * (1 - p)
    alpha_w = labels * 0.25 + (1 - labels) * 0.75
    bce = (logits.clamp_min(0) - logits * labels
           + torch.log1p(torch.exp(-logits.abs())))
    loss = alpha_w * (1 - pt) ** 2 * bce
    if valid is not None:
        return (loss * valid).sum() / valid.sum().clamp_min(1.0)
    return loss.mean()
