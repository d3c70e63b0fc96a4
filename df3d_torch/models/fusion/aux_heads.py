"""The fused detectors' auxiliary training objective (port of
df3d/models/fusion/aux_heads.py): a small segmentation head over the
first image-branch scale predicts the image foreground; the target is
rendered from the gt boxes projected to the image; a consistency term
ties the voxel features at the fusion point to the camera features summed
into them (`aux_losses`).
"""

from __future__ import annotations

import torch
from torch import nn

from df3d_torch.core.boxes import boxes_to_corners_3d
from df3d_torch.core.calib import project_to_image
from df3d_torch.models.fusion.aux_losses import (
    aux_consistency_loss, aux_img_segment_loss,
)
from df3d_torch.models.layers import flax_trunc_normal_


class AuxSegHead(nn.Module):
    """One FG logit map over an image feature scale: 3x3 conv C -> C
    (padding 1), ReLU, 1x1 conv C -> 1."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = nn.Conv2d(channels, channels, 3, padding=1)
        self.out = nn.Conv2d(channels, 1, 1)

    def forward(self, feat: torch.Tensor) -> torch.Tensor:
        """feat (B, H, W, C) channel-last -> logits (B, H, W, 1)."""
        h = torch.relu(self.conv(feat.permute(0, 3, 1, 2)))
        return self.out(h).permute(0, 2, 3, 1)

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """flax's defaults: LeCun-normal kernels, zero biases."""
        for conv in (self.conv, self.out):
            cout, cin, kh, kw = conv.weight.shape
            flax_trunc_normal_(conv.weight, cin * kh * kw, 1.0, generator)
            conv.bias.zero_()
        return self


def render_fg_from_gt3d(gt_boxes: torch.Tensor, gt_valid: torch.Tensor,
                        proj: torch.Tensor, feat_hw, image_hw) -> torch.Tensor:
    """gt boxes (B, M, 7+), gt_valid (B, M), proj (B, 3, 4) -> (B, Hf, Wf)
    f32 FG masks at the feature resolution: each box's projected corners
    span a pixel rectangle (u / w * wf, in that order), which counts if
    the box is valid and its nearest corner lies more than 0.1 in front of
    the camera; the mask is their union."""
    hf, wf = feat_hw
    h, w = image_hw
    b, m = gt_boxes.shape[:2]
    corners = boxes_to_corners_3d(gt_boxes[..., :7])  # (B, M, 8, 3)
    uv, depth = project_to_image(proj, corners.reshape(b, m * 8, 3))
    uv, depth = uv.reshape(b, m, 8, 2), depth.reshape(b, m, 8)
    x1 = uv[..., 0].amin(-1) / w * wf
    x2 = uv[..., 0].amax(-1) / w * wf
    y1 = uv[..., 1].amin(-1) / h * hf
    y2 = uv[..., 1].amax(-1) / h * hf
    ok = gt_valid & (depth.amin(-1) > 0.1)
    ys = torch.arange(hf, device=gt_boxes.device)[:, None]
    xs = torch.arange(wf, device=gt_boxes.device)[None, :]

    def edge(e):
        return e[..., None, None]

    inside = ((xs >= edge(x1)) & (xs <= edge(x2)) & (ys >= edge(y1))
              & (ys <= edge(y2)) & edge(ok))
    return inside.any(1).float()


def fused_aux_losses(seg_logits: torch.Tensor, gt_boxes: torch.Tensor,
                     gt_valid: torch.Tensor, proj: torch.Tensor, image_hw,
                     voxel_feats: torch.Tensor | None = None,
                     image_feats_at_voxels: torch.Tensor | None = None,
                     voxel_mask: torch.Tensor | None = None,
                     seg_weight: float = 1.0,
                     consistency_weight: float = 0.1):
    """seg_logits (B, Hf, Wf, 1), gt boxes (B, M, 7+), gt_valid (B, M),
    proj (B, 3, 4), and the fusion point's consistency pair and mask when
    there is one -> (total, logs: aux_seg_loss, aux_consistency_loss when
    there is a pair, aux_loss), each term at its weight."""
    hf, wf = seg_logits.shape[1:3]
    with torch.no_grad():
        fg = render_fg_from_gt3d(gt_boxes, gt_valid, proj, (hf, wf),
                                 image_hw)
    total = seg_weight * aux_img_segment_loss(seg_logits, fg)
    logs = {"aux_seg_loss": total}
    if voxel_feats is not None:
        c = consistency_weight * aux_consistency_loss(
            voxel_feats, image_feats_at_voxels, voxel_mask)
        logs["aux_consistency_loss"] = c
        total = total + c
    logs["aux_loss"] = total
    return total, logs
