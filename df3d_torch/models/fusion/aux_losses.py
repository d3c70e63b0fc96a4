"""The fused detectors' auxiliary losses: image foreground segmentation and
voxel/camera feature consistency (port of df3d/models/fusion/aux_losses.py;
the reference's SemanticSeg/aux_seg_loss.py `AuxImgSegmentLoss` and
`AuxConsistencyLoss`).

Both losses' normalizers cover the global batch under data parallelism
(`parallel.ddp.global_sum`): the segmentation loss's mean divides by the
element count of every rank's maps, the consistency loss by every rank's
mask sum, so each rank's loss is its share of the global loss.
"""

from __future__ import annotations

import torch

from df3d_torch.parallel import ddp


def render_fg_mask_from_boxes2d(boxes2d: torch.Tensor, valid: torch.Tensor,
                                image_hw) -> torch.Tensor:
    """boxes2d (M, 4) xyxy pixels, valid (M,) -> (H, W) f32 mask of the
    pixels inside any valid box (edges included)."""
    h, w = image_hw
    ys = torch.arange(h, device=boxes2d.device)[:, None]
    xs = torch.arange(w, device=boxes2d.device)[None, :]
    b = boxes2d[:, :, None, None]
    inside = ((xs >= b[:, 0]) & (xs <= b[:, 2]) & (ys >= b[:, 1])
              & (ys <= b[:, 3]) & valid[:, None, None])
    return inside.any(0).float()


def aux_img_segment_loss(seg_logits: torch.Tensor, fg_mask: torch.Tensor,
                         alpha: float = 0.25,
                         gamma: float = 2.0) -> torch.Tensor:
    """Focal BCE between the FG logit maps (B, H, W, 1) and the rendered
    masks (B, H, W), the mean over every element."""
    p = torch.sigmoid(seg_logits[..., 0])
    t = fg_mask
    pt = t * p + (1 - t) * (1 - p)
    alpha_w = t * alpha + (1 - t) * (1 - alpha)
    loss = -alpha_w * (1 - pt) ** gamma * torch.log(pt.clamp(1e-6, 1.0))
    count = torch.tensor(float(loss.numel()), device=loss.device)
    return loss.sum() / ddp.global_sum(count)


def aux_consistency_loss(voxel_feats: torch.Tensor,
                         image_feats_at_voxels: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Squared L2 between the voxel features and the image features at
    their projections, both (B, N, C), summed over the channels and the
    rows `mask` (B, N) keeps, over max(mask's sum, 1)."""
    m = mask.to(voxel_feats.dtype)
    d = (voxel_feats - image_feats_at_voxels).square().sum(-1)
    return (d * m).sum() / ddp.global_sum(m.sum()).clamp_min(1.0)
