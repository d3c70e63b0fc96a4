"""Detection losses (port of df3d/models/losses.py): the CenterPoint head's
(det3d centernet_loss.py: CornerNet focal loss with gaussian-weighted
negatives, masked L1 at the peak indices), TransFusion's (mmdet's
sigmoid focal loss on the queries' classes, Gaussian focal loss on the
dense heatmap; its L1 on the encoded boxes is written in the head's loss)
and Voxel R-CNN's (pcdet's sigmoid focal loss and weighted smooth-L1).

The normalizers that count over the batch are global sums
(`parallel.ddp.global_sum`): under data parallelism each rank's loss is its
share of the loss of the global batch."""

from __future__ import annotations

import torch

from df3d_torch.parallel import ddp


def clamped_sigmoid(x: torch.Tensor, eps: float = 1e-4) -> torch.Tensor:
    return torch.clamp(torch.sigmoid(x), eps, 1 - eps)


def fast_focal_loss(pred: torch.Tensor, target: torch.Tensor,
                    ind: torch.Tensor, mask: torch.Tensor,
                    cat: torch.Tensor) -> torch.Tensor:
    """pred (B, H*W, C) probabilities, target (B, H*W, C) gaussian heatmap,
    ind (B, M) flat peak indices, mask (B, M) bool, cat (B, M) class ids.
    -> scalar: -(pos + neg) / num_pos, or -neg with no positive; num_pos
    over the global batch."""
    neg_loss = (torch.log(1 - pred) * pred ** 2 * (1 - target) ** 4).sum()
    at_peaks = torch.gather(pred, 1, ind[..., None].expand(
        -1, -1, pred.shape[2]))
    pos_pred = torch.gather(at_peaks, 2, cat[..., None])[..., 0]
    num_pos = ddp.global_sum(mask.sum().to(pred.dtype))
    pos_loss = (torch.log(pos_pred) * (1 - pos_pred) ** 2 * mask).sum()
    return torch.where(num_pos == 0, -neg_loss,
                       -(pos_loss + neg_loss) / num_pos.clamp_min(1.0))


def reg_l1_loss(pred_map: torch.Tensor, ind: torch.Tensor, mask: torch.Tensor,
                target: torch.Tensor) -> torch.Tensor:
    """Masked L1 at the peaks. pred_map (B, H*W, C), ind and mask (B, M),
    target (B, M, C) -> per-channel sum / num_pos (over the global batch),
    (C,)."""
    pred = torch.gather(pred_map, 1, ind[..., None].expand(
        -1, -1, pred_map.shape[2]))
    m = mask.to(pred.dtype)[..., None]
    loss = (pred * m - target * m).abs() / (ddp.global_sum(m.sum())
                                            + 1e-4)
    return loss.sum((0, 1))


def sigmoid_focal_loss(logits: torch.Tensor, targets: torch.Tensor,
                       weights: torch.Tensor, alpha: float = 0.25,
                       gamma: float = 2.0) -> torch.Tensor:
    """Per-element focal loss times `weights` (pcdet
    SigmoidFocalClassificationLoss): one-hot {0, 1} targets; weights of one
    dim fewer than the loss broadcast over the class dim."""
    p = torch.sigmoid(logits)
    alpha_w = targets * alpha + (1 - targets) * (1 - alpha)
    pt = targets * (1 - p) + (1 - targets) * p
    bce = (logits.clamp_min(0) - logits * targets
           + torch.log1p(torch.exp(-logits.abs())))
    loss = alpha_w * pt ** gamma * bce
    if weights.dim() == loss.dim() - 1:
        weights = weights[..., None]
    return loss * weights


def weighted_smooth_l1(pred: torch.Tensor, target: torch.Tensor,
                       weights: torch.Tensor, beta: float = 1.0 / 9.0,
                       code_weights=None) -> torch.Tensor:
    """Per-element smooth-L1 times `weights` (pcdet WeightedSmoothL1Loss):
    the difference scaled by `code_weights` per code channel, quadratic
    below `beta`; weights of one dim fewer than the loss broadcast over
    the code dim."""
    diff = pred - target
    if code_weights is not None:
        diff = diff * torch.tensor(code_weights, dtype=diff.dtype,
                                   device=diff.device)
    n = diff.abs()
    loss = torch.where(n < beta, 0.5 * n ** 2 / beta, n - 0.5 * beta)
    if weights.dim() == loss.dim() - 1:
        weights = weights[..., None]
    return loss * weights


def gaussian_focal_loss(pred: torch.Tensor, target: torch.Tensor,
                        alpha: float = 2.0, gamma: float = 4.0
                        ) -> torch.Tensor:
    """mmdet's GaussianFocalLoss per element: positives where target == 1,
    negatives weighted by (1 - target)^gamma."""
    eps = 1e-12
    pos_w = (target == 1).to(pred.dtype)
    neg_w = (1 - target) ** gamma
    pos = -torch.log(pred + eps) * (1 - pred) ** alpha * pos_w
    neg = -torch.log(1 - pred + eps) * pred ** alpha * neg_w * (1 - pos_w)
    return pos + neg
