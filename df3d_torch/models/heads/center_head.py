"""CenterPoint detection head (port of df3d/models/heads/center_head.py).

`SepHeadBranch`, `CenterHead` (without the DCN adaption),
`center_head_targets` / `center_head_loss` (the training targets and loss)
and `center_head_predict`: top-k decode plus rotated BEV NMS, all on the
device with static shapes. Maps are channel-last (B, H, W, C) at the public
functions, as in the JAX package. The head's BatchNorms are flax defaults
(eps 1e-5, momentum 0.99) and its convs carry a bias.

Box outputs are 9-dof (x, y, z, dx, dy, dz, heading, vx, vy).
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from df3d_torch.core.nms import nms_bev, top_k_stable
from df3d_torch.core.target_utils import assign_center_targets
from df3d_torch.models.layers import FlaxBatchNorm2d, conv2d_same
from df3d_torch.models.losses import (
    clamped_sigmoid, fast_focal_loss, reg_l1_loss,
)

# (name, out_channels, num_convs): det3d common_heads for nuScenes
DEFAULT_BRANCHES = (
    ("reg", 2, 2), ("height", 1, 2), ("dim", 3, 2), ("rot", 2, 2),
    ("vel", 2, 2),
)


class SepHeadBranch(nn.Module):
    """(num_convs - 1) x [conv + BN + ReLU], then a final conv; NCHW."""

    def __init__(self, in_channels: int, out_channels: int, num_convs: int,
                 head_conv: int = 64, final_kernel: int = 3):
        super().__init__()
        k = final_kernel
        self.convs = nn.ModuleList()
        self.bns = nn.ModuleList()
        c = in_channels
        for _ in range(num_convs - 1):
            self.convs.append(nn.Conv2d(c, head_conv, k))
            self.bns.append(FlaxBatchNorm2d(head_conv, eps=1e-5))
            c = head_conv
        self.out = nn.Conv2d(c, out_channels, k)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for conv, bn in zip(self.convs, self.bns):
            x = torch.relu(bn(conv2d_same(conv, x)))
        return conv2d_same(self.out, x)


class CenterHead(nn.Module):
    def __init__(self, in_channels: int, task_num_classes: Sequence[int],
                 branches: tuple = DEFAULT_BRANCHES,
                 share_conv_channel: int = 64):
        super().__init__()
        self.task_num_classes = tuple(task_num_classes)
        self.branch_names = tuple(name for name, _, _ in branches) + ("hm",)
        self.shared_conv = nn.Conv2d(in_channels, share_conv_channel, 3)
        self.shared_bn = FlaxBatchNorm2d(share_conv_channel, eps=1e-5)
        self.tasks = nn.ModuleList()
        for ncls in self.task_num_classes:
            task = nn.ModuleDict({
                name: SepHeadBranch(share_conv_channel, ch, nconv)
                for name, ch, nconv in branches})
            task["hm"] = SepHeadBranch(share_conv_channel, ncls, 2)
            self.tasks.append(task)

    def forward(self, x: torch.Tensor) -> list[dict[str, torch.Tensor]]:
        """x (B, H, W, Cin) -> per task a dict of (B, H, W, c) maps, with
        the heatmap logits under 'hm'."""
        x = x.permute(0, 3, 1, 2).contiguous()
        x = torch.relu(self.shared_bn(conv2d_same(self.shared_conv, x)))
        return [{name: task[name](x).permute(0, 2, 3, 1)
                 for name in self.branch_names} for task in self.tasks]


def center_head_targets(gt_boxes, gt_classes, gt_valid, task_num_classes,
                        feature_size, voxel_size, pc_range, out_size_factor,
                        gaussian_overlap=0.1, min_radius=2, max_objs=500):
    """Per task, the batched targets of `assign_center_targets`. gt_classes
    are global ids; each task takes its contiguous slice of them (det3d's
    AssignLabel task split)."""
    targets, offset = [], 0
    for ncls in task_num_classes:
        in_task = ((gt_classes >= offset) & (gt_classes < offset + ncls)
                   & gt_valid)
        local = (gt_classes - offset).clamp(0, ncls - 1)
        targets.append(assign_center_targets(
            gt_boxes, local, in_task, ncls, feature_size, voxel_size,
            pc_range, out_size_factor, gaussian_overlap, min_radius,
            max_objs))
        offset += ncls
    return targets


def center_head_loss(preds, targets, code_weights, loc_weight=0.25):
    """Sum over tasks of the focal heatmap loss and loc_weight x the
    code-weighted L1 box loss -> (total, logs with per-task hm and loc
    losses and the total under "loss")."""
    total, logs = 0.0, {}
    cw = torch.tensor(code_weights, dtype=preds[0]["reg"].dtype,
                      device=preds[0]["reg"].device)
    for t, (pred, tgt) in enumerate(zip(preds, targets)):
        b, h, w, ncls = pred["hm"].shape
        hm = clamped_sigmoid(pred["hm"]).reshape(b, h * w, ncls)
        tgt_hm = tgt["heatmap"].permute(0, 2, 3, 1).reshape(b, h * w, ncls)
        hm_loss = fast_focal_loss(hm, tgt_hm, tgt["inds"], tgt["mask"],
                                  tgt["cats"])
        reg_map = torch.cat([pred["reg"], pred["height"], pred["dim"],
                             pred["vel"], pred["rot"]], -1).reshape(
                                 b, h * w, -1)
        box_loss = reg_l1_loss(reg_map, tgt["inds"], tgt["mask"],
                               tgt["anno_box"])
        loc_loss = (box_loss * cw).sum()
        total = total + hm_loss + loc_weight * loc_loss
        logs[f"task{t}_hm_loss"] = hm_loss
        logs[f"task{t}_loc_loss"] = loc_loss
    logs["loss"] = total
    return total, logs


def center_head_predict(
    preds, voxel_size, pc_range, out_size_factor, post_center_range,
    score_threshold=0.1, nms_thresh=0.2, pre_max_size=1024, post_max_size=83,
):
    """Decode + rotated NMS on the device.

    Returns a dict with boxes (B, K, 9), scores (B, K), labels (B, K) and
    valid (B, K), K = num_tasks * post_max_size. All (batch x task) NMS
    problems run as one batched call.
    """
    dev = preds[0]["hm"].device
    pcr = torch.tensor(post_center_range, dtype=torch.float32, device=dev)
    cand_boxes, cand_scores, cand_labels, cand_ok = [], [], [], []
    class_offset = 0
    for pred in preds:
        b, h, w, ncls = pred["hm"].shape
        hm = clamped_sigmoid(pred["hm"]).reshape(b, h * w, ncls)
        scores, labels = hm.max(-1)
        labels = labels + class_offset
        top_scores, idx = top_k_stable(scores, pre_max_size)

        def take(name, c):
            m = pred[name].reshape(b, h * w, c)
            return torch.gather(m, 1, idx[..., None].expand(-1, -1, c))

        ys = torch.div(idx, w, rounding_mode="floor").to(torch.float32)
        xs = (idx % w).to(torch.float32)
        reg = take("reg", 2)
        x = (xs + reg[..., 0]) * out_size_factor * voxel_size[0] + pc_range[0]
        y = (ys + reg[..., 1]) * out_size_factor * voxel_size[1] + pc_range[1]
        z = take("height", 1)[..., 0]
        dims = torch.exp(take("dim", 3))
        rot = take("rot", 2)
        heading = torch.atan2(rot[..., 0], rot[..., 1])
        boxes = torch.cat([torch.stack([x, y, z], -1), dims,
                           heading[..., None], take("vel", 2)], -1)
        in_range = ((boxes[..., :3] >= pcr[:3]).all(-1)
                    & (boxes[..., :3] <= pcr[3:]).all(-1))
        cand_boxes.append(boxes)
        cand_scores.append(top_scores)
        cand_labels.append(torch.gather(labels, 1, idx))
        cand_ok.append((top_scores > score_threshold) & in_range)
        class_offset += ncls

    nt = len(preds)
    boxes = torch.stack(cand_boxes, 1).reshape(b * nt, pre_max_size, -1)
    scores = torch.stack(cand_scores, 1).reshape(b * nt, pre_max_size)
    labels = torch.stack(cand_labels, 1).reshape(b * nt, pre_max_size)
    ok = torch.stack(cand_ok, 1).reshape(b * nt, pre_max_size)

    keep_idx, keep_mask = nms_bev(
        boxes[..., :7], scores, nms_thresh, pre_max_size=pre_max_size,
        post_max_size=post_max_size, valid=ok)
    kb = torch.gather(boxes, 1,
                      keep_idx[..., None].expand(-1, -1, boxes.shape[-1]))
    ks = torch.gather(scores, 1, keep_idx) * keep_mask
    kl = torch.gather(labels, 1, keep_idx)
    k = nt * post_max_size
    return {
        "boxes": kb.reshape(b, k, -1),
        "scores": ks.reshape(b, k),
        "labels": kl.reshape(b, k),
        "valid": keep_mask.reshape(b, k),
    }
