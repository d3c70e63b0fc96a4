"""Voxel R-CNN, KITTI's two-stage detector (port of
df3d/models/detectors/voxel_rcnn.py).

voxel features + coords -> `VoxelBackBone8x` (fully sparse) ->
height compression -> `BEVBackbone` -> `AnchorHeadSingle` (the RPN,
`VoxelRCNN`), then `proposal_layer` (anchor decode + rotated NMS to fixed
proposals), `VoxelRCNNHead` (RoI grid pooling over conv2..conv4 and the
refinement FCs) and `voxel_rcnn_post_processing` (decode, rotated NMS,
score threshold). The mean VFE is fused into the voxelizer.

Training: `assign_rpn_targets` (per class, `assign_anchor_targets`),
`proposal_layer(train=True)` (its own NMS settings), the head's proposal
target layer and `voxel_rcnn_train_losses`; `VoxelRCNNTwoStage` holds both
stages as one module, as the JAX package's `{"rpn", "rcnn"}` trees do.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from df3d_torch.core.box_coders import ResidualCoder
from df3d_torch.core.nms import nms_bev
from df3d_torch.models.backbones_3d import VoxelBackBone8x
from df3d_torch.models.detectors.centerpoint import init_detector_weights
from df3d_torch.models.heads.anchor_head import (
    AnchorClassCfg, AnchorHeadSingle, anchor_head_decode, anchor_head_loss,
    assign_anchor_targets, generate_anchors,
)
from df3d_torch.models.heads.voxelrcnn_head import (
    VoxelRCNNHead, VoxelRCNNHeadCfg, decode_rcnn_boxes, rcnn_loss,
)
from df3d_torch.models.layers import flax_dense_init_
from df3d_torch.models.necks import BEVBackbone
from df3d_torch.ops.sparse import SparseTensor
from df3d_torch.utils import stages

KITTI_CAR = AnchorClassCfg(
    name="Car", size=(3.9, 1.6, 1.56), bottom_height=-1.78,
    matched_threshold=0.6, unmatched_threshold=0.45)


@dataclasses.dataclass(frozen=True)
class VoxelRCNNConfig:
    """The JAX package's `VoxelRCNNConfig` (pcdet's voxel_rcnn_car.yaml)."""

    pc_range: tuple = (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
    voxel_size: tuple = (0.05, 0.05, 0.1)
    grid_size: tuple = (40, 1600, 1408)  # (Z, Y, X)
    max_voxels: int = 16_000
    max_points_per_voxel: int = 5
    num_point_features: int = 4
    stage_caps: tuple = (16_000, 12_000, 8_000, 4_000)
    anchor_classes: tuple = (KITTI_CAR,)
    out_size_factor: int = 8
    # proposals (pcdet NMS_CONFIG, train and test; pcdet's 9000 candidates
    # capped to a top-k)
    train_pre_nms: int = 1024
    train_post_nms: int = 512
    train_nms_thresh: float = 0.8
    test_pre_nms: int = 1024
    test_post_nms: int = 100
    test_nms_thresh: float = 0.7
    rcnn: VoxelRCNNHeadCfg = VoxelRCNNHeadCfg()
    # final NMS
    score_thresh: float = 0.3
    final_nms_thresh: float = 0.1
    final_max_boxes: int = 100

    @property
    def sparse_shape(self):
        z, y, x = self.grid_size
        return (z + 1, y, x)

    @property
    def bev_size_xy(self):
        return (self.grid_size[2] // self.out_size_factor,
                self.grid_size[1] // self.out_size_factor)


def build_anchors(cfg: VoxelRCNNConfig, device=None) -> torch.Tensor:
    """(A, 7) anchors, location-major (y, x, class, rotation)."""
    a = generate_anchors(cfg.bev_size_xy, cfg.pc_range, cfg.anchor_classes)
    return torch.from_numpy(a.reshape(-1, 7)).to(device)


def anchor_class_ids(cfg: VoxelRCNNConfig, device=None) -> torch.Tensor:
    """(A,) class id of every flattened anchor, in `build_anchors`' order."""
    n_loc = cfg.bev_size_xy[0] * cfg.bev_size_xy[1]
    n_rot = len(cfg.anchor_classes[0].rotations)
    per_loc = torch.arange(len(cfg.anchor_classes)).repeat_interleave(n_rot)
    return per_loc.repeat(n_loc).to(device)


class VoxelRCNN(nn.Module):
    """The first stage (RPN). Build, call `init_weights` (or load a state
    dict), `.eval()`."""

    def __init__(self, cfg: VoxelRCNNConfig,
                 fusion_hook: nn.Module | None = None):
        super().__init__()
        self.cfg = cfg
        self.backbone = VoxelBackBone8x(cfg.num_point_features, fusion_hook)
        bev_channels = 128 * VoxelBackBone8x.out_depth(cfg.sparse_shape[0])
        self.neck = BEVBackbone(
            bev_channels, layer_nums=(5, 5), layer_strides=(1, 2),
            num_filters=(64, 128), upsample_strides=(1, 2),
            num_upsample_filters=(128, 128))
        n_cls = len(cfg.anchor_classes)
        self.dense_head = AnchorHeadSingle(
            256, n_cls, n_cls * len(cfg.anchor_classes[0].rotations))
        # built once, moved with the module, outside the state dict
        self.register_buffer("anchors", build_anchors(cfg), persistent=False)

    def forward(self, voxel_features: torch.Tensor,
                voxel_coords: torch.Tensor, fusion_kwargs: dict | None = None):
        """voxel_features (B, V, F); voxel_coords (B, V, 3) (z, y, x), key
        sorted with -1 padding rows; fusion_kwargs the fusion hook's inputs.

        Returns (preds, overflow): preds holds the anchor head's "cls",
        "box" and "dir" (B, A, .) and the backbone's per-stage tensors
        "ms"; overflow the strided stages' cap overflows."""
        st = SparseTensor(voxel_features, voxel_coords, self.cfg.sparse_shape)
        v = voxel_features.shape[1]
        caps = tuple(min(c, v) for c in self.cfg.stage_caps)
        bev, ms, overflow = self.backbone(st, caps, fusion_kwargs)
        bev = self.neck(bev)
        stages.mark("neck")
        cls, box, dirp = self.dense_head(bev)
        return {"cls": cls, "box": box, "dir": dirp, "ms": ms}, overflow

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "VoxelRCNN":
        """Random weights drawn like the flax initializers: He-normal taps
        for the sparse convs, He truncated-normal for the neck, LeCun
        truncated-normal for the anchor head's 1x1 convs with zero biases
        but the class prior (-log 99), identity norms."""
        init_detector_weights(self, "dense_head.", generator)
        flax_dense_init_(self.dense_head, generator)
        self.dense_head.conv_cls.bias.fill_(-math.log(99.0))
        return self


@torch.no_grad()
def init_head_weights(head: VoxelRCNNHead,
                      generator: torch.Generator) -> VoxelRCNNHead:
    """The RCNN head's random weights as flax's Dense initializer draws
    them (LeCun truncated-normal, zero biases), identity norms."""
    flax_dense_init_(head, generator)
    return head


def proposal_layer(cfg: VoxelRCNNConfig, preds: dict,
                   anchors: torch.Tensor, train: bool = False):
    """Anchor decode + rotated NMS -> fixed-size proposals: (rois (B, R,
    7), roi_scores (B, R), roi_mask (B, R)), R = cfg.test_post_nms, or
    cfg.train_post_nms with `train` (the training NMS settings)."""
    scores, boxes = anchor_head_decode(preds["cls"], preds["box"],
                                       preds["dir"], anchors,
                                       ResidualCoder())
    score = scores.amax(-1)
    stages.mark("rpn")
    if train:
        nms = (cfg.train_nms_thresh, cfg.train_pre_nms, cfg.train_post_nms)
    else:
        nms = (cfg.test_nms_thresh, cfg.test_pre_nms, cfg.test_post_nms)
    idx, mask = nms_bev(boxes, score, *nms)
    rois = boxes.gather(1, idx[..., None].expand(-1, -1, 7))
    roi_scores = score.gather(1, idx) * mask
    stages.mark("proposal")
    return rois, roi_scores, mask


def voxel_rcnn_post_processing(cfg: VoxelRCNNConfig, rois, roi_mask,
                               rcnn_cls, rcnn_reg) -> dict:
    """Proposals refined by the RCNN regression and scored by
    sigmoid(rcnn_cls) (the class-agnostic IoU-guided score), rotated NMS,
    score threshold. -> boxes (B, F, 7), scores, labels (0: Car) and valid
    (B, F), F = cfg.final_max_boxes."""
    boxes = decode_rcnn_boxes(rois, rcnn_reg)
    scores = torch.sigmoid(rcnn_cls[..., 0]) * roi_mask
    idx, keep = nms_bev(boxes, scores, cfg.final_nms_thresh, boxes.shape[1],
                        cfg.final_max_boxes)
    fb = boxes.gather(1, idx[..., None].expand(-1, -1, 7))
    fs = scores.gather(1, idx) * keep
    return {"boxes": fb, "scores": fs,
            "labels": torch.zeros(fs.shape, dtype=torch.int32,
                                  device=fs.device),
            "valid": keep & (fs > cfg.score_thresh)}


def assign_rpn_targets(cfg: VoxelRCNNConfig, anchors: torch.Tensor,
                       gt_boxes: torch.Tensor, gt_classes: torch.Tensor,
                       gt_valid: torch.Tensor) -> dict:
    """Every anchor's targets, batched: gt_boxes (B, M, 7), gt_classes (B,
    M) class ids, gt_valid (B, M); each class's anchors assigned against its
    own gts (`assign_anchor_targets`, the class's thresholds). -> dict
    labels (B, A) in {-1, 0, 1}, reg_targets (B, A, 7), anchors (A, 7),
    gt_classes_per_anchor (B, A)."""
    cls_ids = anchor_class_ids(cfg, anchors.device)
    coder = ResidualCoder()
    b, a = gt_boxes.shape[0], anchors.shape[0]
    labels = torch.zeros(b, a, dtype=torch.int32, device=anchors.device)
    regs = anchors.new_zeros(b, a, 7)
    gtc = torch.zeros(b, a, dtype=torch.int32, device=anchors.device)
    for i in range(b):
        for ci, ccfg in enumerate(cfg.anchor_classes):
            sel = cls_ids == ci
            lab, reg, _ = assign_anchor_targets(
                anchors, gt_boxes[i], gt_valid[i] & (gt_classes[i] == ci),
                ccfg.matched_threshold, ccfg.unmatched_threshold, coder)
            labels[i] = torch.where(sel, lab, labels[i])
            regs[i] = torch.where(sel[:, None], reg, regs[i])
            gtc[i] = torch.where(sel, torch.full_like(gtc[i], ci), gtc[i])
    return {"labels": labels, "reg_targets": regs, "anchors": anchors,
            "gt_classes_per_anchor": gtc}


def voxel_rcnn_train_losses(cfg: VoxelRCNNConfig, preds: dict,
                            rcnn_out: dict, targets_rpn: dict,
                            rcnn_targets: dict):
    """Both stages' losses: `anchor_head_loss` on the RPN's maps and
    `rcnn_loss` on the head's outputs for the sampled RoIs. -> (total,
    logs of both and "loss")."""
    rpn_total, rpn_logs = anchor_head_loss(
        preds["cls"], preds["box"], preds["dir"], targets_rpn["labels"],
        targets_rpn["reg_targets"], targets_rpn["anchors"],
        targets_rpn["gt_classes_per_anchor"],
        num_classes=len(cfg.anchor_classes))
    rcnn_total, rcnn_logs = rcnn_loss(rcnn_out["cls"], rcnn_out["reg"],
                                      rcnn_targets, cfg.rcnn)
    total = rpn_total + rcnn_total
    return total, {**rpn_logs, **rcnn_logs, "loss": total}


class VoxelRCNNTwoStage(nn.Module):
    """Both stages of Voxel R-CNN as one module, for training: `rpn` (a
    `VoxelRCNN`, or a `VoxelRCNN3DDF` first stage) and `rcnn` (the
    `VoxelRCNNHead`), named as the JAX package's {"rpn", "rcnn"} trees so
    that its variables carry across as they are."""

    def __init__(self, rpn: nn.Module, rcnn: VoxelRCNNHead):
        super().__init__()
        self.rpn, self.rcnn = rpn, rcnn

    @property
    def anchors(self) -> torch.Tensor:
        return getattr(self.rpn, "detector", self.rpn).anchors
