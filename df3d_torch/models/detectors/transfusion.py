"""TransFusion-L, the LiDAR-only TransFusion detector (port of
df3d/models/detectors/transfusion.py).

voxel features + coords -> `SparseEncoder` (hybrid dense tail) ->
`BEVBackbone` (SECOND + FPN) -> `TransFusionHead`, `transfusion_predict`
for the decode and `transfusion_loss` for training (the Hungarian
assignment and the losses). The mean VFE is fused into the voxelizer. With
a `fusion_hook` it is the LiDAR part of TransFusion + 3D-DF
(`detectors.fused.TransFusion3DDF`).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from df3d_torch.models.backbones_3d import SparseEncoder, SpMiddleResNetFHD
from df3d_torch.models.detectors.centerpoint import init_detector_weights
from df3d_torch.models.heads.transfusion_head import (
    HEATMAP_PRIOR, TransFusionHead, TransFusionHeadCfg,
    transfusion_get_bboxes, transfusion_targets_and_loss,
)
from df3d_torch.models.layers import flax_trunc_normal_
from df3d_torch.models.necks import BEVBackbone
from df3d_torch.ops.sparse import SparseTensor
from df3d_torch.utils import stages


@dataclasses.dataclass(frozen=True)
class TransFusionConfig:
    pc_range: tuple = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
    voxel_size: tuple = (0.075, 0.075, 0.2)
    grid_size: tuple = (40, 1440, 1440)
    max_voxels: int = 120_000
    max_points_per_voxel: int = 10
    num_point_features: int = 5
    stage_caps: tuple = (120_000, 90_000, 60_000, 30_000)
    dense_tail: bool = True   # the hybrid tail, the only one ported
    head: TransFusionHeadCfg = TransFusionHeadCfg()

    @property
    def sparse_shape(self):
        z, y, x = self.grid_size
        return (z + 1, y, x)


class TransFusionL(nn.Module):
    """Build, call `init_weights` (or load a state dict); `.eval()` serves
    on the running statistics, `.train()` trains on the batch statistics
    and moves the running ones. Its encoder runs the JAX package's default
    hybrid tail (`dense_tail=True`), the only one ported."""

    def __init__(self, cfg: TransFusionConfig,
                 fusion_hook: nn.Module | None = None):
        super().__init__()
        if not cfg.dense_tail:
            raise NotImplementedError(
                "only the hybrid dense tail (dense_tail=True) is ported")
        self.cfg = cfg
        self.middle_encoder = SparseEncoder(cfg.num_point_features,
                                            fusion_hook)
        # the same z strides as CenterPoint's backbone
        bev_channels = 128 * SpMiddleResNetFHD.out_depth(cfg.sparse_shape[0])
        self.pts_backbone = BEVBackbone(
            bev_channels, layer_nums=(5, 5), layer_strides=(1, 2),
            num_filters=(128, 256), upsample_strides=(1, 2),
            num_upsample_filters=(256, 256))
        self.bbox_head = TransFusionHead(cfg.head, 512)

    def forward(self, voxel_features: torch.Tensor,
                voxel_coords: torch.Tensor, fusion_kwargs: dict | None = None):
        """voxel_features (B, V, F); voxel_coords (B, V, 3) (z, y, x), key
        sorted with -1 padding rows (the voxelizer's output); fusion_kwargs
        the fusion hook's inputs.

        Returns (preds, ms, overflow): the head's dict, the per-stage
        encoder tensors, and the strided stages' cap overflows (the values
        the JAX package sows; `cap_overflow_total` sums them as the
        training step logs them)."""
        st = SparseTensor(voxel_features, voxel_coords, self.cfg.sparse_shape)
        v = voxel_features.shape[1]
        caps = tuple(min(c, v) for c in self.cfg.stage_caps)
        bev, ms, overflow = self.middle_encoder(st, caps, fusion_kwargs)
        bev = self.pts_backbone(bev)
        stages.mark("neck")
        preds = self.bbox_head(bev)
        stages.mark("head")
        return preds, ms, overflow

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "TransFusionL":
        """Random weights drawn like the flax initializers: as
        `CenterPoint.init_weights` for the encoder, neck and head convs,
        LeCun truncated-normal for the head's Dense layers, the heatmap
        prior (-2.19) on the heatmap conv and the class branch, identity
        norms."""
        init_detector_weights(self, "bbox_head.", generator)
        for m in self.bbox_head.modules():
            if isinstance(m, nn.Linear):
                flax_trunc_normal_(m.weight, m.in_features, 1.0, generator)
                if m.bias is not None:
                    m.bias.zero_()
        self.bbox_head.hm_conv1.bias.fill_(HEATMAP_PRIOR)
        self.bbox_head.cls_fc1.bias.fill_(HEATMAP_PRIOR)
        return self


def transfusion_predict(cfg: TransFusionConfig, preds):
    return transfusion_get_bboxes(cfg.head, preds)


def transfusion_loss(cfg: TransFusionConfig, preds, gt_boxes, gt_classes,
                     gt_valid):
    """gt_boxes (B, M, 9), gt_classes (B, M), gt_valid (B, M) -> (total
    loss, logs)."""
    return transfusion_targets_and_loss(cfg.head, preds, gt_boxes,
                                        gt_classes, gt_valid)
