"""CenterPoint detector (port of df3d/models/detectors/centerpoint.py).

voxel features + coords -> `SpMiddleResNetFHD` -> `BEVBackbone` ->
`CenterHead`, and `centerpoint_predict` for decode + NMS. The mean VFE is
fused into the voxelizer (`df3d_torch.ops.voxelize`). Inference only: the
training path (targets, losses) is ported in a later slice.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from df3d_torch.models.backbones_3d import SpMiddleResNetFHD
from df3d_torch.models.heads.center_head import CenterHead, center_head_predict
from df3d_torch.models.layers import SparseConv3d, SubMConv3d
from df3d_torch.models.necks import BEVBackbone
from df3d_torch.ops.sparse import SparseTensor
from df3d_torch.utils import stages


@dataclasses.dataclass(frozen=True)
class CenterPointConfig:
    # geometry
    pc_range: tuple = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)
    voxel_size: tuple = (0.075, 0.075, 0.2)
    grid_size: tuple = (40, 1440, 1440)  # (Z, Y, X)
    max_voxels: int = 120_000  # per sample (train; det3d cfg 120k/160k)
    max_points_per_voxel: int = 10
    num_point_features: int = 5
    # backbone caps after each downsample stage (per sample)
    stage_caps: tuple = (120_000, 90_000, 60_000, 30_000)
    # stage-4 dense tail (SpMiddleResNetFHD): only the default hybrid path
    # (dense_tail=True, dense_from=4) is ported
    dense_tail: bool = True
    dense_from: int = 4
    # head
    tasks: tuple = (1, 2, 2, 1, 2, 2)  # nuScenes 6-task split
    dcn_head: bool = False
    out_size_factor: int = 8
    code_weights: tuple = (1.0, 1.0, 1.0, 1.0, 1.0, 1.0, 0.2, 0.2, 1.0, 1.0)
    loc_weight: float = 0.25
    max_objs: int = 500
    gaussian_overlap: float = 0.1
    min_radius: int = 2
    # test cfg (det3d nusc_centerpoint test_cfg)
    post_center_range: tuple = (-61.2, -61.2, -10.0, 61.2, 61.2, 10.0)
    score_threshold: float = 0.1
    nms_pre_max_size: int = 1024
    nms_post_max_size: int = 83
    nms_iou_threshold: float = 0.2

    @property
    def sparse_shape(self):
        # det3d adds a +1 z slot (scn.py sparse_shape = grid[::-1] + [1,0,0])
        z, y, x = self.grid_size
        return (z + 1, y, x)

    @property
    def bev_size(self):
        return (self.grid_size[1] // self.out_size_factor,
                self.grid_size[2] // self.out_size_factor)


class CenterPoint(nn.Module):
    """Build on the target device, call `init_weights` (or load a state
    dict), then `.eval()`: only the inference path is ported."""

    def __init__(self, cfg: CenterPointConfig,
                 fusion_hook: nn.Module | None = None):
        super().__init__()
        if not (cfg.dense_tail and cfg.dense_from == 4) or cfg.dcn_head:
            raise NotImplementedError(
                "only the hybrid dense tail (dense_from=4) without the DCN "
                "head is ported")
        self.cfg = cfg
        self.backbone = SpMiddleResNetFHD(cfg.num_point_features,
                                          fusion_hook)
        bev_channels = 128 * SpMiddleResNetFHD.out_depth(cfg.sparse_shape[0])
        self.neck = BEVBackbone(
            bev_channels, layer_nums=(5, 5), layer_strides=(1, 2),
            num_filters=(128, 256), upsample_strides=(1, 2),
            num_upsample_filters=(256, 256))
        self.head = CenterHead(512, cfg.tasks)

    def forward(self, voxel_features: torch.Tensor,
                voxel_coords: torch.Tensor, fusion_kwargs: dict | None = None):
        """voxel_features (B, V, F); voxel_coords (B, V, 3) (z, y, x), key
        sorted with -1 padding rows (the voxelizer's output); fusion_kwargs
        the fusion hook's inputs.

        Returns (preds, ms, overflow): per-task dicts of (B, H, W, c) maps,
        the per-stage backbone tensors, and the strided stages' cap
        overflows (the values the JAX package sows)."""
        st = SparseTensor(voxel_features, voxel_coords, self.cfg.sparse_shape)
        v = voxel_features.shape[1]
        caps = tuple(min(c, v) for c in self.cfg.stage_caps)
        bev, ms, overflow = self.backbone(st, caps, fusion_kwargs)
        bev = self.neck(bev)
        stages.mark("neck")
        preds = self.head(bev)
        stages.mark("head")
        return preds, ms, overflow

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CenterPoint":
        """Random weights drawn like the flax initializers of the JAX
        package: He-normal taps over K*Cin for the sparse convs, He
        truncated-normal for the neck, LeCun truncated-normal for the head,
        zero biases but the heatmap prior (-2.19), identity BatchNorms."""
        def trunc_normal(w, fan_in, scale):
            # flax variance_scaling(truncated_normal): the std of a unit
            # normal truncated to [-2, 2] is 0.87962566
            std = math.sqrt(scale / fan_in) / 0.87962566103423978
            draw = torch.empty(w.shape, dtype=w.dtype)
            nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            w.copy_(draw)

        for name, m in self.named_modules():
            if isinstance(m, (SubMConv3d, SparseConv3d)):
                k, cin, _ = m.weight.shape
                draw = torch.randn(m.weight.shape, generator=generator)
                m.weight.copy_(draw * math.sqrt(2.0 / (k * cin)))
            elif isinstance(m, nn.ConvTranspose2d):
                cin, _, kh, kw = m.weight.shape
                trunc_normal(m.weight, kh * kw * cin, 2.0)
            elif isinstance(m, nn.Conv2d):
                cout, cin, kh, kw = m.weight.shape
                head = name.startswith("head.")
                trunc_normal(m.weight, kh * kw * cin, 1.0 if head else 2.0)
                if m.bias is not None:
                    m.bias.zero_()
        for task in self.head.tasks:
            task["hm"].out.bias.fill_(-2.19)
        return self


def centerpoint_predict(cfg: CenterPointConfig, preds):
    return center_head_predict(
        preds, cfg.voxel_size[:2], cfg.pc_range[:2], cfg.out_size_factor,
        cfg.post_center_range, cfg.score_threshold, cfg.nms_iou_threshold,
        cfg.nms_pre_max_size, cfg.nms_post_max_size,
    )
