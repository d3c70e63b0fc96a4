"""CenterPoint + 3D Dual-Fusion, the camera+LiDAR detector (port of
`FusedConfig`, `ImageBranch` and `CenterPoint3DDF` in
df3d/models/detectors/fused.py).

Six (or `num_cams`) camera images go through the DeepLabV3 image branch;
the multi-camera ACTR hook (IFAT + LT + dual-query deformable attention)
fuses them into the stage-4 voxels of the CenterPoint backbone. Inference
only. Not ported here: the 'resnet_fpn', 'swin', 'dla' and 'regnet' image
branches, the auxiliary segmentation head, `VoxelRCNN3DDF` and
`TransFusion3DDF`.
"""

from __future__ import annotations

import dataclasses
import math

import torch
from torch import nn

from df3d_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointConfig,
)
from df3d_torch.models.fusion.actr import ACTR, ACTRConfig
from df3d_torch.models.fusion.hooks import (
    ACTRFusionSpec, MultiCamACTRFusionHook,
)
from df3d_torch.models.fusion.msda_module import (
    MSDeformAttnModule, offset_bias_grid,
)
from df3d_torch.models.image.resnet import SemDeepLabV3
from df3d_torch.utils import stages

# SemDeepLabV3's tap widths (reduce_channels) per level
_TAP_CHANNELS = (32, 64, 128)


@dataclasses.dataclass(frozen=True)
class FusedConfig:
    image_shape: tuple = (375, 1242)     # KITTI default
    image_branch: str = "deeplabv3"      # the only branch ported
    image_layers: tuple = (3, 4, 6, 3)   # ResNet-50
    n_levels: int = 3
    num_cams: int = 1
    actr: ACTRConfig = ACTRConfig()
    use_ifat: bool = True
    fusion_downsample: int = 8


class ImageBranch(nn.Module):
    """Camera feature extractor: a list of n_levels channel-last maps."""

    def __init__(self, cfg: FusedConfig):
        super().__init__()
        if cfg.image_branch != "deeplabv3":
            raise NotImplementedError(
                f"image_branch {cfg.image_branch!r}: only 'deeplabv3' is "
                "ported")
        self.n_levels = cfg.n_levels
        self.sem = SemDeepLabV3(backbone_layers=cfg.image_layers)

    @property
    def channels(self) -> tuple:
        return _TAP_CHANNELS[:self.n_levels]

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        feats = self.sem(images)
        return [feats["layer1"], feats["layer2"],
                feats["layer3"]][:self.n_levels]


class CenterPoint3DDF(nn.Module):
    """CenterPoint + PFAT (= ACTR) multi-camera fusion + IFAT (nuScenes).
    Build, call `init_weights` (or load a state dict), then `.eval()`."""

    def __init__(self, cfg: CenterPointConfig, fused: FusedConfig):
        super().__init__()
        self.cfg, self.fused = cfg, fused
        self.image_branch = ImageBranch(fused)
        spec = ACTRFusionSpec(actr=fused.actr,
                              downsample=fused.fusion_downsample,
                              use_ifat=fused.use_ifat)
        hook = MultiCamACTRFusionHook(
            spec, cfg.voxel_size, cfg.pc_range, fused.image_shape,
            fused.num_cams, voxel_channels=128,
            image_channels=self.image_branch.channels)
        self.detector = CenterPoint(cfg, fusion_hook=hook)

    def forward(self, voxel_features: torch.Tensor,
                voxel_coords: torch.Tensor, images: torch.Tensor,
                proj: torch.Tensor):
        """images (B, n_cam, H, W, 3) normalized; proj (B, n_cam, 3, 4)
        lidar -> image. Returns (preds, ms, overflow) like `CenterPoint`."""
        b, nc = images.shape[:2]
        feats = self.image_branch(images.reshape(b * nc, *images.shape[2:]))
        feats = [f.reshape(b, nc, *f.shape[1:]) for f in feats]
        stages.mark("image_branch")
        return self.detector(voxel_features, voxel_coords,
                             fusion_kwargs=dict(image_feats=feats, proj=proj))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CenterPoint3DDF":
        """Random weights drawn like the flax initializers: the detector as
        `CenterPoint.init_weights` draws it (He for its convs, including
        IFAT's), LeCun truncated-normal for every Dense and the image
        branch's convs, N(0, 1) level embeddings, identity norms, zero
        biases, and the deformable-DETR direction grid as the
        sampling-offset bias. flax zero-initialises the offset and
        attention-weight kernels; here they are LeCun-normal too, so that
        random weights sample at places that differ from query to query."""
        self.detector.init_weights(generator)

        def lecun(w, fan_in):
            std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
            draw = torch.empty(w.shape, dtype=w.dtype)
            nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std,
                                  generator=generator)
            w.copy_(draw)

        for m in self.image_branch.modules():
            if isinstance(m, nn.Conv2d):
                cout, cin, kh, kw = m.weight.shape
                lecun(m.weight, cin * kh * kw)
                if m.bias is not None:
                    m.bias.zero_()
        for m in self.modules():
            if isinstance(m, nn.Linear):
                lecun(m.weight, m.in_features)
                m.bias.zero_()
            elif isinstance(m, ACTR):
                m.level_embed.copy_(torch.randn(m.level_embed.shape,
                                                generator=generator))
        for m in self.modules():
            if isinstance(m, MSDeformAttnModule):
                m.sampling_offsets.bias.copy_(offset_bias_grid(
                    m.n_heads, m.n_levels, m.n_points))
        return self

