"""3D Dual-Fusion, the camera+LiDAR detectors (port of `FusedConfig`,
`ImageBranch`, `CenterPoint3DDF` and `TransFusion3DDF` in
df3d/models/detectors/fused.py).

Six (or `num_cams`) camera images go through the image branch (DeepLabV3
taps for CenterPoint + 3D-DF, ResNet-50 + FPN for TransFusion + 3D-DF);
the multi-camera ACTR hook (IFAT + LT + dual-query deformable attention)
fuses them into the stride-8 voxels of the LiDAR detector's backbone.
Inference only. Not ported here: the 'swin', 'dla' and 'regnet' image
branches, the auxiliary segmentation head and `VoxelRCNN3DDF`.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from df3d_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointConfig,
)
from df3d_torch.models.detectors.transfusion import (
    TransFusionConfig, TransFusionL,
)
from df3d_torch.models.fusion.actr import ACTR, ACTRConfig
from df3d_torch.models.fusion.hooks import (
    ACTRFusionSpec, MultiCamACTRFusionHook,
)
from df3d_torch.models.fusion.msda_module import (
    MSDeformAttnModule, offset_bias_grid,
)
from df3d_torch.models.image.resnet import (
    FPN_CHANNELS, ResNetFPN, SemDeepLabV3,
)
from df3d_torch.models.layers import flax_trunc_normal_
from df3d_torch.utils import stages

# SemDeepLabV3's tap widths (reduce_channels) per level
_TAP_CHANNELS = (32, 64, 128)


@dataclasses.dataclass(frozen=True)
class FusedConfig:
    image_shape: tuple = (375, 1242)     # KITTI default
    image_branch: str = "deeplabv3"      # 'deeplabv3' | 'resnet_fpn'
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
        self.kind, self.n_levels = cfg.image_branch, cfg.n_levels
        if self.kind == "deeplabv3":
            self.sem = SemDeepLabV3(backbone_layers=cfg.image_layers)
            self.channels = _TAP_CHANNELS[:self.n_levels]
        elif self.kind == "resnet_fpn":
            self.img = ResNetFPN(layers=cfg.image_layers)
            self.channels = (FPN_CHANNELS,) * self.n_levels
        else:
            raise NotImplementedError(
                f"image_branch {self.kind!r}: only 'deeplabv3' and "
                "'resnet_fpn' are ported")

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        if self.kind == "resnet_fpn":
            return self.img(images, self.n_levels)
        feats = self.sem(images)
        return [feats["layer1"], feats["layer2"],
                feats["layer3"]][:self.n_levels]


class _CameraLidar3DDF(nn.Module):
    """A LiDAR detector with the multi-camera ACTR hook in its backbone and
    the image branch in front. Build, call `init_weights` (or load a state
    dict), then `.eval()`."""

    def __init__(self, detector_cls, cfg, fused: FusedConfig):
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
        self.detector = detector_cls(cfg, fusion_hook=hook)

    def forward(self, voxel_features: torch.Tensor,
                voxel_coords: torch.Tensor, images: torch.Tensor,
                proj: torch.Tensor):
        """images (B, n_cam, H, W, 3) normalized; proj (B, n_cam, 3, 4)
        lidar -> image. Returns (preds, ms, overflow) like the detector."""
        b, nc = images.shape[:2]
        feats = self.image_branch(images.reshape(b * nc, *images.shape[2:]))
        feats = [f.reshape(b, nc, *f.shape[1:]) for f in feats]
        stages.mark("image_branch")
        return self.detector(voxel_features, voxel_coords,
                             fusion_kwargs=dict(image_feats=feats, proj=proj))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator):
        """Random weights drawn like the flax initializers: the detector as
        its own `init_weights` draws it (He for its convs, including
        IFAT's), LeCun truncated-normal for the hook's Dense layers and the
        image branch's convs, N(0, 1) level embeddings, identity norms,
        zero biases, and the deformable-DETR direction grid as the
        sampling-offset bias. flax zero-initialises the offset and
        attention-weight kernels; here they are LeCun-normal too, so that
        random weights sample at places that differ from query to query."""
        self.detector.init_weights(generator)

        for m in self.image_branch.modules():
            if isinstance(m, nn.Conv2d):
                cout, cin, kh, kw = m.weight.shape
                flax_trunc_normal_(m.weight, cin * kh * kw, 1.0, generator)
                if m.bias is not None:
                    m.bias.zero_()
        hook = next(m for m in self.detector.modules()
                    if isinstance(m, MultiCamACTRFusionHook))
        for m in hook.modules():
            if isinstance(m, nn.Linear):
                flax_trunc_normal_(m.weight, m.in_features, 1.0, generator)
                m.bias.zero_()
            elif isinstance(m, ACTR):
                m.level_embed.copy_(torch.randn(m.level_embed.shape,
                                                generator=generator))
        for m in hook.modules():
            if isinstance(m, MSDeformAttnModule):
                m.sampling_offsets.bias.copy_(offset_bias_grid(
                    m.n_heads, m.n_levels, m.n_points))
        return self


class CenterPoint3DDF(_CameraLidar3DDF):
    """CenterPoint + PFAT (= ACTR) multi-camera fusion + IFAT (nuScenes)."""

    def __init__(self, cfg: CenterPointConfig, fused: FusedConfig):
        super().__init__(CenterPoint, cfg, fused)


class TransFusion3DDF(_CameraLidar3DDF):
    """TransFusion-L + ACTR fusion at the SparseEncoder's stride 8
    (nuScenes)."""

    def __init__(self, cfg: TransFusionConfig, fused: FusedConfig):
        super().__init__(TransFusionL, cfg, fused)
