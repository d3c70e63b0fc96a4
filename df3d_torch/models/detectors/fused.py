"""3D Dual-Fusion, the camera+LiDAR detectors (port of `FusedConfig`,
`ImageBranch`, `VoxelRCNN3DDF`, `CenterPoint3DDF` and `TransFusion3DDF` in
df3d/models/detectors/fused.py).

Six (or `num_cams`) camera images go through the image branch (DeepLabV3
taps for CenterPoint + 3D-DF and Voxel R-CNN + 3D-DF, ResNet-50 + FPN for
TransFusion + 3D-DF); the ACTR hook (IFAT + LT + dual-query deformable
attention) fuses them into the stride-8 voxels of the LiDAR detector's
backbone. Voxel R-CNN + 3D-DF (KITTI) has one camera and also sums the
nearest image features into its stride-1 voxels (MVX).
`.eval()` serves; `.train()` trains the LiDAR detector and the fusion hook
(CenterPoint + 3D-DF's training step is `train.trainer.FusedTrainStep`).
The image branch is frozen, as the JAX package's default
`freeze_image_branch` freezes it: it stays in eval mode after `.train()`,
runs under `torch.no_grad()` on its running statistics and has
`requires_grad=False` parameters (the JAX package's `stop_gradient` on its
features). The 'swin' branch (`transfusion_3ddf_swin_nusc`) is Swin-T and
an FPN over its four stages.

With `with_aux_seg` the detectors carry the auxiliary segmentation head
(`fusion.aux_heads.AuxSegHead`) on the image branch's first scale, folded
over the cameras; it sits on the frozen branch's features, so only the
head trains. It runs only when a training step passes an `aux` dict to
the forward, which then holds the head's logits (`seg_logits`) and the
fusion point's consistency pairs (`consistency`); a serving forward does
not compute it. Not ported here: an image branch that trains (no
configuration of either package asks for one) and the 'dla' and 'regnet'
image branches.
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn

from df3d_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointConfig,
)
from df3d_torch.models.backbones_3d import VoxelBackBone8x
from df3d_torch.models.detectors.transfusion import (
    TransFusionConfig, TransFusionL,
)
from df3d_torch.models.detectors.voxel_rcnn import VoxelRCNN, VoxelRCNNConfig
from df3d_torch.models.fusion.actr import ACTR, ACTRConfig
from df3d_torch.models.fusion.aux_heads import AuxSegHead
from df3d_torch.models.fusion.hooks import (
    ACTRFusionSpec, MultiCamACTRFusionHook,
)
from df3d_torch.models.fusion.msda_module import (
    MSDeformAttnModule, offset_bias_grid,
)
from df3d_torch.models.image.resnet import (
    FPN, FPN_CHANNELS, ResNetFPN, SemDeepLabV3,
)
from df3d_torch.models.image.swin import SwinTransformer, WindowAttention
from df3d_torch.models.layers import flax_trunc_normal_
from df3d_torch.utils import stages

# SemDeepLabV3's tap widths (reduce_channels) per level
_TAP_CHANNELS = (32, 64, 128)


@dataclasses.dataclass(frozen=True)
class FusedConfig:
    image_shape: tuple = (375, 1242)     # KITTI default
    # 'deeplabv3' | 'resnet_fpn' | 'swin' (Swin-T + FPN)
    image_branch: str = "deeplabv3"
    image_layers: tuple = (3, 4, 6, 3)   # ResNet-50
    swin_depths: tuple = (2, 2, 6, 2)    # Swin-T's blocks per stage
    swin_dim: int = 96                   # and its embedding width
    n_levels: int = 3
    num_cams: int = 1
    actr: ACTRConfig = ACTRConfig()
    use_ifat: bool = True
    fusion_downsample: int = 8
    # the auxiliary FG segmentation head over the first image scale
    with_aux_seg: bool = False


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
        elif self.kind == "swin":
            self.swin = SwinTransformer(cfg.image_shape,
                                        embed_dim=cfg.swin_dim,
                                        depths=cfg.swin_depths)
            self.swin_fpn = FPN(self.swin.stage_channels)
            self.channels = (FPN_CHANNELS,) * self.n_levels
        else:
            raise NotImplementedError(
                f"image_branch {self.kind!r}: only 'deeplabv3', "
                "'resnet_fpn' and 'swin' are ported")

    def forward(self, images: torch.Tensor) -> list[torch.Tensor]:
        if self.kind == "resnet_fpn":
            return self.img(images, self.n_levels)
        if self.kind == "swin":
            outs = self.swin_fpn([s.permute(0, 3, 1, 2)
                                  for s in self.swin(images)], self.n_levels)
            return [o.permute(0, 2, 3, 1) for o in outs]
        feats = self.sem(images)
        return [feats["layer1"], feats["layer2"],
                feats["layer3"]][:self.n_levels]


class _CameraLidar3DDF(nn.Module):
    """A LiDAR detector with the multi-camera ACTR hook in its backbone and
    the image branch in front. Build, call `init_weights` (or load a state
    dict), then `.eval()` or `.train()`."""

    def __init__(self, detector_cls, cfg, fused: FusedConfig,
                 voxel_channels: int = 128, mvx_channels: int | None = None):
        super().__init__()
        self.cfg, self.fused = cfg, fused
        self.image_branch = ImageBranch(fused).requires_grad_(False).eval()
        spec = ACTRFusionSpec(actr=fused.actr,
                              downsample=fused.fusion_downsample,
                              use_ifat=fused.use_ifat)
        hook = MultiCamACTRFusionHook(
            spec, cfg.voxel_size, cfg.pc_range, fused.image_shape,
            fused.num_cams, voxel_channels=voxel_channels,
            image_channels=self.image_branch.channels,
            mvx_channels=mvx_channels)
        self.detector = detector_cls(cfg, fusion_hook=hook)
        if fused.with_aux_seg:
            self.aux_seg = AuxSegHead(self.image_branch.channels[0])

    def forward(self, voxel_features: torch.Tensor,
                voxel_coords: torch.Tensor, images: torch.Tensor,
                proj: torch.Tensor, aux: dict | None = None,
                noise_rot=None, noise_scale=None, flip_x=None, flip_y=None):
        """images (B, n_cam, H, W, 3) normalized; proj (B, n_cam, 3, 4)
        lidar -> image. Returns what the detector returns. With an `aux`
        dict (a training step's aux objectives), the forward also puts the
        head's logits over the cameras folded into the batch, (B * n_cam,
        Hf, Wf, 1), under "seg_logits", and the fusion hook's consistency
        pairs, a list, under "consistency". noise_rot, noise_scale, flip_x
        and flip_y (B,): each sample's world augmentation, which the hook
        undoes before it projects (none by default; the training steps
        pass none, as the JAX package's do)."""
        b, nc = images.shape[:2]
        flat = images.reshape(b * nc, *images.shape[2:])
        with torch.no_grad():
            feats = self.image_branch(flat)
        stages.mark("image_branch")
        fusion_kwargs = {}
        if aux is not None:
            if not hasattr(self, "aux_seg"):
                raise ValueError("aux objectives need a model built with "
                                 "FusedConfig.with_aux_seg=True")
            aux["seg_logits"] = self.aux_seg(feats[0])
            aux["consistency"] = fusion_kwargs["aux_pairs"] = []
            stages.mark("aux")
        feats = [f.reshape(b, nc, *f.shape[1:]) for f in feats]
        return self.detector(voxel_features, voxel_coords,
                             fusion_kwargs=dict(
                                 image_feats=feats, proj=proj,
                                 noise_rot=noise_rot, noise_scale=noise_scale,
                                 flip_x=flip_x, flip_y=flip_y,
                                 **fusion_kwargs))

    def train(self, mode: bool = True):
        """As `nn.Module.train`, but the frozen image branch stays in eval
        mode."""
        super().train(mode)
        self.image_branch.eval()
        return self

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
            elif isinstance(m, nn.Linear):  # Swin's
                flax_trunc_normal_(m.weight, m.in_features, 1.0, generator)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, WindowAttention):
                m.rel_bias.copy_(0.02 * torch.randn(m.rel_bias.shape,
                                                    generator=generator))
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
        if hasattr(self, "aux_seg"):
            self.aux_seg.init_weights(generator)
        return self


class VoxelRCNN3DDF(_CameraLidar3DDF):
    """Voxel R-CNN + MVX at stride 1 + ACTRv2 hybrid at stride 8 + IFAT
    (KITTI, one camera): the first stage; its proposals go to the plain
    `VoxelRCNNHead`. MVX is always on, as the JAX package's default
    `mvx_early` has it (no configuration turns it off)."""

    def __init__(self, cfg: VoxelRCNNConfig, fused: FusedConfig):
        if fused.num_cams != 1:
            raise ValueError("Voxel R-CNN + 3D-DF has one camera")
        channels = VoxelBackBone8x.CHANNELS
        super().__init__(VoxelRCNN, cfg, fused, voxel_channels=channels[3],
                         mvx_channels=channels[0])

    def forward(self, voxel_features: torch.Tensor,
                voxel_coords: torch.Tensor, images: torch.Tensor,
                proj: torch.Tensor, aux: dict | None = None,
                noise_rot=None, noise_scale=None, flip_x=None, flip_y=None):
        """images (B, H, W, 3) normalized; proj (B, 3, 4) lidar -> image.
        -> (preds, overflow) as `VoxelRCNN`; `aux` and the augmentation
        inputs as for the multi-camera detectors."""
        return super().forward(voxel_features, voxel_coords,
                               images[:, None], proj[:, None], aux,
                               noise_rot, noise_scale, flip_x, flip_y)


class CenterPoint3DDF(_CameraLidar3DDF):
    """CenterPoint + PFAT (= ACTR) multi-camera fusion + IFAT (nuScenes)."""

    def __init__(self, cfg: CenterPointConfig, fused: FusedConfig):
        super().__init__(CenterPoint, cfg, fused)


class TransFusion3DDF(_CameraLidar3DDF):
    """TransFusion-L + ACTR fusion at the SparseEncoder's stride 8
    (nuScenes)."""

    def __init__(self, cfg: TransFusionConfig, fused: FusedConfig):
        super().__init__(TransFusionL, cfg, fused)
