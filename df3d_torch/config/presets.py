"""Named presets (port of df3d/config/presets.py): the seven target
configurations and the smoke config, as the port's config dataclasses.

- `voxel_rcnn_car_kitti`: pcdet's kitti_models/voxel_rcnn_car.yaml;
- `voxel_rcnn_3ddf_kitti`: ...voxel_rcnn_car_mm_mvx+actrv2_hybrid_ifat.yaml;
- `centerpoint_nusc`: det3d's nusc_centerpoint_voxelnet_0075voxel_fix_bn_z;
- `centerpoint_3ddf_nusc`: the same with _multimodal_pfat_hybrid7_ifat;
- `transfusion_l_nusc`: TransFusion's configs/transfusion_nusc_voxel_L.py;
- `transfusion_3ddf_nusc`: TransFusion's configs/transfusion_nusc_voxel_F.py;
- `transfusion_3ddf_swin_nusc`: that with a Swin-T + FPN image branch;
- `centerpoint_tiny_smoke`: a small CenterPoint for smoke runs.

A LiDAR-only preset is its detector's config; a fused one is a dict with
`lidar`, `actr`, `max_ne_voxel`, `image_shape`, and `num_cams` and
`image_branch` where the preset sets them. `fused_config(preset)` is the
`FusedConfig` the JAX package's `build_detector` makes for a fused preset.
"""

from __future__ import annotations

from df3d_torch.models.detectors.centerpoint import CenterPointConfig
from df3d_torch.models.detectors.fused import FusedConfig
from df3d_torch.models.detectors.transfusion import TransFusionConfig
from df3d_torch.models.detectors.voxel_rcnn import VoxelRCNNConfig
from df3d_torch.models.fusion.actr import ACTRConfig


def centerpoint_nusc() -> CenterPointConfig:
    return CenterPointConfig()


def centerpoint_3ddf_nusc() -> dict:
    """The LiDAR model of `centerpoint_nusc` with the six-camera ACTRv2
    hybrid fusion of det3d's multimodal config."""
    return {
        "lidar": CenterPointConfig(),
        "actr": ACTRConfig(
            d_model=128, n_levels=3, num_layers=1, q_method="gating",
            attn_layer="BiGateSum1D_2", model_name="ACTRv2",
        ),
        "max_ne_voxel": 26000,
        "num_cams": 6,
        "image_shape": (448, 800),
    }


def transfusion_l_nusc() -> TransFusionConfig:
    return TransFusionConfig()


def transfusion_3ddf_nusc() -> dict:
    """The LiDAR model of `transfusion_l_nusc` with six 448x800 cameras and
    an ACTRv2 hybrid of two layers on one image level."""
    return {
        "lidar": TransFusionConfig(),
        "actr": ACTRConfig(
            d_model=128, n_levels=1, num_layers=2, q_method="sum",
            attn_layer="BiGateSum1D_2", model_name="ACTRv2", hybrid=True,
        ),
        "max_ne_voxel": 26000,
        "num_cams": 6,
        "image_shape": (448, 800),
    }


def transfusion_3ddf_swin_nusc() -> dict:
    """`transfusion_3ddf_nusc` with a Swin-T + FPN image branch (the
    reference README's Swin-Tiny row)."""
    return dict(transfusion_3ddf_nusc(), image_branch="swin")


def voxel_rcnn_car_kitti() -> VoxelRCNNConfig:
    return VoxelRCNNConfig()


def voxel_rcnn_3ddf_kitti() -> dict:
    """Voxel R-CNN with one 384x1280 camera (KITTI's 375x1242 padded), MVX
    at stride 1 and an ACTRv2 hybrid at d_model 64 over three DeepLabV3
    levels at stride 8."""
    return {
        "lidar": VoxelRCNNConfig(),
        "actr": ACTRConfig(
            d_model=64, n_levels=3, num_layers=1, q_method="gating",
            attn_layer="BiGateSum1D_2", model_name="ACTRv2",
        ),
        "max_ne_voxel": 13000,
        "image_shape": (384, 1280),
    }


def centerpoint_tiny_smoke() -> CenterPointConfig:
    """A small CenterPoint for smoke runs (5 point features, 0.4 m voxels
    over +-25.6 m, the six nuScenes tasks)."""
    return CenterPointConfig(
        pc_range=(-25.6, -25.6, -2.4, 25.6, 25.6, 2.4),
        voxel_size=(0.4, 0.4, 0.2),
        grid_size=(24, 128, 128),
        max_voxels=2048,
        num_point_features=5,
        stage_caps=(2048, 1024, 512, 256),
        max_objs=32,
        post_center_range=(-30.0, -30.0, -4.0, 30.0, 30.0, 4.0),
        nms_pre_max_size=128,
        nms_post_max_size=16,
    )


PRESETS = {
    "voxel_rcnn_car_kitti": voxel_rcnn_car_kitti,
    "centerpoint_tiny_smoke": centerpoint_tiny_smoke,
    "voxel_rcnn_3ddf_kitti": voxel_rcnn_3ddf_kitti,
    "centerpoint_nusc": centerpoint_nusc,
    "centerpoint_3ddf_nusc": centerpoint_3ddf_nusc,
    "transfusion_l_nusc": transfusion_l_nusc,
    "transfusion_3ddf_nusc": transfusion_3ddf_nusc,
    "transfusion_3ddf_swin_nusc": transfusion_3ddf_swin_nusc,
}


def get_preset(name: str):
    if name not in PRESETS:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(PRESETS)}"
        )
    return PRESETS[name]()


def fused_config(preset: dict, **overrides) -> FusedConfig:
    """The `FusedConfig` of a fused preset, as the JAX package's
    `build_detector` makes it: the preset's image branch, else ResNet +
    FPN for a TransFusion preset and DeepLabV3 taps otherwise; the preset's
    `image_layers`, `swin_depths` and `swin_dim` where it sets them; one
    camera unless it says otherwise; ACTR's level count. `overrides` set
    other fields (`image_shape`, `with_aux_seg`, ...)."""
    branch = preset.get("image_branch", (
        "resnet_fpn" if isinstance(preset["lidar"], TransFusionConfig)
        else "deeplabv3"))
    fields = dict(
        image_shape=tuple(preset["image_shape"]), image_branch=branch,
        image_layers=tuple(preset.get("image_layers",
                                      FusedConfig.image_layers)),
        swin_depths=tuple(preset.get("swin_depths", FusedConfig.swin_depths)),
        swin_dim=int(preset.get("swin_dim", FusedConfig.swin_dim)),
        n_levels=preset["actr"].n_levels,
        num_cams=preset.get("num_cams", 1), actr=preset["actr"])
    fields.update(overrides)
    return FusedConfig(**fields)
