"""Build any preset's detector (port of df3d/models/build.py).

`build_detector` is the one place that maps a preset to the port's
`entry.build_*` functions (to serve) and `entry.build_*_trainer` ones (to
train), so that the serving and training callers cannot drift apart, as
the JAX package's docstring asks of its own.

    from df3d_torch.config import apply_preset_overrides, get_preset
    from df3d_torch.models.build import build_detector

    preset = apply_preset_overrides(get_preset("transfusion_3ddf_nusc"),
                                    ["lidar.max_voxels=90000"])
    det = build_detector(preset, profile="tpu_v5e")
    detections, overflow = det.infer(points, valid, images, proj)
"""

from __future__ import annotations

from types import SimpleNamespace

from df3d_torch import entry
from df3d_torch.config.presets import fused_config
from df3d_torch.models.detectors.centerpoint import CenterPointConfig
from df3d_torch.models.detectors.transfusion import TransFusionConfig
from df3d_torch.models.detectors.voxel_rcnn import VoxelRCNNConfig
from df3d_torch.serving import apply_profile

# LiDAR config class -> (family, serving function LiDAR-only and fused,
# `build_*_trainer` function LiDAR-only and fused)
_FAMILIES = {
    CenterPointConfig: ("centerpoint", entry.infer, entry.infer_fused,
                        entry.build_centerpoint_trainer,
                        entry.build_centerpoint3ddf_trainer),
    TransFusionConfig: ("transfusion", entry.infer_transfusion,
                        entry.infer_transfusion_fused,
                        entry.build_transfusion_trainer,
                        entry.build_transfusion3ddf_trainer),
    VoxelRCNNConfig: ("voxelrcnn", entry.infer_voxelrcnn,
                      entry.infer_voxelrcnn_fused,
                      entry.build_voxelrcnn_trainer,
                      entry.build_voxelrcnn3ddf_trainer),
}


def preset_image_shape(preset, override=None) -> tuple:
    """Fused presets carry their operating-point image shape (KITTI
    384x1280, nuScenes 448x800); an explicit override wins."""
    if override:
        return tuple(override)
    if isinstance(preset, dict) and "image_shape" in preset:
        return tuple(preset["image_shape"])
    return (448, 800)


def _serving_model(family: str, cfg, fcfg, device, seed, checkpoint):
    """(model, head) of a serving preset: `entry`'s build function of the
    family, with a checkpoint where the family has an importer."""
    fused = fcfg is not None
    if checkpoint is not None and fused and not (
            family == "transfusion" and fcfg.image_branch == "swin"):
        raise ValueError(f"no checkpoint importer for a fused {family} "
                         "preset (only the Swin TransFusion + 3D-DF one)")
    if family == "centerpoint":
        if fused:
            return entry.build_centerpoint3ddf(cfg, fcfg, device, seed), None
        return entry.build_centerpoint(cfg, device, seed,
                                       checkpoint=checkpoint), None
    if family == "transfusion":
        if fused:
            return entry.build_transfusion3ddf(cfg, fcfg, device, seed,
                                               checkpoint), None
        return entry.build_transfusion(cfg, device, seed, checkpoint), None
    if fused:
        return entry.build_voxelrcnn3ddf(cfg, fcfg, device, seed)
    return entry.build_voxelrcnn(cfg, device, seed, checkpoint)


def build_detector(preset, tx=None, *, image_shape=None,
                   with_aux_seg: bool = False, seed: int = 0, device=None,
                   profile: str = "exact", checkpoint: str | None = None):
    """Build any preset's detector on `device` (the card unless
    `device="cpu"`), with random weights drawn from `seed` or a reference
    checkpoint's (`checkpoint`, serving only; the importers of
    `entry.build_*`).

    Returns a namespace with the JAX package's fields: `model` (the first
    stage for Voxel R-CNN), `head` (Voxel R-CNN's RCNN head, else None),
    `lidar_cfg`, `fcfg` (None unless fused), `family` ("centerpoint" |
    "transfusion" | "voxelrcnn"), `fused`, `num_cams` and `image_shape`
    (None unless fused); `serve`, the family's serving function
    (`entry.infer`, `infer_fused`, `infer_transfusion`,
    `infer_transfusion_fused` or `infer_voxelrcnn`, which take the model,
    for Voxel R-CNN the model and the head, then the config and the
    inputs); and `infer(points, valid, images=None, proj=None) ->
    (detections, cap overflows)`, `serve` on this model, in eval mode and
    in the serving `profile` ("exact" or "tpu_v5e",
    `serving.apply_profile`).

    With an optimizer `tx` (`train.schedules.adam_onecycle(...)`) the
    model is built by the family's trainer and is in training mode; the
    namespace adds `state` (the `TrainState`) and `step`, the training
    step, in place of `infer`. Training runs in "exact": the bf16 conv
    body has no gradient, so another profile with `tx` raises."""
    fused = isinstance(preset, dict)
    lidar_cfg = preset["lidar"] if fused else preset
    try:
        family, infer_lidar, infer_fused, trainer, fused_trainer = (
            _FAMILIES[type(lidar_cfg)])
    except KeyError:
        raise ValueError(
            f"unsupported preset type {type(lidar_cfg).__name__}") from None
    if tx is not None and profile != "exact":
        raise ValueError(f"profile {profile!r} serves only; training runs "
                         "in 'exact' (the bf16 conv body has no gradient)")
    fcfg, num_cams = None, 1
    if fused:
        num_cams = preset.get("num_cams", 1)
        image_shape = preset_image_shape(preset, image_shape)
        fcfg = fused_config(preset, image_shape=image_shape,
                            with_aux_seg=with_aux_seg)
    else:
        image_shape = None

    serve = infer_fused if fused else infer_lidar
    out = SimpleNamespace(lidar_cfg=lidar_cfg, fcfg=fcfg, family=family,
                          fused=fused, num_cams=num_cams,
                          image_shape=image_shape, serve=serve)
    if tx is not None:
        if checkpoint is not None:
            raise ValueError("build_detector: a trainer starts from random "
                             "weights; load a checkpoint into a serving "
                             "model")
        if fused:
            state, step = fused_trainer(lidar_cfg, fcfg, device, seed, tx=tx)
        else:
            state, step = trainer(lidar_cfg, device, seed, tx=tx)
        model, head = state.model, None
        if family == "voxelrcnn":
            model, head = model.rpn, model.rcnn
        out.__dict__.update(model=model, head=head, state=state, step=step)
        return out

    model, head = _serving_model(family, lidar_cfg, fcfg,
                                 entry.resolve_device(device), seed,
                                 checkpoint)
    apply_profile(model, profile)
    if head is None:
        def infer(points, valid, images=None, proj=None):
            cams = () if images is None else (images, proj)
            return serve(model, lidar_cfg, points, valid, *cams)
    else:
        def infer(points, valid, images=None, proj=None):
            return serve(model, head, lidar_cfg, points, valid, images, proj)
    out.__dict__.update(model=model, head=head, infer=infer)
    return out


__all__ = ["build_detector", "preset_image_shape"]
