"""Entry points of the port: build a detector, run a serving path.

* `build_centerpoint(cfg, device, seed, profile, checkpoint)`: the model
  on `device`, with random flax-like weights drawn from a seeded
  `torch.Generator` or a det3d checkpoint's (`train.import_centerpoint`),
  in eval mode, serving in the named profile (`serving.py`: "exact", the
  default, or "tpu_v5e"). `build_transfusion` and `build_voxelrcnn` take
  an mmdet3d or pcdet `checkpoint` the same way.
* `infer(model, cfg, points, valid)`: voxelize -> model -> decode + NMS.
* `entry(device)`: the counterpart of the JAX package's
  `__graft_entry__.entry()`: `(fn, args)` for a small CenterPoint forward.
* `build_centerpoint3ddf(cfg, fcfg, device, seed)` and `infer_fused(model,
  cfg, points, valid, images, proj)`: the same for the camera+LiDAR
  CenterPoint + 3D-DF detector.
* `infer_double_flip(model, cfg, points, valid[, images, proj])`: det3d's
  double-flip TTA of `infer` or `infer_fused` (batch x4, head maps
  un-flipped and averaged); `train.trainer.make_centerpoint_eval_step`
  picks among the three.
* `build_transfusion(cfg, device, seed)` and `infer_transfusion(model,
  cfg, points, valid)`: TransFusion-L (voxelize -> model -> decode of every
  query, no NMS); `build_transfusion3ddf(cfg, fcfg, device, seed)` and
  `infer_transfusion_fused(model, cfg, points, valid, images, proj)`:
  TransFusion + 3D-DF.
* `build_centerpoint_trainer(cfg, device, seed)`: the CenterPoint model
  with random weights in training mode, its `TrainState` (AdamW with
  OneCycle, the JAX package's `adam_onecycle`) and the training step
  (`train.trainer.CenterPointTrainStep`): `step(state, batch) -> (state,
  logs)`.
* `build_centerpoint3ddf_trainer(cfg, fcfg, device, seed)`: the same for
  CenterPoint + 3D-DF (`train.trainer.FusedTrainStep`; the batch carries
  images and proj too), with the image branch frozen.
* `build_transfusion_trainer(cfg, device, seed)` and
  `build_transfusion3ddf_trainer(cfg, fcfg, device, seed)`: the same for
  TransFusion-L (`train.trainer.TransFusionTrainStep`) and TransFusion +
  3D-DF (`FusedTrainStep` with the TransFusion loss).
* `build_voxelrcnn(cfg, device, seed)` -> (rpn, head) and
  `infer_voxelrcnn(rpn, head, cfg, points, valid)`: Voxel R-CNN (voxelize
  -> RPN -> proposals -> RCNN head -> post-processing, the JAX package's
  `make_voxelrcnn_eval_step`); `build_voxelrcnn3ddf(cfg, fcfg, device,
  seed)` and `infer_voxelrcnn_fused(rpn, head, cfg, points, valid,
  images, proj)` (the same function): Voxel R-CNN + 3D-DF with its one
  camera.
* `build_voxelrcnn_trainer(cfg, device, seed)` and
  `build_voxelrcnn3ddf_trainer(cfg, fcfg, device, seed)`: both stages of
  Voxel R-CNN (or Voxel R-CNN + 3D-DF, image branch frozen) in one
  `VoxelRCNNTwoStage` with random weights in training mode, its
  `TrainState` and the step (`train.trainer.VoxelRCNNTrainStep`):
  `step(state, batch, generator) -> (state, logs)`, the generator drawing
  the RoI sampler's noise on the step's device.
* `build_pvrcnn(cfg, device, seed)` -> (model, head) and
  `infer_pvrcnn(model, head, cfg, points, valid)`: PV-RCNN as the JAX
  package's `detectors/pv_rcnn.py` composes it (voxelize -> PVRCNN ->
  Voxel R-CNN's proposals -> PVRCNNRoIHead -> post-processing); no preset
  and no `build_detector` entry, as in the JAX package.
* `dryrun_multichip(n_devices, device)`: the counterpart of the JAX
  package's `__graft_entry__.dryrun_multichip`: one CenterPoint and one
  CenterPoint + 3D-DF training step over n ranks, one sample each
  (`train.trainer.DataParallelTrainStep`), NCCL with one card a rank, or
  gloo CPU processes with `device="cpu"`.
* `voxel_rcnn_car_kitti()`, `voxel_rcnn_3ddf_kitti()`,
  `centerpoint_3ddf_nusc()`, `transfusion_l_nusc()`,
  `transfusion_3ddf_nusc()`, `transfusion_3ddf_swin_nusc()` and
  `fused_config(preset)` are imported from the presets registry
  (`config.presets`); `models.build.build_detector` builds any preset by
  name. `build_transfusion3ddf(..., checkpoint=)` reads an mmdet
  TransFusion + Swin checkpoint for a Swin preset
  (`train.import_transfusion.import_transfusion_3ddf_swin`).

Everything runs on the card unless the caller passes `device="cpu"`; with
no card, the default raises.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import tempfile

import numpy as np
import torch
import torch.distributed as dist

from df3d_torch.config.presets import (  # noqa: F401  (entry's old names)
    centerpoint_3ddf_nusc, fused_config, transfusion_3ddf_nusc,
    transfusion_3ddf_swin_nusc, transfusion_l_nusc, voxel_rcnn_3ddf_kitti,
    voxel_rcnn_car_kitti,
)
from df3d_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointConfig, centerpoint_predict,
)
from df3d_torch.models.detectors.fused import (
    CenterPoint3DDF, FusedConfig, TransFusion3DDF, VoxelRCNN3DDF,
)
from df3d_torch.models.detectors.pv_rcnn import (
    PVRCNN, PVRCNNConfig, PVRCNNRoIHead,
)
from df3d_torch.models.detectors.transfusion import (
    TransFusionConfig, TransFusionL, transfusion_predict,
)
from df3d_torch.models.detectors.voxel_rcnn import (
    VoxelRCNN, VoxelRCNNConfig, VoxelRCNNTwoStage, init_head_weights,
    proposal_layer, voxel_rcnn_post_processing,
)
from df3d_torch.models.fusion.actr import ACTRConfig
from df3d_torch.models.heads.voxelrcnn_head import VoxelRCNNHead
from df3d_torch.models.tta import (
    expand_images_double_flip, expand_points_double_flip,
    expand_proj_double_flip, merge_center_head_maps,
)
from df3d_torch.ops.voxelize import voxelize_batch
from df3d_torch.parallel import ddp
from df3d_torch.serving import apply_profile
from df3d_torch.train.import_centerpoint import import_centerpoint
from df3d_torch.train.import_transfusion import (
    import_transfusion, import_transfusion_3ddf_swin,
)
from df3d_torch.train.import_voxelrcnn import import_voxelrcnn
from df3d_torch.train.schedules import adam_onecycle
from df3d_torch.train.torch_import import load_torch_checkpoint
from df3d_torch.train.trainer import (
    CenterPointTrainStep, DataParallelTrainStep, FusedTrainStep, TrainState,
    TransFusionTrainStep, VoxelRCNNTrainStep, create_train_state,
    make_centerpoint_train_step, make_fused_train_step,
    make_transfusion_train_step, make_voxelrcnn_train_step,
)
from df3d_torch.utils import stages


def resolve_device(device=None) -> torch.device:
    """`device`, or the card when None; raises if a CUDA device is asked
    for and there is none."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "df3d_torch runs on a CUDA device and none is available; pass "
            "device='cpu' to run the plain PyTorch path")
    return device


def build_centerpoint(cfg: CenterPointConfig, device=None, seed: int = 0,
                      profile: str = "exact",
                      checkpoint: str | None = None) -> CenterPoint:
    """CenterPoint on `device` with random weights drawn from `seed`, or
    with the weights of a det3d `checkpoint` (.pth; either spconv layout),
    in eval mode, serving in the named profile (`serving.PROFILES`:
    "exact", or "tpu_v5e" for bf16 sparse-conv bodies from 32 input
    channels and a bf16-operand dense tail)."""
    device = resolve_device(device)
    model = CenterPoint(cfg)
    if checkpoint is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(import_centerpoint(
            model, load_torch_checkpoint(checkpoint)))
    apply_profile(model, profile)
    return model.to(device).eval()


def _train_state(model, device, tx) -> TrainState:
    """The state of `model` moved to `device` in training mode, with `tx`
    (default: AdamW with OneCycle at the JAX package's `tools/train.py`
    defaults, lr 1e-3 over 20 epochs of 100 steps)."""
    return create_train_state(model.to(device).train(),
                              tx or adam_onecycle(1e-3, 2000))


def build_centerpoint_trainer(cfg: CenterPointConfig, device=None,
                              seed: int = 0, tx=None
                              ) -> tuple[TrainState, CenterPointTrainStep]:
    """(state, step) for training CenterPoint on `device` from random
    weights drawn from `seed`, with the optimizer `tx`
    (`train.schedules.adam_onecycle(...)`; default AdamW with OneCycle at
    the JAX package's `tools/train.py` defaults, lr 1e-3, 20 epochs of 100
    steps)."""
    device = resolve_device(device)
    model = CenterPoint(cfg).init_weights(torch.Generator().manual_seed(seed))
    return _train_state(model, device, tx), make_centerpoint_train_step(cfg)


def _aux_fcfg(fcfg: FusedConfig, aux: bool,
              with_aux_seg: bool | None) -> FusedConfig:
    """`fcfg` with the aux head when `aux` or `with_aux_seg` asks for it
    (`with_aux_seg` None: as `aux`)."""
    head = aux if with_aux_seg is None else with_aux_seg
    if aux and not head:
        raise ValueError("aux=True needs the aux head (with_aux_seg)")
    return dataclasses.replace(fcfg, with_aux_seg=fcfg.with_aux_seg or head)


def _fused_trainer(model_cls, cfg, fcfg, device, seed, aux, with_aux_seg,
                   aux_seg_weight, aux_consistency_weight, tx):
    device = resolve_device(device)
    fcfg = _aux_fcfg(fcfg, aux, with_aux_seg)
    model = model_cls(cfg, fcfg).init_weights(
        torch.Generator().manual_seed(seed))
    return _train_state(model, device, tx), make_fused_train_step(
        cfg, aux, fcfg.image_shape, aux_seg_weight, aux_consistency_weight)


def build_centerpoint3ddf_trainer(cfg: CenterPointConfig, fcfg: FusedConfig,
                                  device=None, seed: int = 0,
                                  aux: bool = False,
                                  with_aux_seg: bool | None = None,
                                  aux_seg_weight: float = 1.0,
                                  aux_consistency_weight: float = 0.1,
                                  tx=None
                                  ) -> tuple[TrainState, FusedTrainStep]:
    """(state, step) for training CenterPoint + 3D-DF on `device` from
    random weights drawn from `seed` (as `build_centerpoint3ddf` draws
    them), with `build_centerpoint_trainer`'s AdamW and OneCycle; the
    state's parameters leave out the frozen image branch. `aux` adds the
    aux objectives, the images being `fcfg.image_shape` (the aux head's
    weights drawn after all others). `tx` as for
    `build_centerpoint_trainer`."""
    return _fused_trainer(CenterPoint3DDF, cfg, fcfg, device, seed, aux,
                          with_aux_seg, aux_seg_weight,
                          aux_consistency_weight, tx)


def build_transfusion_trainer(cfg: TransFusionConfig, device=None,
                              seed: int = 0, tx=None
                              ) -> tuple[TrainState, TransFusionTrainStep]:
    """(state, step) for training TransFusion-L on `device` from random
    weights drawn from `seed` (as `build_transfusion` draws them); `tx` as
    for `build_centerpoint_trainer`."""
    device = resolve_device(device)
    model = TransFusionL(cfg).init_weights(
        torch.Generator().manual_seed(seed))
    return _train_state(model, device, tx), make_transfusion_train_step(cfg)


def build_transfusion3ddf_trainer(cfg: TransFusionConfig, fcfg: FusedConfig,
                                  device=None, seed: int = 0,
                                  aux: bool = False,
                                  with_aux_seg: bool | None = None,
                                  aux_seg_weight: float = 1.0,
                                  aux_consistency_weight: float = 0.1,
                                  tx=None
                                  ) -> tuple[TrainState, FusedTrainStep]:
    """(state, step) for training TransFusion + 3D-DF on `device` from
    random weights drawn from `seed` (as `build_transfusion3ddf` draws
    them), with `build_centerpoint_trainer`'s AdamW and OneCycle; the
    state's parameters leave out the frozen image branch. `aux` and `tx`
    as for `build_centerpoint3ddf_trainer`."""
    return _fused_trainer(TransFusion3DDF, cfg, fcfg, device, seed, aux,
                          with_aux_seg, aux_seg_weight,
                          aux_consistency_weight, tx)


def _serve(model, cfg, predict, stage: str, points, valid, *model_inputs):
    """voxelize -> model(features, coords, *model_inputs) -> predict(cfg,
    preds), the last step's time marked as `stage`."""
    res = voxelize_batch(points, valid, cfg.voxel_size, cfg.pc_range,
                         cfg.grid_size, cfg.max_voxels,
                         cfg.max_points_per_voxel)
    stages.mark("voxelize")
    preds, _, overflow = model(res.features, res.coords, *model_inputs)
    det = predict(cfg, preds)
    stages.mark(stage)
    return det, overflow


@torch.no_grad()
def infer(model: CenterPoint, cfg: CenterPointConfig, points: torch.Tensor,
          valid: torch.Tensor):
    """points (B, P, F) xyz first, valid (B, P) -> (detections, cap
    overflows), in the serving profile the model was built with
    (`build_centerpoint`'s `profile`). Detections: boxes (B, K, 9), scores,
    labels, valid (B, K)."""
    return _serve(model, cfg, centerpoint_predict, "decode_nms", points,
                  valid)


def build_centerpoint3ddf(cfg: CenterPointConfig, fcfg: FusedConfig,
                          device=None, seed: int = 0) -> CenterPoint3DDF:
    device = resolve_device(device)
    model = CenterPoint3DDF(cfg, fcfg).init_weights(
        torch.Generator().manual_seed(seed))
    return model.to(device).eval()


@torch.no_grad()
def infer_fused(model: CenterPoint3DDF, cfg: CenterPointConfig,
                points: torch.Tensor, valid: torch.Tensor,
                images: torch.Tensor, proj: torch.Tensor):
    """points (B, P, F), valid (B, P), images (B, n_cam, H, W, 3)
    normalized, proj (B, n_cam, 3, 4) lidar -> image -> (detections, cap
    overflows), as `infer`."""
    return _serve(model, cfg, centerpoint_predict, "decode_nms", points,
                  valid, images, proj)


@torch.no_grad()
def infer_double_flip(model: CenterPoint | CenterPoint3DDF,
                      cfg: CenterPointConfig, points: torch.Tensor,
                      valid: torch.Tensor, images: torch.Tensor | None = None,
                      proj: torch.Tensor | None = None):
    """det3d's double-flip TTA of `infer` (or, with images and proj, of
    `infer_fused`): each sample as [identity, flip_y, flip_x, flip_both]
    in one batch-x4 forward, the head maps un-flipped and averaged
    (`models.tta`), then decode + NMS -> (detections of the B samples, cap
    overflows of the 4B variants). A fused model's cameras keep their
    images; each variant's reflection is composed into its projections."""
    cams = ()
    if images is not None:
        cams = (expand_images_double_flip(images),
                expand_proj_double_flip(proj))
    return _serve(model, cfg,
                  lambda c, preds: centerpoint_predict(
                      c, merge_center_head_maps(preds)),
                  "decode_nms", expand_points_double_flip(points),
                  valid.repeat_interleave(4, dim=0), *cams)


def build_transfusion(cfg: TransFusionConfig, device=None, seed: int = 0,
                      checkpoint: str | None = None) -> TransFusionL:
    """TransFusion-L on `device` with random weights drawn from `seed`, or
    with the weights of an mmdet3d `checkpoint` (.pth), in eval mode."""
    device = resolve_device(device)
    model = TransFusionL(cfg)
    if checkpoint is None:
        model.init_weights(torch.Generator().manual_seed(seed))
    else:
        model.load_state_dict(import_transfusion(
            model, load_torch_checkpoint(checkpoint)))
    return model.to(device).eval()


@torch.no_grad()
def infer_transfusion(model: TransFusionL, cfg: TransFusionConfig,
                      points: torch.Tensor, valid: torch.Tensor):
    """points (B, P, F) xyz first, valid (B, P) -> (detections, cap
    overflows). Detections: boxes (B, num_proposals, 9), scores, labels;
    every query is a detection (no NMS, as the reference's test config)."""
    return _serve(model, cfg, transfusion_predict, "decode", points, valid)


def build_transfusion3ddf(cfg: TransFusionConfig, fcfg: FusedConfig,
                          device=None, seed: int = 0,
                          checkpoint: str | None = None) -> TransFusion3DDF:
    """TransFusion + 3D-DF on `device` with random weights drawn from
    `seed`, in eval mode. With a Swin image branch, `checkpoint` (.pth) is
    an mmdet TransFusion + Swin checkpoint: its image backbone, neck and
    LiDAR detector replace those weights (the fusion hook, which it does
    not hold, keeps the seeded ones)."""
    device = resolve_device(device)
    model = TransFusion3DDF(cfg, fcfg).init_weights(
        torch.Generator().manual_seed(seed))
    if checkpoint is not None:
        if fcfg.image_branch != "swin":
            raise ValueError("build_transfusion3ddf reads a checkpoint for "
                             "the Swin image branch only")
        model.load_state_dict(import_transfusion_3ddf_swin(
            model, load_torch_checkpoint(checkpoint)))
    return model.to(device).eval()


@torch.no_grad()
def infer_transfusion_fused(model: TransFusion3DDF, cfg: TransFusionConfig,
                            points: torch.Tensor, valid: torch.Tensor,
                            images: torch.Tensor, proj: torch.Tensor):
    """As `infer_fused`, for TransFusion + 3D-DF; detections as
    `infer_transfusion`."""
    return _serve(model, cfg, transfusion_predict, "decode", points, valid,
                  images, proj)


def _voxelrcnn_head(cfg: VoxelRCNNConfig, generator: torch.Generator,
                    device) -> VoxelRCNNHead:
    head = VoxelRCNNHead(cfg.rcnn, cfg.voxel_size, cfg.pc_range)
    return init_head_weights(head, generator).to(device).eval()


def build_voxelrcnn(cfg: VoxelRCNNConfig, device=None, seed: int = 0,
                    checkpoint: str | None = None
                    ) -> tuple[VoxelRCNN, VoxelRCNNHead]:
    """(first stage, RCNN head) on `device`, with random weights drawn from
    `seed` or the weights of a pcdet `checkpoint` (.pth; either spconv
    layout), in eval mode."""
    device = resolve_device(device)
    if checkpoint is None:
        g = torch.Generator().manual_seed(seed)
        rpn = VoxelRCNN(cfg).init_weights(g).to(device).eval()
        return rpn, _voxelrcnn_head(cfg, g, device)
    rpn = VoxelRCNN(cfg)
    head = VoxelRCNNHead(cfg.rcnn, cfg.voxel_size, cfg.pc_range)
    rpn_sd, head_sd = import_voxelrcnn(rpn, head,
                                       load_torch_checkpoint(checkpoint))
    rpn.load_state_dict(rpn_sd)
    head.load_state_dict(head_sd)
    return rpn.to(device).eval(), head.to(device).eval()


def build_voxelrcnn3ddf(cfg: VoxelRCNNConfig, fcfg: FusedConfig,
                        device=None, seed: int = 0
                        ) -> tuple[VoxelRCNN3DDF, VoxelRCNNHead]:
    """As `build_voxelrcnn`, for Voxel R-CNN + 3D-DF."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    rpn = VoxelRCNN3DDF(cfg, fcfg).init_weights(g).to(device).eval()
    return rpn, _voxelrcnn_head(cfg, g, device)


def _voxelrcnn_trainer(rpn, head, cfg, fused: bool, tx, **aux):
    model = VoxelRCNNTwoStage(rpn, head)
    return (_train_state(model, next(rpn.parameters()).device, tx),
            make_voxelrcnn_train_step(cfg, fused, **aux))


def build_voxelrcnn_trainer(cfg: VoxelRCNNConfig, device=None,
                            seed: int = 0, tx=None
                            ) -> tuple[TrainState, VoxelRCNNTrainStep]:
    """(state, step) for training Voxel R-CNN on `device`: both stages in
    one `VoxelRCNNTwoStage`, random weights drawn from `seed` as
    `build_voxelrcnn` draws them, the optimizer `tx` (as for
    `build_centerpoint_trainer`) over both stages."""
    return _voxelrcnn_trainer(*build_voxelrcnn(cfg, device, seed), cfg,
                              fused=False, tx=tx)


def build_voxelrcnn3ddf_trainer(cfg: VoxelRCNNConfig, fcfg: FusedConfig,
                                device=None, seed: int = 0,
                                aux: bool = False,
                                with_aux_seg: bool | None = None,
                                aux_seg_weight: float = 1.0,
                                aux_consistency_weight: float = 0.1,
                                tx=None
                                ) -> tuple[TrainState, VoxelRCNNTrainStep]:
    """As `build_voxelrcnn_trainer`, for Voxel R-CNN + 3D-DF (weights as
    `build_voxelrcnn3ddf` draws them); the state's parameters leave out the
    frozen image branch, and the batch carries images (B, H, W, 3) and proj
    (B, 3, 4). `aux` as for `build_centerpoint3ddf_trainer`."""
    fcfg = _aux_fcfg(fcfg, aux, with_aux_seg)
    return _voxelrcnn_trainer(
        *build_voxelrcnn3ddf(cfg, fcfg, device, seed), cfg, fused=True,
        tx=tx, aux=aux, image_hw=fcfg.image_shape,
        aux_seg_weight=aux_seg_weight,
        aux_consistency_weight=aux_consistency_weight)


@torch.no_grad()
def infer_voxelrcnn(rpn: VoxelRCNN, head: VoxelRCNNHead,
                    cfg: VoxelRCNNConfig, points: torch.Tensor,
                    valid: torch.Tensor, images: torch.Tensor | None = None,
                    proj: torch.Tensor | None = None):
    """points (B, P, 4) xyz first, valid (B, P) -> (detections, cap
    overflows). Detections: boxes (B, F, 7), scores, labels, valid (B, F),
    and the proposals, rois (B, R, 7) and roi_mask (B, R), as the JAX
    package's `make_voxelrcnn_eval_step` returns them. images (B, H, W, 3)
    normalized and proj (B, 3, 4) lidar -> image: the camera of a
    `VoxelRCNN3DDF` first stage, None for `VoxelRCNN`."""
    res = voxelize_batch(points, valid, cfg.voxel_size, cfg.pc_range,
                         cfg.grid_size, cfg.max_voxels,
                         cfg.max_points_per_voxel)
    stages.mark("voxelize")
    cams = () if images is None else (images, proj)
    preds, overflow = rpn(res.features, res.coords, *cams)
    anchors = getattr(rpn, "detector", rpn).anchors
    rois, _, roi_mask = proposal_layer(cfg, preds, anchors)
    cls, reg = head(rois, roi_mask, preds["ms"])
    stages.mark("roi_head")
    det = voxel_rcnn_post_processing(cfg, rois, roi_mask, cls, reg)
    det.update(rois=rois, roi_mask=roi_mask)
    stages.mark("post")
    return det, overflow


infer_voxelrcnn_fused = infer_voxelrcnn


def build_pvrcnn(cfg: PVRCNNConfig, device=None, seed: int = 0
                 ) -> tuple[PVRCNN, PVRCNNRoIHead]:
    """(PVRCNN, PVRCNNRoIHead) on `device` with random weights drawn from
    `seed` (on the CPU, so every device gets the same), in eval mode."""
    device = resolve_device(device)
    g = torch.Generator().manual_seed(seed)
    model = PVRCNN(cfg).init_weights(g).to(device).eval()
    head = PVRCNNRoIHead(cfg).init_weights(g).to(device).eval()
    return model, head


@torch.no_grad()
def infer_pvrcnn(model: PVRCNN, head: PVRCNNRoIHead, cfg: PVRCNNConfig,
                 points: torch.Tensor, valid: torch.Tensor):
    """PV-RCNN's serving path as the JAX package composes it: voxelize ->
    `PVRCNN` -> `proposal_layer` (cfg.base's test NMS) -> `PVRCNNRoIHead`
    -> `voxel_rcnn_post_processing`. points (B, P, 4), valid (B, P) ->
    (detections with the RoIs, keypoints, their features, fg logits and
    the head's outputs, cap overflows)."""
    base = cfg.base
    res = voxelize_batch(points, valid, base.voxel_size, base.pc_range,
                         base.grid_size, base.max_voxels,
                         base.max_points_per_voxel)
    stages.mark("voxelize")
    preds, overflow = model(res.features, res.coords, points, valid)
    rois, _, roi_mask = proposal_layer(base, preds, model.anchors)
    cls, reg = head(rois, roi_mask, preds["keypoints"], preds["kp_feats"])
    det = voxel_rcnn_post_processing(base, rois, roi_mask, cls, reg)
    det.update(rois=rois, roi_mask=roi_mask, keypoints=preds["keypoints"],
               kp_feats=preds["kp_feats"],
               point_fg_logits=preds["point_fg_logits"], rcnn_cls=cls,
               rcnn_reg=reg)
    stages.mark("post")
    return det, overflow


def small_cfg() -> CenterPointConfig:
    """The JAX package's `__graft_entry__._small_cfg()`."""
    return CenterPointConfig(
        pc_range=(-25.6, -25.6, -2.4, 25.6, 25.6, 2.4),
        voxel_size=(0.4, 0.4, 0.2),
        grid_size=(24, 128, 128),
        max_voxels=2048,
        num_point_features=5,
        stage_caps=(2048, 1024, 512, 256),
        tasks=(1, 2, 2, 1, 2, 2),
        out_size_factor=8,
        max_objs=32,
        post_center_range=(-30.0, -30.0, -4.0, 30.0, 30.0, 4.0),
        nms_pre_max_size=128,
        nms_post_max_size=16,
    )


def random_points(rng: np.random.RandomState, batch: int, n: int,
                  f: int = 5) -> np.ndarray:
    """Uniform points over the small config's range (the JAX package's
    `__graft_entry__._random_points`)."""
    return np.concatenate([
        rng.uniform(-25, 25, (batch, n, 2)),
        rng.uniform(-1.8, 1.8, (batch, n, 1)),
        rng.uniform(0, 1, (batch, n, f - 3)),
    ], axis=-1).astype(np.float32)


def entry(device=None):
    """-> (fn, (voxel_features, voxel_coords)); fn runs the CenterPoint
    forward and returns the per-task head maps."""
    device = resolve_device(device)
    cfg = small_cfg()
    points = torch.from_numpy(
        random_points(np.random.RandomState(0), 1, 2000)).to(device)
    valid = torch.ones(points.shape[:2], dtype=torch.bool, device=device)
    res = voxelize_batch(points, valid, cfg.voxel_size, cfg.pc_range,
                         cfg.grid_size, cfg.max_voxels,
                         cfg.max_points_per_voxel)
    model = build_centerpoint(cfg, device)

    @torch.no_grad()
    def fn(feats, coords):
        return model(feats, coords)[0]

    return fn, (res.features, res.coords)


def mesh_cfg() -> CenterPointConfig:
    """The JAX package's `__graft_entry__._mesh_cfg()`: the multichip dry
    run's config."""
    return CenterPointConfig(
        pc_range=(-16.0, -16.0, -2.4, 16.0, 16.0, 2.4),
        voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64),
        max_voxels=256, num_point_features=5, stage_caps=(256, 128, 96, 64),
        tasks=(1, 2), max_objs=8, nms_pre_max_size=32, nms_post_max_size=4,
        post_center_range=(-20.0, -20.0, -4.0, 20.0, 20.0, 4.0))


def dryrun_fused_config() -> FusedConfig:
    """The fused config of the JAX package's `_dryrun_fused_step`: two
    32x48 cameras, one-block ResNet stages, a tiny ACTR (no LT)."""
    return FusedConfig(
        image_shape=(32, 48), n_levels=2, num_cams=2,
        image_layers=(1, 1, 1, 1),
        actr=ACTRConfig(d_model=16, n_heads=2, n_points=2, n_levels=2,
                        num_layers=1, dim_feedforward=32, model_name="ACTR"))


def dryrun_batches(n: int) -> tuple[dict, dict]:
    """The dry run's two global batches of n samples, numpy, as the JAX
    package's `dryrun_multichip` draws them: 512 (LiDAR step) and 256
    (fused step) points a sample over +-25 m, four equal boxes of class 0
    and four padding slots; the fused batch adds two random 32x48 images
    and random projections a sample."""
    box = np.array([1.0, 2.0, 0.0, 4.0, 2.0, 1.5, 0.3, 0.0, 0.0], np.float32)
    gt_valid = np.zeros((n, 8), bool)
    gt_valid[:, :4] = True

    def batch(points):
        return {"points": points,
                "points_valid": np.ones(points.shape[:2], bool),
                "gt_boxes": np.tile(box, (n, 8, 1)),
                "gt_classes": np.zeros((n, 8), np.int32),
                "gt_valid": gt_valid}

    lidar = batch(random_points(np.random.RandomState(0), n, 512))
    rng = np.random.RandomState(1)
    fused = batch(random_points(rng, n, 256))
    fused["images"] = rng.rand(n, 2, 32, 48, 3).astype(np.float32)
    fused["proj"] = rng.randn(n, 2, 3, 4).astype(np.float32)
    return lidar, fused


def _dryrun_step(state, step, batch, rank, n, dev) -> float:
    """One data-parallel step of the global numpy `batch` on this rank's
    sample; the summed loss, asserted finite."""
    ddp.broadcast_state(state)
    mine = {k: torch.from_numpy(np.ascontiguousarray(v)).to(dev)
            for k, v in ddp.shard_batch(batch, rank, n).items()}
    _, logs = DataParallelTrainStep(step)(state, mine)
    loss = float(logs["loss"])
    if not math.isfinite(loss):
        raise FloatingPointError(f"rank {rank}: non-finite loss {loss}")
    return loss


def _dryrun_rank(rank: int, n: int, device, init_method: str,
                 out: str) -> None:
    """One rank of `dryrun_multichip`."""
    if device == "cpu":
        torch.set_num_threads(1)
    dev = ddp.init_data_parallel(rank, n, init_method=init_method,
                                 device=device if device == "cpu" else None)
    try:
        lidar, fused = dryrun_batches(n)
        cfg = mesh_cfg()
        model = CenterPoint(cfg).init_weights(torch.Generator().manual_seed(0))
        state = create_train_state(model.to(dev).train(),
                                   adam_onecycle(1e-3, 100))
        loss = _dryrun_step(state, make_centerpoint_train_step(cfg), lidar,
                            rank, n, dev)
        # constant weights, as the JAX dry run's fused state (finite, not
        # meaningful)
        fmodel = CenterPoint3DDF(cfg, dryrun_fused_config())
        with torch.no_grad():
            for t in list(fmodel.parameters()) + list(fmodel.buffers()):
                if t.is_floating_point():
                    t.fill_(0.01)
        state = create_train_state(fmodel.to(dev).train(),
                                   adam_onecycle(1e-3, 100))
        fused_loss = _dryrun_step(state, make_fused_train_step(cfg), fused,
                                  rank, n, dev)
        if rank == 0:
            with open(out, "w") as f:
                json.dump({"loss": loss, "fused_loss": fused_loss}, f)
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The twin of the JAX package's `__graft_entry__.dryrun_multichip`:
    one CenterPoint training step (`mesh_cfg()`, random weights) and one
    CenterPoint + 3D-DF step (`dryrun_fused_config()`, constant weights)
    over `n_devices` ranks, one sample each (`dryrun_batches`), with
    `DataParallelTrainStep`. The ranks are new processes: by default one
    card each over NCCL (raises if fewer cards exist), with `device="cpu"`
    gloo CPU processes. Each rank asserts finite losses; prints the summed
    losses as the JAX dry run does and returns them."""
    if device is None:
        resolve_device()
        if torch.cuda.device_count() < n_devices:
            raise RuntimeError(
                f"dryrun_multichip({n_devices}): {torch.cuda.device_count()}"
                " CUDA devices")
    elif torch.device(device).type != "cpu":
        raise ValueError("dryrun_multichip runs one card a rank "
                         "(device=None) or CPU processes (device='cpu')")
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "losses.json")
        torch.multiprocessing.spawn(
            _dryrun_rank, nprocs=n_devices,
            args=(n_devices, device, f"file://{tmp}/store", out))
        with open(out) as f:
            losses = json.load(f)
    print(f"dryrun_multichip({n_devices}): ok, loss={losses['loss']:.4f}, "
          f"fused_loss={losses['fused_loss']:.4f}")
    return losses
