"""The training steps of CenterPoint, TransFusion-L, Voxel R-CNN and their
3D-DF fused detectors (port of df3d/train/trainer.py:23-75,
`make_voxelrcnn_train_step` at :78, `make_transfusion_train_step` at :171,
`_fused_aux_terms` at :225 and `make_fused_train_step` at :277).

One step: voxelize -> (fused: the frozen image branch) -> forward in
training mode (batch statistics, the running ones moved) -> the host
family's loss (`centerpoint_loss`, or `transfusion_loss` with its
Hungarian assignment on the host) -> gradients by autograd (the sparse
convs' input gradients are K1 launches on the card, the deformable
attention's gradients a K2 backward launch) -> clip + AdamW with
OneCycle. A fused step with `aux` adds the aux objectives
(`fused_aux_terms`: the image-FG segmentation loss on the model's aux
head, the voxel/camera consistency loss at the ACTR fusion point) to the
loss and their logs to the step's. The JAX package's step is a pure
function of its state; here
the model holds the parameters and batch statistics, and the step updates
them and the optimizer moments in place, which keeps one copy of each on
the card.

The state's parameters are the trainable ones: a frozen image branch is
left out of the optimizer. optax's `adamw` in the JAX package decays every
leaf, so there each step moves the "frozen" branch by lr * weight_decay *
p; the port does not copy that (ROADMAP section 3).

Voxel R-CNN's step adds the RPN's anchor targets, the proposals (NMS) and
the proposal target layer between its two stages. The proposals carry no
gradient, as in pcdet, whose proposal and proposal target layers run under
`torch.no_grad()`; the JAX package's step differentiates through them, so
the RCNN losses reach the RPN's box branch through the RoIs and the IoU
targets there (ROADMAP section 3). The RoI features stay attached.

`DataParallelTrainStep` runs any of these steps over the ranks of a
process group, each on its share of the global batch, and equals the
one-process step on the global batch (`parallel.ddp`).

Evaluation (the JAX package's `trainer.py:342` and `:459`): CenterPoint's
eval step with det3d's double-flip TTA (`make_centerpoint_eval_step`) and
the batch-norm recalibration by momentum inversion
(`recalibrate_batch_stats`).
"""

from __future__ import annotations

import dataclasses

import torch

from df3d_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointConfig, cap_overflow_total, centerpoint_loss,
)
from df3d_torch.models.detectors.fused import (
    CenterPoint3DDF, TransFusion3DDF,
)
from df3d_torch.models.detectors.transfusion import (
    TransFusionConfig, TransFusionL, transfusion_loss,
)
from df3d_torch.models.detectors.voxel_rcnn import (
    VoxelRCNNConfig, VoxelRCNNTwoStage, assign_rpn_targets, proposal_layer,
    voxel_rcnn_train_losses,
)
from df3d_torch.models.fusion.actr import ACTR
from df3d_torch.models.fusion.aux_heads import AuxSegHead, fused_aux_losses
from df3d_torch.models.heads.voxelrcnn_head import sample_rois_for_training
from df3d_torch.models.layers import FlaxBatchNorm, MaskedBatchNorm
from df3d_torch.ops.voxelize import voxelize_batch
from df3d_torch.parallel import ddp
from df3d_torch.train.schedules import AdamOneCycle, AdamState
from df3d_torch.utils import stages


@dataclasses.dataclass
class TrainState:
    """The counterpart of the JAX package's `TrainState`: the model (its
    parameters and batch statistics), the optimizer and its moments, and the
    number of steps taken."""

    model: (CenterPoint | CenterPoint3DDF | TransFusionL | TransFusion3DDF
            | VoxelRCNNTwoStage)
    tx: AdamOneCycle
    opt_state: AdamState
    step: int = 0

    @property
    def params(self) -> list[torch.Tensor]:
        """The trainable parameters (`requires_grad`), in module order."""
        return [p for p in self.model.parameters() if p.requires_grad]

    @property
    def param_names(self) -> list[str]:
        return [n for n, p in self.model.named_parameters()
                if p.requires_grad]


def create_train_state(model, tx: AdamOneCycle) -> TrainState:
    """A state for `model` as it stands (random or carried weights), with
    the optimizer moments at zero, as `TrainState.create` leaves them, for
    its trainable parameters (a fused detector's without the frozen image
    branch)."""
    state = TrainState(model, tx, AdamState([], []))
    state.opt_state = tx.init(state.params)
    return state


class CenterPointTrainStep:
    """`step(state, batch) -> (state, logs)`.

    batch: points (B, P, F), points_valid (B, P), gt_boxes (B, M, 9),
    gt_classes (B, M) global class ids, gt_valid (B, M). logs: per task
    `task{t}_hm_loss` and `task{t}_loc_loss`, `loss` and `cap_overflow`, as
    0-d tensors on the model's device. `grads` and `apply` are the step's two
    halves."""

    loss = staticmethod(centerpoint_loss)
    aux = False  # the fused steps' aux objectives

    def __init__(self, cfg: CenterPointConfig):
        self.cfg = cfg

    def voxelize(self, batch: dict):
        cfg = self.cfg
        with torch.no_grad():
            res = voxelize_batch(batch["points"], batch["points_valid"],
                                 cfg.voxel_size, cfg.pc_range, cfg.grid_size,
                                 cfg.max_voxels, cfg.max_points_per_voxel)
        stages.mark("voxelize")
        return res

    def forward_loss(self, model, batch: dict):
        """Voxelize, forward in training mode, loss -> (total, logs)."""
        cfg = self.cfg
        res = self.voxelize(batch)
        aux = {} if self.aux else None
        preds, _, overflow = model(res.features, res.coords,
                                   *self.model_inputs(batch, aux))
        total, logs = self.loss(cfg, preds, batch["gt_boxes"],
                                batch["gt_classes"], batch["gt_valid"])
        logs["cap_overflow"] = cap_overflow_total(overflow)
        stages.mark("loss")
        return self.add_aux(total, logs, aux, batch)

    def grads(self, state: TrainState, batch: dict, *args, **kwargs):
        """Forward, loss and backward -> (logs, gradients in
        `state.params` order). Further arguments go to `forward_loss`."""
        model = state.model
        model.train()
        total, logs = self.forward_loss(model, batch, *args, **kwargs)
        unreached = self.unreached(model)
        grads = torch.autograd.grad(total, state.params,
                                    allow_unused=bool(unreached))
        # only the leaves the model says the loss cannot reach go without a
        # gradient, and get zeros, as in JAX; any other is a cut path
        missing = {id(p) for p, g in zip(state.params, grads) if g is None}
        if missing != unreached:
            names = [n for n, p in zip(state.param_names, state.params)
                     if (id(p) in missing) != (id(p) in unreached)]
            raise RuntimeError("gradient reaches the leaves the model says "
                               f"it cannot, or misses others: {names}")
        grads = [torch.zeros_like(p) if g is None else g
                 for p, g in zip(state.params, grads)]
        stages.mark("backward")
        return {k: v.detach() for k, v in logs.items()}, grads

    def model_inputs(self, batch: dict, aux: dict | None = None) -> tuple:
        """The model's inputs after the voxels; a fused model's end with
        `aux` when it is given (the dict its forward fills with the aux
        head's logits and the consistency pairs)."""
        return ()

    def unreached(self, model) -> set[int]:
        """ids of the trainable parameters the loss cannot reach."""
        return set()

    def add_aux(self, total, logs: dict, aux: dict | None, batch: dict):
        """The aux objectives of the forward's `aux` outputs (none when
        None) at their weights added to the loss, their logs to the step's,
        `loss` the new total."""
        if aux is None:
            return total, logs
        a_total, a_logs = fused_aux_terms(
            aux, batch, self.image_hw, self.aux_seg_weight,
            self.aux_consistency_weight)
        total = total + a_total
        logs = dict(logs, **a_logs, loss=total)
        stages.mark("aux")
        return total, logs

    def apply(self, state: TrainState, grads) -> TrainState:
        state.tx.update(grads, state.opt_state, state.params)
        state.step += 1
        stages.mark("optimizer")
        return state

    def __call__(self, state: TrainState, batch: dict, *args):
        logs, grads = self.grads(state, batch, *args)
        return self.apply(state, grads), logs


def make_centerpoint_train_step(cfg: CenterPointConfig) -> CenterPointTrainStep:
    return CenterPointTrainStep(cfg)


class TransFusionTrainStep(CenterPointTrainStep):
    """The TransFusion-L step, `step(state, batch) -> (state, logs)` as
    `CenterPointTrainStep` with `transfusion_loss`; logs `tf_cls_loss`,
    `tf_bbox_loss`, `tf_hm_loss`, `tf_matched`, `loss` and
    `cap_overflow`."""

    loss = staticmethod(transfusion_loss)


def make_transfusion_train_step(cfg: TransFusionConfig
                                ) -> TransFusionTrainStep:
    return TransFusionTrainStep(cfg)


def fused_aux_terms(aux: dict, batch: dict, image_hw, seg_weight: float,
                    consistency_weight: float):
    """The aux objectives of a fused forward's `aux` outputs (the JAX
    package's `_fused_aux_terms`) -> (total, logs). A multi-camera batch's
    projections fold to (B * n_cam, 3, 4) and its gt boxes repeat sample
    by sample, as the head's logits are folded."""
    proj = batch["proj"]
    gt_boxes, gt_valid = batch["gt_boxes"], batch["gt_valid"]
    if proj.dim() == 4:
        b, nc = proj.shape[:2]
        proj = proj.reshape(b * nc, 3, 4)
        gt_boxes = gt_boxes.repeat_interleave(nc, 0)
        gt_valid = gt_valid.repeat_interleave(nc, 0)
    pairs = aux["consistency"]
    vf, ifeat, vmask = pairs[0] if pairs else (None, None, None)
    return fused_aux_losses(aux["seg_logits"], gt_boxes, gt_valid, proj,
                            image_hw, voxel_feats=vf,
                            image_feats_at_voxels=ifeat, voxel_mask=vmask,
                            seg_weight=seg_weight,
                            consistency_weight=consistency_weight)


class FusedTrainStep(CenterPointTrainStep):
    """The 3D-DF step of a CenterPoint or TransFusion-L host,
    `step(state, batch) -> (state, logs)` as its host's step, with images
    (B, n_cam, H, W, 3) normalized and proj (B, n_cam, 3, 4) lidar -> image
    in the batch; the loss and logs are the host family's, `cap_overflow`
    counting the fusion's dense tail too.

    `aux` adds the aux objectives (the model built with
    `FusedConfig.with_aux_seg`; `image_hw` the input images' (H, W)) at
    `aux_seg_weight` and `aux_consistency_weight`, and the logs
    `aux_seg_loss`, `aux_consistency_loss` and `aux_loss`. Without it, an
    aux head the model carries is not run and gets zero gradients."""

    def __init__(self, cfg: CenterPointConfig | TransFusionConfig,
                 aux: bool = False, image_hw=None,
                 aux_seg_weight: float = 1.0,
                 aux_consistency_weight: float = 0.1):
        if isinstance(cfg, CenterPointConfig):
            self.loss = centerpoint_loss
        elif isinstance(cfg, TransFusionConfig):
            self.loss = transfusion_loss
        else:
            raise ValueError(f"unsupported fused host config {type(cfg)}")
        super().__init__(cfg)
        self.set_aux(aux, image_hw, aux_seg_weight, aux_consistency_weight)

    def set_aux(self, aux, image_hw, seg_weight, consistency_weight):
        if aux and image_hw is None:
            raise ValueError("aux objectives need image_hw, the input "
                             "images' (H, W)")
        self.aux, self.image_hw = aux, image_hw
        self.aux_seg_weight = seg_weight
        self.aux_consistency_weight = consistency_weight

    def model_inputs(self, batch: dict, aux: dict | None = None) -> tuple:
        cams = (batch["images"], batch["proj"])
        return cams if aux is None else cams + (aux,)

    def unreached(self, model) -> set[int]:
        """The fusion's last dual-query layer's image-only parameters
        (`ACTR.unreached_parameters`) and, without `aux`, the aux head's."""
        out = {id(p) for m in model.modules() if isinstance(m, ACTR)
               for p in m.unreached_parameters()}
        if not self.aux:
            out |= {id(p) for m in model.modules()
                    if isinstance(m, AuxSegHead) for p in m.parameters()}
        return out


def make_fused_train_step(cfg: CenterPointConfig | TransFusionConfig,
                          aux: bool = False, image_hw=None,
                          aux_seg_weight: float = 1.0,
                          aux_consistency_weight: float = 0.1
                          ) -> FusedTrainStep:
    return FusedTrainStep(cfg, aux, image_hw, aux_seg_weight,
                          aux_consistency_weight)


class VoxelRCNNTrainStep(CenterPointTrainStep):
    """Voxel R-CNN's two-stage step (or, `fused`, Voxel R-CNN + 3D-DF's),
    `step(state, batch, generator) -> (state, logs)` on a state whose model
    is a `VoxelRCNNTwoStage`: one clip and one AdamW over both stages'
    trainable parameters.

    batch: points (B, P, 4), points_valid (B, P), gt_boxes (B, M, 7 or
    more; the first 7 are read), gt_classes (B, M) anchor class ids,
    gt_valid (B, M); fused, also images (B, H, W, 3) normalized and proj
    (B, 3, 4). `generator` (on the step's device) draws the proposal target
    layer's tie-breaking noise, uniform in [0, 1e-3) per proposal (the JAX
    package draws it from its step's key). logs: rpn_cls_loss,
    rpn_loc_loss, rpn_dir_loss, rpn_loss, rcnn_cls_loss, rcnn_reg_loss,
    rcnn_corner_loss, rcnn_loss, loss and cap_overflow; fused with `aux`,
    the aux objectives and logs as `FusedTrainStep`'s."""

    def __init__(self, cfg: VoxelRCNNConfig, fused: bool = False,
                 aux: bool = False, image_hw=None,
                 aux_seg_weight: float = 1.0,
                 aux_consistency_weight: float = 0.1):
        super().__init__(cfg)
        if aux and not fused:
            raise ValueError("aux objectives are the fused step's")
        self.fused = fused
        self.set_aux(aux, image_hw, aux_seg_weight, aux_consistency_weight)

    def model_inputs(self, batch: dict, aux: dict | None = None) -> tuple:
        if not self.fused:
            return ()
        return FusedTrainStep.model_inputs(self, batch, aux)

    set_aux = FusedTrainStep.set_aux
    unreached = FusedTrainStep.unreached

    def forward_loss(self, model: VoxelRCNNTwoStage, batch: dict,
                     generator: torch.Generator | None = None,
                     noise: torch.Tensor | None = None):
        """As the base step's, with the two stages; `noise` (B, R0), when
        given, stands for the generator's draw."""
        cfg = self.cfg
        res = self.voxelize(batch)
        gt = batch["gt_boxes"][..., :7]
        with torch.no_grad():
            rpn_targets = assign_rpn_targets(cfg, model.anchors, gt,
                                             batch["gt_classes"],
                                             batch["gt_valid"])
        stages.mark("rpn_targets")
        aux = {} if self.aux else None
        preds, overflow = model.rpn(res.features, res.coords,
                                    *self.model_inputs(batch, aux))
        with torch.no_grad():  # the proposals carry no gradient (pcdet)
            rois, roi_scores, roi_mask = proposal_layer(
                cfg, preds, model.anchors, train=True)
            if noise is None:
                noise = torch.rand(roi_scores.shape, generator=generator,
                                   device=roi_scores.device) * 1e-3
            targets = sample_rois_for_training(
                rois, roi_scores, roi_mask, gt, batch["gt_valid"], noise,
                cfg.rcnn)
        stages.mark("roi_sample")
        cls, reg = model.rcnn(targets["rois"], targets["mask"], preds["ms"])
        stages.mark("roi_head")
        total, logs = voxel_rcnn_train_losses(
            cfg, preds, {"cls": cls, "reg": reg}, rpn_targets, targets)
        logs["cap_overflow"] = cap_overflow_total(overflow)
        stages.mark("loss")
        return self.add_aux(total, logs, aux, batch)


def make_voxelrcnn_train_step(cfg: VoxelRCNNConfig, fused: bool = False,
                              aux: bool = False, image_hw=None,
                              aux_seg_weight: float = 1.0,
                              aux_consistency_weight: float = 0.1
                              ) -> VoxelRCNNTrainStep:
    return VoxelRCNNTrainStep(cfg, fused, aux, image_hw, aux_seg_weight,
                              aux_consistency_weight)


class DataParallelTrainStep:
    """One of the steps above over the ranks of the default process group:
    `step(state, batch[, generator]) -> (state, logs)`, `batch` this
    rank's rows of the global batch (`ddp.shard_batch`), every rank
    holding the same state (`ddp.broadcast_state`).

    The rank's forward and backward run under `ddp.data_parallel`, so the
    norms' statistics and the losses' normalizers cover the global batch
    and each rank's loss is its share of the global loss. Its gradients
    are then summed over the ranks, in one all-reduce of their flattened
    concatenation, and the sum goes to the optimizer, whose clip sees the
    global norm; the logs are summed too. So every rank takes the
    one-process step on the global batch. Voxel R-CNN's RoI sampler noise
    is drawn for the global batch from `generator` (seeded alike on every
    rank), as the one-process step draws it, and each rank takes its
    rows; or it is this rank's rows `noise`, drawn by the caller."""

    def __init__(self, step: CenterPointTrainStep):
        self.step = step

    def grads(self, state: TrainState, batch: dict, generator=None,
              noise: torch.Tensor | None = None):
        """The summed (logs, gradients) of the global batch."""
        kwargs = {}
        if noise is not None:
            kwargs["noise"] = noise
        elif isinstance(self.step, VoxelRCNNTrainStep):
            world = torch.distributed.get_world_size()
            rank = torch.distributed.get_rank()
            b = batch["points"].shape[0]
            noise = torch.rand((b * world, self.step.cfg.train_post_nms),
                               generator=generator,
                               device=batch["points"].device) * 1e-3
            kwargs["noise"] = noise[rank * b:(rank + 1) * b]
        with ddp.data_parallel():
            logs, grads = self.step.grads(state, batch, **kwargs)
        grads = ddp.sum_over_ranks(grads)
        logs = ddp.sum_over_ranks(logs)
        stages.mark("allreduce")
        return logs, grads

    def __call__(self, state: TrainState, batch: dict, *args):
        logs, grads = self.grads(state, batch, *args)
        return self.step.apply(state, grads), logs


def make_centerpoint_eval_step(model: CenterPoint | CenterPoint3DDF,
                               cfg: CenterPointConfig, tta: str | None = None,
                               fused: bool = False):
    """`eval_step(batch) -> detections` of CenterPoint (`fused`:
    CenterPoint + 3D-DF, whose batch carries images and proj too), the
    counterpart of the JAX package's `make_centerpoint_eval_step`. Without
    `tta` it is `entry.infer` (or `infer_fused`); with tta="double_flip",
    `entry.infer_double_flip`: det3d's double-flip TTA, one batch-x4
    forward of the flipped variants whose head maps are un-flipped and
    averaged before decoding."""
    from df3d_torch import entry  # entry builds on this module

    if tta not in (None, "double_flip"):
        raise ValueError(f"tta={tta!r}: None or 'double_flip'")
    if tta:
        infer = entry.infer_double_flip
    else:
        infer = entry.infer_fused if fused else entry.infer
    keys = ("points", "points_valid") + (("images", "proj") if fused else ())

    def eval_step(batch: dict) -> dict:
        return infer(model, cfg, *(batch[k] for k in keys))[0]

    return eval_step


@torch.no_grad()
def recalibrate_batch_stats(model: torch.nn.Module, forward) -> None:
    """Exact batch-norm recalibration by momentum inversion (the JAX
    package's `recalibrate_batch_stats`): `forward()` runs one
    training-mode forward of `model` on a calibration batch, and every
    training norm's running statistics become that batch's statistics.

    A norm moves its running statistics by s1 = m * s0 + (1 - m) * b, so b
    = (s1 - m * s0) / (1 - m), at each norm's own momentum m (0.99; 0.9 on
    TransFusion's position embeddings and FFN branches), with the variance
    floored at 0 against cancellation and each statistic's dtype kept.
    Train-mode activations do not read the running statistics, so one
    forward recovers every layer's. The norms are the `MaskedBatchNorm`s
    and flax-style `FlaxBatchNorm`s (the 2D ones too); a frozen image
    branch's norms stay in eval mode and keep their statistics and step
    counters. `model` is left in the mode it was in."""
    norms = [m for m in model.modules()
             if isinstance(m, (MaskedBatchNorm, FlaxBatchNorm))]
    before = [(bn.running_mean.clone(), bn.running_var.clone())
              for bn in norms]
    was_training = model.training
    model.train()
    try:
        forward()
    finally:
        model.train(was_training)
    for bn, (mean0, var0) in zip(norms, before):
        m = bn.momentum
        mean = (bn.running_mean - m * mean0) / (1.0 - m)
        var = ((bn.running_var - m * var0) / (1.0 - m)).clamp_min(0.0)
        bn.running_mean.copy_(mean.to(mean0.dtype))
        bn.running_var.copy_(var.to(var0.dtype))
