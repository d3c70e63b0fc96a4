"""The training steps of CenterPoint, TransFusion-L and their 3D-DF fused
detectors (port of df3d/train/trainer.py:23-75,
`make_transfusion_train_step` at :171 and `make_fused_train_step` at
:277, aux off).

One step: voxelize -> (fused: the frozen image branch) -> forward in
training mode (batch statistics, the running ones moved) -> the host
family's loss (`centerpoint_loss`, or `transfusion_loss` with its
Hungarian assignment on the host) -> gradients by autograd (the sparse
convs' input gradients are K1 launches on the card, the deformable
attention's gradients a K2 backward launch) -> clip + AdamW with
OneCycle. The JAX package's step is a pure function of its state; here
the model holds the parameters and batch statistics, and the step updates
them and the optimizer moments in place, which keeps one copy of each on
the card.

The state's parameters are the trainable ones: a frozen image branch is
left out of the optimizer. optax's `adamw` in the JAX package decays every
leaf, so there each step moves the "frozen" branch by lr * weight_decay *
p; the port does not copy that (ROADMAP section 3).
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
from df3d_torch.models.fusion.actr import ACTR
from df3d_torch.ops.voxelize import voxelize_batch
from df3d_torch.train.schedules import AdamOneCycle, AdamState
from df3d_torch.utils import stages


@dataclasses.dataclass
class TrainState:
    """The counterpart of the JAX package's `TrainState`: the model (its
    parameters and batch statistics), the optimizer and its moments, and the
    number of steps taken."""

    model: CenterPoint | CenterPoint3DDF | TransFusionL | TransFusion3DDF
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

    def __init__(self, cfg: CenterPointConfig):
        self.cfg = cfg

    def grads(self, state: TrainState, batch: dict):
        """Forward, loss and backward -> (logs, gradients in
        `state.params` order)."""
        cfg, model = self.cfg, state.model
        model.train()
        with torch.no_grad():
            res = voxelize_batch(batch["points"], batch["points_valid"],
                                 cfg.voxel_size, cfg.pc_range, cfg.grid_size,
                                 cfg.max_voxels, cfg.max_points_per_voxel)
        stages.mark("voxelize")
        preds, _, overflow = model(res.features, res.coords,
                                   *self.model_inputs(batch))
        total, logs = self.loss(cfg, preds, batch["gt_boxes"],
                                batch["gt_classes"], batch["gt_valid"])
        logs["cap_overflow"] = cap_overflow_total(overflow)
        stages.mark("loss")
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

    def model_inputs(self, batch: dict) -> tuple:
        """The model's inputs after the voxels."""
        return ()

    def unreached(self, model) -> set[int]:
        """ids of the trainable parameters the loss cannot reach."""
        return set()

    def apply(self, state: TrainState, grads) -> TrainState:
        state.tx.update(grads, state.opt_state, state.params)
        state.step += 1
        stages.mark("optimizer")
        return state

    def __call__(self, state: TrainState, batch: dict):
        logs, grads = self.grads(state, batch)
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


class FusedTrainStep(CenterPointTrainStep):
    """The 3D-DF step of a CenterPoint or TransFusion-L host,
    `step(state, batch) -> (state, logs)` as its host's step, with images
    (B, n_cam, H, W, 3) normalized and proj (B, n_cam, 3, 4) lidar -> image
    in the batch; the loss and logs are the host family's, `cap_overflow`
    counting the fusion's dense tail too."""

    def __init__(self, cfg: CenterPointConfig | TransFusionConfig):
        if isinstance(cfg, CenterPointConfig):
            self.loss = centerpoint_loss
        elif isinstance(cfg, TransFusionConfig):
            self.loss = transfusion_loss
        else:
            raise ValueError(f"unsupported fused host config {type(cfg)}")
        super().__init__(cfg)

    def model_inputs(self, batch: dict) -> tuple:
        return batch["images"], batch["proj"]

    def unreached(self, model) -> set[int]:
        """The fusion's last dual-query layer's image-only parameters
        (`ACTR.unreached_parameters`)."""
        return {id(p) for m in model.modules() if isinstance(m, ACTR)
                for p in m.unreached_parameters()}


def make_fused_train_step(cfg: CenterPointConfig | TransFusionConfig
                          ) -> FusedTrainStep:
    return FusedTrainStep(cfg)
