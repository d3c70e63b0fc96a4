"""The CenterPoint training step (port of df3d/train/trainer.py:23-75).

One step: voxelize -> forward in training mode (batch statistics, the
running ones moved) -> `centerpoint_loss` -> gradients by autograd (the
sparse convs' input gradients are K1 launches on the card) -> clip +
AdamW with OneCycle. The JAX package's step is a pure function of its
state; here the model holds the parameters and batch statistics, and the
step updates them and the optimizer moments in place, which keeps one copy
of each on the card.
"""

from __future__ import annotations

import dataclasses

import torch

from df3d_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointConfig, cap_overflow_total, centerpoint_loss,
)
from df3d_torch.ops.voxelize import voxelize_batch
from df3d_torch.train.schedules import AdamOneCycle, AdamState
from df3d_torch.utils import stages


@dataclasses.dataclass
class TrainState:
    """The counterpart of the JAX package's `TrainState`: the model (its
    parameters and batch statistics), the optimizer and its moments, and the
    number of steps taken."""

    model: CenterPoint
    tx: AdamOneCycle
    opt_state: AdamState
    step: int = 0

    @property
    def params(self) -> list[torch.Tensor]:
        return list(self.model.parameters())


def create_centerpoint_state(model: CenterPoint,
                             tx: AdamOneCycle) -> TrainState:
    """A state for `model` as it stands (random or carried weights), with
    the optimizer moments at zero, as `TrainState.create` leaves them."""
    return TrainState(model, tx, tx.init(list(model.parameters())))


class CenterPointTrainStep:
    """`step(state, batch) -> (state, logs)`.

    batch: points (B, P, F), points_valid (B, P), gt_boxes (B, M, 9),
    gt_classes (B, M) global class ids, gt_valid (B, M). logs: per task
    `task{t}_hm_loss` and `task{t}_loc_loss`, `loss` and `cap_overflow`, as
    0-d tensors on the model's device. `grads` and `apply` are the step's two
    halves."""

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
        preds, _, overflow = model(res.features, res.coords)
        total, logs = centerpoint_loss(cfg, preds, batch["gt_boxes"],
                                       batch["gt_classes"], batch["gt_valid"])
        logs["cap_overflow"] = cap_overflow_total(overflow)
        stages.mark("loss")
        grads = torch.autograd.grad(total, state.params)
        stages.mark("backward")
        return {k: v.detach() for k, v in logs.items()}, list(grads)

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
