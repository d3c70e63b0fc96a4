"""The whole Voxel R-CNN training step (`voxel_rcnn_car_kitti`'s family,
LiDAR only), df3d_torch's `entry.build_voxelrcnn_trainer` step against the
JAX package at tests/test_train_steps.py's config (the +-16 m grid, caps
256/192/128/96, training NMS 64 -> 16, one RoI scale, grid 3, 8 RoIs a
sample) at batch 2: that test's 300 points per sample over the grid, three
gt cars a sample near the first stage's own proposals (so that RoIs reach the
regression threshold; one of them anti-aligned) and a padding slot,
`adam_onecycle(1e-3, 100)`, flax variables filled from seeded numpy and
carried across by `weights.train_state_from_flax`, both stages' box
kernels at a tenth of the seeded scale (`small_box_residuals`).

The proposals carry no gradient in the port, as in pcdet (its proposal and
proposal target layers run under `torch.no_grad()`); the JAX package's
`make_voxelrcnn_train_step` differentiates through them, so that the RCNN
losses reach the RPN's box branch (ROADMAP section 3). Both JAX steps run
in one jitted program: the package's own step, and the same step composed
in `torch_port_helpers.voxelrcnn_stop_gradient_step` from the package's
functions with the proposals' gradient stopped. The port is held against
the composed step on everything; against the package's step on the logs,
the RCNN head's gradient leaves and every batch statistic; and the two JAX
steps differ on the RPN's leaves, beyond the tolerance.

The proposals carry no gradient, so the port's second stage reads JAX's,
as it reads JAX's noise draws, and the port's own proposals are held
against them (`torch_port_helpers.voxelrcnn_step_run`).

Exact: cap_overflow, roi_mask, the proposal target layer's picks (RoIs,
gts, mask, reg_valid). Tolerances of
tests/test_torch_fused_train_step.py: per leaf, atol = 1e-4 * max|ref| +
1e-6 on every gradient leaf (recorded by a pass-through transform ahead of
the optimizer), on the batch statistics after the step and on the updated
parameters, plus Adam's first-step jump lr * |u(g + t) - u(g - t)|; logs
rtol 1e-5.

ReLU decisions: each of the port's ReLUs takes JAX's decision where the two
disagree (the composed step returns its ReLU inputs;
`torch_port_helpers.replayed_relus`), at most 4 elements, each within 1e-4
of 0 (`test_relu_decisions`)."""

import jax
import numpy as np
import pytest

from df3d.models.detectors.voxel_rcnn import VoxelRCNN as JVoxelRCNN
from df3d.models.detectors.voxel_rcnn import VoxelRCNNConfig as JConfig
from df3d.models.heads import voxelrcnn_head as jrh
from df3d.ops.voxelize import voxelize_batch as jvoxelize_batch
from df3d_torch.entry import build_voxelrcnn_trainer
from df3d_torch.models.detectors.voxel_rcnn import VoxelRCNNConfig
from df3d_torch.models.heads import voxelrcnn_head as trh
from df3d_torch.train.schedules import adam_onecycle
from df3d_torch.weights import train_state_from_flax
from torch_port_helpers import (
    check_batch_stats, check_gradients, check_logs, check_package_step,
    check_relu_decisions, check_sampled, check_updated_parameters,
    gts_near_proposals, small_box_residuals, voxelrcnn_step_run,
    voxelrcnn_variables,
)
from torch_port_helpers import one_torch_thread  # noqa: F401

# tests/test_train_steps.py's Voxel R-CNN config
GEOM = dict(pc_range=(0.0, -16.0, -2.4, 32.0, 16.0, 2.4),
            voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64),
            max_voxels=256, num_point_features=4,
            stage_caps=(256, 192, 128, 96), train_pre_nms=64,
            train_post_nms=16)
HEAD = dict(grid_size=3, max_local=32, roi_per_image=8)
LR_MAX, TOTAL_STEPS = 1e-3, 100


def configs(config, rh):
    return config(**GEOM, rcnn=rh.VoxelRCNNHeadCfg(
        scales=(rh.RoIPoolScaleCfg("conv3", 4, 1.6, nsample=4),), **HEAD))


def points_batch(b=2, n=300):
    """Seeded points over the grid, numpy: tests/test_train_steps.py's 300
    a sample (the voxel cap of 256 drops some)."""
    rng = np.random.RandomState(0)
    points = np.concatenate([rng.uniform(0, 31, (b, n, 1)),
                             rng.uniform(-15, 15, (b, n, 1)),
                             rng.uniform(-1.8, 1.8, (b, n, 1)),
                             rng.uniform(0, 1, (b, n, 1))], -1)
    return {"points": points.astype(np.float32),
            "points_valid": np.ones((b, n), bool)}


@pytest.fixture(scope="module")
def step_run():
    jcfg, tcfg = configs(JConfig, jrh), configs(VoxelRCNNConfig, trh)
    jmodel = JVoxelRCNN(jcfg)
    jhead = jrh.VoxelRCNNHead(jcfg.rcnn, jcfg.voxel_size, jcfg.pc_range)
    batch = points_batch()
    res = jax.eval_shape(lambda p, v: jvoxelize_batch(
        p, v, jcfg.voxel_size, jcfg.pc_range, jcfg.grid_size,
        jcfg.max_voxels, jcfg.max_points_per_voxel),
        batch["points"], batch["points_valid"])
    variables = voxelrcnn_variables(jmodel, jhead,
                                    (res.features, res.coords),
                                    jcfg.rcnn.roi_per_image, seed=1,
                                    out_scale=small_box_residuals)
    state, step = build_voxelrcnn_trainer(tcfg, "cpu")
    state = train_state_from_flax(state.model, variables["params"],
                                  variables["batch_stats"],
                                  adam_onecycle(LR_MAX, TOTAL_STEPS))
    batch.update(gts_near_proposals(state.model, step, batch))
    return voxelrcnn_step_run(jmodel, jhead, jcfg, state, step, batch,
                              variables, LR_MAX, TOTAL_STEPS)


def test_relu_decisions(step_run):
    """The port's ReLUs disagree with JAX's on a few elements at most, each
    within 1e-4 of 0 (rounding, not a different function)."""
    check_relu_decisions(step_run)


def test_logs(step_run):
    check_logs(step_run, step_run["jlogs"])


def test_sampled_rois(step_run):
    check_sampled(step_run)


def test_every_gradient_leaf(step_run):
    """Every leaf against the stop-gradient composition's gradient."""
    check_gradients(step_run, step_run["new"].opt_state[0])


def test_batch_stats_after_step(step_run):
    check_batch_stats(step_run, step_run["new"])


def test_updated_parameters(step_run):
    check_updated_parameters(step_run)


def test_package_step_differs_only_by_the_proposals(step_run):
    """The JAX package's own step agrees with the port on the logs, the
    batch statistics and the RCNN head's leaves, and sends the RCNN losses
    into the RPN's box branch through the proposals, which the port (and
    pcdet) do not."""
    check_package_step(step_run)
