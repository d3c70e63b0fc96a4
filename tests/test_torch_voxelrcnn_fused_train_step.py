"""The whole Voxel R-CNN + 3D-DF training step (`voxel_rcnn_3ddf_kitti`'s
family), df3d_torch's `entry.build_voxelrcnn3ddf_trainer` step against the
JAX package at tests/test_fused_training.py's config (its Voxel R-CNN on
the +-16 m grid with training NMS 64 -> 16, one RoI scale at conv2, grid 2,
8 RoIs a sample; one 64x96 camera, the DeepLabV3 ResNet-50 taps at two
levels, MVX at stride 1, a tiny ACTRv2 with IFAT and LT; aux off) at batch
2: tests/test_torch_voxelrcnn_train_step.py's points, gts near the first
stage's own proposals and box kernel scale, seeded normalized images and
KITTI's front camera scaled to the image (`utils.synth.kitti_camera`),
`adam_onecycle(1e-3, 100)`, flax variables filled from seeded numpy and
carried across by `weights.train_state_from_flax`, the deformable
attention's offset and weight kernels at flax's initial zeros
(`initial_scales`).

The port is held against the JAX package's step composed with the
proposals' gradient stopped (`torch_port_helpers.voxelrcnn_stop_gradient_step`;
the port's proposals carry no gradient, as pcdet's): every log,
cap_overflow exactly, the proposal target layer's picks, every gradient
leaf (K2's backward among them: the deformable attention's value,
locations and weights), every batch statistic (IFAT's flax-style norms
moved, the frozen image branch's not) and every updated parameter, with
the tolerances of tests/test_torch_voxelrcnn_train_step.py; JAX's ReLU
decisions replayed where the port's disagree (at most 4, each within 1e-4
of 0). The JAX package's own step, which differs from the composition only
at the proposals, is held in tests/test_torch_voxelrcnn_train_step.py
(one more compile of this model would double this file's time).

The frozen image branch: the port keeps it out of the optimizer and
unchanged; JAX gives it zero gradients, and optax's `adamw` moves it by
-lr * weight_decay * p (ROADMAP section 3). The last dual-query layer's
image-side parameters, which the loss does not reach, get zero gradients
on both sides (`ACTR.unreached_parameters`)."""

import jax
import numpy as np
import pytest
import torch

from df3d.models.detectors.fused import FusedConfig as JFusedConfig
from df3d.models.detectors.fused import VoxelRCNN3DDF as JVoxelRCNN3DDF
from df3d.models.detectors.voxel_rcnn import VoxelRCNNConfig as JConfig
from df3d.models.fusion.actr import ACTRConfig as JACTRConfig
from df3d.models.heads import voxelrcnn_head as jrh
from df3d.ops.voxelize import voxelize_batch as jvoxelize_batch
from df3d_torch.entry import build_voxelrcnn3ddf_trainer
from df3d_torch.models.detectors.fused import FusedConfig
from df3d_torch.models.detectors.voxel_rcnn import VoxelRCNNConfig
from df3d_torch.models.fusion.actr import ACTRConfig
from df3d_torch.models.heads import voxelrcnn_head as trh
from df3d_torch.train.schedules import adam_onecycle
from df3d_torch.utils.synth import kitti_camera
from df3d_torch.weights import state_dict_from_flax, train_state_from_flax
from test_torch_voxelrcnn_train_step import GEOM, points_batch
from torch_port_helpers import (
    check_batch_stats, check_gradients, check_logs, check_relu_decisions,
    check_sampled, check_updated_parameters, gts_near_proposals,
    small_box_residuals, voxelrcnn_step_run, voxelrcnn_variables,
)

# tests/test_fused_training.py:104-113
HEAD = dict(grid_size=2, max_local=16, roi_per_image=8)
ACTR = dict(d_model=16, n_heads=2, n_points=2, n_levels=2, num_layers=1,
            dim_feedforward=32, lt_npoint=8, lt_nsample=4)
IMAGE = (64, 96)
FUSED = dict(image_shape=IMAGE, n_levels=2)
LR_MAX, TOTAL_STEPS, WEIGHT_DECAY = 1e-3, 100, 0.01


def initial_scales(names, v):
    """`small_box_residuals`, and the deformable attention's sampling-offset
    and attention-weight kernels as flax initialises them, at zero (their
    biases seeded). With seeded He kernels there, the image queries (the
    frozen random ResNet-50's taps reach ~350) put the attention logits
    near 450: the softmax saturates, and the forward's f32 rounding moves
    the gate and attention leaves' gradients past the tolerance (1.35x
    seen)."""
    if names[-2] in ("sampling_offsets", "attention_weights") \
            and names[-1] == "kernel":
        return v * 0.0
    return small_box_residuals(names, v)


def configs(config, rh):
    return config(**GEOM, rcnn=rh.VoxelRCNNHeadCfg(
        scales=(rh.RoIPoolScaleCfg("conv2", 2, 0.8, nsample=4),), **HEAD))


@pytest.fixture(scope="module")
def step_run():
    jcfg, tcfg = configs(JConfig, jrh), configs(VoxelRCNNConfig, trh)
    jmodel = JVoxelRCNN3DDF(jcfg, JFusedConfig(actr=JACTRConfig(**ACTR),
                                               **FUSED))
    jhead = jrh.VoxelRCNNHead(jcfg.rcnn, jcfg.voxel_size, jcfg.pc_range)
    batch = points_batch()
    b = batch["points"].shape[0]
    rng = np.random.RandomState(3)
    batch["images"] = rng.randn(b, *IMAGE, 3).astype(np.float32)
    batch["proj"] = np.broadcast_to(kitti_camera(IMAGE[1] / 1280.0),
                                    (b, 3, 4)).copy()
    res = jax.eval_shape(lambda p, v: jvoxelize_batch(
        p, v, jcfg.voxel_size, jcfg.pc_range, jcfg.grid_size,
        jcfg.max_voxels, jcfg.max_points_per_voxel),
        batch["points"], batch["points_valid"])
    variables = voxelrcnn_variables(
        jmodel, jhead, (res.features, res.coords, batch["images"],
                        batch["proj"]),
        jcfg.rcnn.roi_per_image, seed=1, out_scale=initial_scales)
    fcfg = FusedConfig(actr=ACTRConfig(**ACTR), **FUSED)
    state, step = build_voxelrcnn3ddf_trainer(tcfg, fcfg, "cpu")
    state = train_state_from_flax(state.model, variables["params"],
                                  variables["batch_stats"],
                                  adam_onecycle(LR_MAX, TOTAL_STEPS))
    batch.update(gts_near_proposals(state.model, step, batch))
    return voxelrcnn_step_run(jmodel, jhead, jcfg, state, step, batch,
                              variables, LR_MAX, TOTAL_STEPS,
                              with_package_step=False)


def test_relu_decisions(step_run):
    """The port's ReLUs disagree with JAX's on a few elements at most, each
    within 1e-4 of 0 (rounding, not a different function)."""
    check_relu_decisions(step_run)


def test_logs(step_run):
    check_logs(step_run, step_run["jlogs"])


def test_sampled_rois(step_run):
    check_sampled(step_run)


def test_every_trainable_gradient_leaf(step_run):
    """Every leaf the port trains against the stop-gradient composition's
    gradient; the frozen image branch is not in the port's state and has
    zero gradients in JAX; the fusion's leaves have a gradient."""
    r = step_run
    check_gradients(r, r["new"].opt_state[0])
    hook = "rpn.detector.backbone.fusion_hook."
    for part in ("mvx_proj", "ifat", "actr"):
        assert any(g.abs().sum() > 0 for n, g in r["grads"].items()
                   if n.startswith(hook + part)), part


def test_batch_stats_after_step(step_run):
    moved = check_batch_stats(step_run, step_run["new"])
    assert any(".ifat." in k for k in moved)
    assert not any(k.startswith("rpn.image_branch.") for k in moved)


def test_updated_parameters(step_run):
    check_updated_parameters(step_run)


def test_frozen_image_branch(step_run):
    """The port's image branch is unchanged by the step and stays in eval
    mode; JAX's moves by -lr * weight_decay * p."""
    r = step_run
    model = r["model"]
    assert model.rpn.detector.training and not model.rpn.image_branch.training
    want = state_dict_from_flax(model, {
        "params": r["new"].params, "batch_stats": r["new"].batch_stats})
    lr0 = float(r["state"].tx.lr(0))
    frozen = [n for n, _ in model.named_parameters()
              if n.startswith("rpn.image_branch.")]
    assert frozen
    for name in frozen:
        p0 = r["before"][name]
        assert torch.equal(model.state_dict()[name], p0), name
        np.testing.assert_allclose(want[name].numpy(),
                                   (p0 * (1 - lr0 * WEIGHT_DECAY)).numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)
