"""The whole CenterPoint + 3D-DF training step, df3d_torch against one
jitted df3d.train.trainer.make_fused_train_step (aux off): the config of
tests/test_torch_fused_slice.py (`__graft_entry__._mesh_cfg()`-sized LiDAR,
2 cameras of 32x48, DeepLabV3 taps on one-block ResNet stages, a tiny
ACTRv2 with IFAT and LT) at batch 2, the gt layout of
tests/test_torch_train_step.py (four equal boxes of class 0 per sample),
4096 points per sample over the grid, seeded images and the rig of
`utils.synth.camera_rig`, `adam_onecycle(1e-3, 100)`, flax variables filled
from seeded numpy and carried across by df3d_torch.weights.

Tolerances, those of tests/test_torch_train_step.py: per leaf, atol =
1e-4 * max|ref| + 1e-6 (f32, other summation order) on every trainable
gradient leaf (the reference's raw gradients, recorded by a pass-through
transform chained before the optimizer), on the batch statistics after
the step (IFAT's and the detector's moved, the frozen image branch's not)
and on the updated parameters, plus Adam's first-step jump lr * |u(g + t)
- u(g - t)| with u(g) = g / (|g| + eps) and t the gradient's tolerance.
Exact: cap_overflow. Loss and per-task logs: rtol 1e-5.

ReLU decisions in the neck. The two forwards agree to ~1e-5 of the
values, and the neck's small maps (2 x 8 x 8 and 2 x 4 x 4 at 128 and 256
channels) hold a few BatchNorm outputs closer to 0 than that: a ReLU there
passes the gradient on one side and not on the other, and every leaf
upstream moves by up to a few percent (seen: 2 such elements, |z| <= 4.1e-6;
both steps stay put when their own input moves by an ulp). So the port's
neck takes JAX's decision wherever the two disagree: JAX's BatchNorm outputs
ahead of each neck ReLU come from the same training-mode forward
(`capture_intermediates`, in one jitted program with the step), and a
forward hook on each neck BatchNorm gives a disagreeing element JAX's sign
at its own magnitude, with the gradient passed through unchanged. `test_neck_relu_decisions` holds that to a few
elements, each within 1e-4 of 0.

The frozen image branch: JAX gives it zero gradients, but optax's `adamw`
decays every leaf, so its step moves the branch by -lr * weight_decay * p
(a fault of the JAX package, ROADMAP section 3); the port keeps the branch
out of the optimizer and leaves it unchanged. Both are asserted."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from df3d.models.detectors.centerpoint import CenterPointConfig as JConfig
from df3d.models.detectors.fused import CenterPoint3DDF as JCenterPoint3DDF
from df3d.models.detectors.fused import FusedConfig as JFusedConfig
from df3d.models.fusion.actr import ACTRConfig as JACTRConfig
from df3d.ops.voxelize import voxelize_batch as jvoxelize_batch
from df3d.train.schedules import adam_onecycle as jadam_onecycle
from df3d.train.trainer import TrainState as JTrainState
from df3d.train.trainer import make_fused_train_step as jmake_step
from df3d_torch.models.detectors.centerpoint import CenterPointConfig
from df3d_torch.models.detectors.fused import CenterPoint3DDF, FusedConfig
from df3d_torch.models.detectors.transfusion import TransFusionConfig
from df3d_torch.models.fusion.actr import ACTRConfig
from df3d_torch.train.schedules import adam_onecycle, global_norm
from df3d_torch.train.trainer import make_fused_train_step
from df3d_torch.utils.synth import camera_rig
from df3d_torch.weights import (
    params_from_flax, state_dict_from_flax, train_state_from_flax,
)
from torch_port_helpers import seeded_variables

# tests/test_torch_fused_slice.py's config
CFG = dict(
    pc_range=(-16.0, -16.0, -2.4, 16.0, 16.0, 2.4),
    voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64),
    max_voxels=256, num_point_features=5, stage_caps=(256, 128, 96, 64),
    tasks=(1, 2), max_objs=8, nms_pre_max_size=32, nms_post_max_size=4,
    post_center_range=(-20.0, -20.0, -4.0, 20.0, 20.0, 4.0),
)
ACTR = dict(d_model=16, n_heads=2, n_points=2, n_levels=2, num_layers=1,
            dim_feedforward=32, lt_npoint=8, lt_nsample=4,
            model_name="ACTRv2", q_method="gating",
            attn_layer="BiGateSum1D_2")
FUSED = dict(image_shape=(32, 48), image_branch="deeplabv3",
             image_layers=(1, 1, 1, 1), n_levels=2, num_cams=2,
             use_ifat=True, fusion_downsample=8)
LR_MAX, TOTAL_STEPS, WEIGHT_DECAY = 1e-3, 100, 0.01


def _hm_prior(names, v):
    """The heatmap branch's last conv as flax initialises it: its bias at
    the -2.19 prior (and a small kernel), so the logits start near it."""
    if "_hm" in "".join(names) and names[-2] == "Conv_1":
        return v * 0.1 if names[-1] == "kernel" else v - 2.19
    return v


def _batch(b=2, n=4096, half=15.0):
    rng = np.random.RandomState(0)
    points = np.concatenate([rng.uniform(-half, half, (b, n, 2)),
                             rng.uniform(-1.8, 1.8, (b, n, 1)),
                             rng.uniform(0, 1, (b, n, 2))], -1)
    box = np.array([1.0, 2.0, 0.0, 4.0, 2.0, 1.5, 0.3, 0.0, 0.0], np.float32)
    gt_valid = np.zeros((b, 8), bool)
    gt_valid[:, :4] = True
    nc, hw = FUSED["num_cams"], FUSED["image_shape"]
    return {"points": points.astype(np.float32),
            "points_valid": np.ones((b, n), bool),
            "gt_boxes": np.tile(box, (b, 8, 1)),
            "gt_classes": np.zeros((b, 8), np.int32), "gt_valid": gt_valid,
            "images": rng.randn(b, nc, *hw, 3).astype(np.float32),
            "proj": np.broadcast_to(camera_rig(nc, hw),
                                    (b, nc, 3, 4)).copy()}


def _record_grads():
    """A pass-through transform whose state is the gradients it saw."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def step_run():
    batch = _batch()
    jcfg = JConfig(**CFG)
    jmodel = JCenterPoint3DDF(
        jcfg, JFusedConfig(actr=JACTRConfig(**ACTR), **FUSED))

    def init(points, images, proj):
        res = jvoxelize_batch(points, jnp.ones(points.shape[:2], bool),
                              jcfg.voxel_size, jcfg.pc_range, jcfg.grid_size,
                              jcfg.max_voxels, jcfg.max_points_per_voxel)
        return jmodel.init(jax.random.PRNGKey(0), res.features, res.coords,
                           images, proj, train=False)

    shapes = jax.eval_shape(init, *(jnp.asarray(batch[k][:1])
                                    for k in ("points", "images", "proj")))
    variables = seeded_variables(shapes, np.random.RandomState(1), _hm_prior)
    tx = optax.chain(_record_grads(), jadam_onecycle(LR_MAX, TOTAL_STEPS))
    jstate = JTrainState.create(apply_fn=jmodel.apply,
                                params=variables["params"], tx=tx,
                                batch_stats=variables["batch_stats"])
    (new, jlogs), neck = _jax_step_and_neck(jmodel, jcfg)(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()})
    new = jax.tree_util.tree_map(np.asarray, new)

    cfg = CenterPointConfig(**CFG)
    fcfg = FusedConfig(actr=ACTRConfig(**ACTR), **FUSED)
    model = CenterPoint3DDF(cfg, fcfg)
    state = train_state_from_flax(model, variables["params"],
                                  variables["batch_stats"],
                                  adam_onecycle(LR_MAX, TOTAL_STEPS))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_fused_train_step(cfg)
    flips = []
    blocks = model.detector.neck.blocks
    handles = [blocks[name].bn.register_forward_hook(_jax_decision(
        torch.from_numpy(np.array(z)).permute(0, 3, 1, 2), name, flips))
        for name, z in neck.items()]
    logs, grads = step.grads(state, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    for h in handles:
        h.remove()
    grads = dict(zip(state.param_names, [g.clone() for g in grads]))
    state = step.apply(state, list(grads.values()))
    return dict(model=model, state=state, logs=logs, grads=grads, new=new,
                jlogs={k: np.asarray(v) for k, v in jlogs.items()},
                before=before, variables=variables, flips=flips)


def _jax_step_and_neck(jmodel, jcfg):
    """One jitted program: the JAX training step, and {neck block: its
    BatchNorm output ahead of the ReLU, NHWC} from the training-mode
    forward of the same state and batch (`capture_intermediates`)."""
    step = jmake_step(jmodel, jcfg)

    @jax.jit
    def run(state, batch):
        r = jvoxelize_batch(batch["points"], batch["points_valid"],
                            jcfg.voxel_size, jcfg.pc_range, jcfg.grid_size,
                            jcfg.max_voxels, jcfg.max_points_per_voxel)
        _, inter = jmodel.apply(
            {"params": state.params, "batch_stats": state.batch_stats},
            r.features, r.coords, batch["images"], batch["proj"],
            train=True, mutable=["batch_stats", "intermediates"],
            capture_intermediates=True)
        neck = inter["intermediates"]["detector"]["neck"]
        return step(state, batch), {
            name: block["BatchNorm_0"]["__call__"][0]
            for name, block in neck.items() if name != "__call__"}

    return run


def _jax_decision(jax_z, name, flips):
    """A forward hook for a neck BatchNorm: where its output and JAX's
    (`jax_z`) lie on two sides of 0, the output takes JAX's sign at its own
    magnitude; the gradient passes through unchanged. Records (block,
    elements, their largest |z|) in `flips`."""
    def hook(module, inputs, out):
        z = out.detach()
        flip = (z > 0) != (jax_z > 0)
        if not flip.any():
            return out
        flips.append((name, int(flip.sum()), float(z[flip].abs().max())))
        signed = torch.where(jax_z > 0, z.abs(), -z.abs())
        return torch.where(flip, out - z + signed, out)
    return hook


def _tol(ref):
    return 1e-4 * np.abs(ref).max() + 1e-6


def _frozen(name):
    return name.startswith("image_branch.")


def test_neck_relu_decisions(step_run):
    """The neck's ReLUs disagree with JAX's on a few elements at most, each
    within 1e-4 of 0 (rounding, not a different function)."""
    flips = step_run["flips"]
    assert sum(n for _, n, _ in flips) <= 4, flips
    assert all(z < 1e-4 for _, _, z in flips), flips


def test_logs(step_run):
    r = step_run
    assert set(r["logs"]) == set(r["jlogs"])
    assert int(r["logs"]["cap_overflow"]) == int(r["jlogs"]["cap_overflow"])
    assert int(r["jlogs"]["cap_overflow"]) > 0  # the caps drop rows here
    for k, v in r["jlogs"].items():
        if k != "cap_overflow":
            np.testing.assert_allclose(r["logs"][k].item(), v, rtol=1e-5,
                                       err_msg=k)
    assert r["state"].step == 1


def test_every_trainable_gradient_leaf(step_run):
    """Every leaf the port trains against JAX's gradient; the frozen image
    branch is not in the port's state and has zero gradients in JAX."""
    r = step_run
    want = params_from_flax(r["model"], r["new"].opt_state[0])
    trainable = {n for n in want if not _frozen(n)}
    assert trainable == set(r["grads"])
    assert set(want) - trainable  # the image branch is carried, not trained
    for name in set(want) - trainable:
        assert not want[name].any(), name
    for name, g in r["grads"].items():
        ref = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=_tol(ref),
                                   err_msg=name)


def test_batch_stats_after_step(step_run):
    r = step_run
    want = state_dict_from_flax(r["model"], {
        "params": r["new"].params, "batch_stats": r["new"].batch_stats})
    got = r["model"].state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    moved = [k for k in stats
             if not torch.equal(want[k], r["before"][k])]
    assert any(".ifat." in k for k in moved)
    assert not any(_frozen(k) for k in moved)
    for k in stats:
        ref = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=0,
                                   atol=_tol(ref), err_msg=k)


def test_updated_parameters(step_run):
    r = step_run
    want = state_dict_from_flax(r["model"], {
        "params": r["new"].params, "batch_stats": r["new"].batch_stats})
    ref_grads = params_from_flax(r["model"], r["new"].opt_state[0])
    norm = float(global_norm(list(ref_grads.values())))
    clip = min(1.0, 10.0 / norm)
    lr0, eps = float(r["state"].tx.lr(0)), 1e-8

    def u(g):  # Adam's first update direction for a clipped gradient g
        return g / (np.abs(g) + eps)

    for name, p in r["model"].named_parameters():
        if _frozen(name):
            continue
        ref, g = want[name].numpy(), ref_grads[name].numpy() * clip
        t = _tol(ref_grads[name].numpy()) * clip
        atol = _tol(ref) + lr0 * np.abs(u(g + t) - u(g - t))
        err = np.abs(p.detach().numpy() - ref)
        assert (err <= atol).all(), (name, float((err - atol).max()))


def test_frozen_image_branch(step_run):
    """The port's image branch is unchanged by the step and stays in eval
    mode; JAX's moves by -lr * weight_decay * p (optax's adamw decays the
    zero-gradient leaves too)."""
    r = step_run
    model = r["model"]
    assert model.detector.training and not model.image_branch.training
    want = state_dict_from_flax(model, {
        "params": r["new"].params, "batch_stats": r["new"].batch_stats})
    lr0 = float(r["state"].tx.lr(0))
    frozen = [n for n, _ in model.named_parameters() if _frozen(n)]
    assert frozen and not any(p.requires_grad
                              for p in model.image_branch.parameters())
    for name in frozen:
        p0 = r["before"][name]
        assert torch.equal(model.state_dict()[name], p0), name
        np.testing.assert_allclose(want[name].numpy(),
                                   (p0 * (1 - lr0 * WEIGHT_DECAY)).numpy(),
                                   rtol=1e-6, atol=1e-9, err_msg=name)


def test_transfusion_host_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        make_fused_train_step(TransFusionConfig())
