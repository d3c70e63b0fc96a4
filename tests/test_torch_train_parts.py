"""The training step's parts, df3d_torch against df3d on the same seeded
inputs: CenterPoint targets (df3d.core.target_utils and the head's task
split), the focal and L1 losses with their gradients, the training-mode
norms (output, gradient and batch statistics after the update), and the
OneCycle AdamW against optax.

Tolerances (f32): integer target outputs (inds, mask, cats) and the radius
floor exact; heatmap, anno_box atol 1e-6, radii rtol = atol = 1e-6; losses
rtol 1e-6 and their gradients atol 1e-6 * max|ref|; norms atol 1e-5 (outputs, input
gradients) and 1e-6 (batch statistics); optimizer parameters and schedules
rtol 1e-6. The frozen image branch of the fused model: exact (no gradient,
no change)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import linen as fnn

from df3d.core import target_utils as jtu
from df3d.models import layers as jlayers
from df3d.models import losses as jlosses
from df3d.models.heads.center_head import (
    center_head_targets as jcenter_head_targets,
)
from df3d.train import schedules as jsched
from df3d_torch.core import target_utils as ttu
from df3d_torch.entry import build_centerpoint3ddf_trainer
from df3d_torch.models import losses as tlosses
from df3d_torch.models.heads.center_head import center_head_targets
from df3d_torch.models.layers import FlaxBatchNorm2d, MaskedBatchNorm
from df3d_torch.models.detectors.centerpoint import CenterPointConfig
from df3d_torch.models.detectors.fused import FusedConfig
from df3d_torch.models.fusion.actr import ACTRConfig
from df3d_torch.train import schedules as tsched
from df3d_torch.utils.synth import camera_rig
from torch_port_helpers import one_torch_thread  # noqa: F401

FEATURE_SIZE = (16, 20)       # (H, W)
VOXEL, RANGE, STRIDE = (0.5, 0.4), (-4.0, -3.0), 2


def _boxes(rng, b, m):
    """Boxes over the map and around its edges (not its left edge: see
    test_draw_gaussians_left_edge), tiny ones at the radius floor, one
    outside the map, one of zero width."""
    x_hi = RANGE[0] + FEATURE_SIZE[1] * STRIDE * VOXEL[0]
    y_hi = RANGE[1] + FEATURE_SIZE[0] * STRIDE * VOXEL[1]
    boxes = np.zeros((b, m, 9), np.float32)
    boxes[..., 0] = rng.uniform(RANGE[0] + 2.0, x_hi + 0.5, (b, m))
    boxes[..., 1] = rng.uniform(RANGE[1] - 0.5, y_hi + 0.5, (b, m))
    boxes[..., 2] = rng.randn(b, m)
    boxes[..., 3:6] = rng.uniform(0.1, 4.0, (b, m, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, m))
    boxes[..., 7:9] = rng.randn(b, m, 2)
    boxes[:, 0, 3:5] = 0.05                      # radius floor
    boxes[:, 1, 0] = x_hi + 3.0                  # off the map
    boxes[:, 2, 3] = 0.0                         # zero width
    boxes[:, 3, :2] = (x_hi - 0.1, y_hi - 0.1)   # bottom-right corner
    return boxes


def _targets_inputs(seed=0, b=2, m=12, n_classes=5):
    rng = np.random.RandomState(seed)
    classes = rng.randint(0, n_classes, (b, m)).astype(np.int32)
    valid = rng.rand(b, m) > 0.2
    return _boxes(rng, b, m), classes, valid


def _check_targets(got, want):
    for k in ("inds", "mask", "cats"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    for k in ("heatmap", "anno_box"):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=0, atol=1e-6, err_msg=k)


def test_assign_center_targets():
    """Against the JAX function run eagerly: under jit XLA rounds a box's
    pixel position 1 ulp apart, which moves anno_box's offset by ~2e-6."""
    boxes, classes, valid = _targets_inputs(m=20, n_classes=2)
    kw = dict(num_classes=2, feature_size=FEATURE_SIZE, voxel_size=VOXEL,
              pc_range=RANGE, out_size_factor=STRIDE, max_objs=24)
    got = ttu.assign_center_targets(*map(torch.from_numpy,
                                         (boxes, classes, valid)), **kw)
    want = jax.vmap(lambda bx, c, v: jtu.assign_center_targets(
        bx, c, v, **kw))(*map(jnp.asarray, (boxes, classes, valid)))
    _check_targets(got, want)
    assert got["mask"].sum() > 4 and got["heatmap"].max() == 1.0


def test_center_head_targets_task_split():
    """Global class ids split into the tasks' contiguous slices."""
    boxes, classes, valid = _targets_inputs(seed=1, m=20, n_classes=5)
    tasks = (1, 2, 2)
    args = (tasks, FEATURE_SIZE, VOXEL, RANGE, STRIDE, 0.1, 2, 24)
    got = center_head_targets(*map(torch.from_numpy,
                                   (boxes, classes, valid)), *args)
    want = jcenter_head_targets(*map(jnp.asarray, (boxes, classes, valid)),
                                *args)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _check_targets(g, w)
        assert g["mask"].any()


def test_gaussian_radius_near_the_floor():
    """Radii of boxes from 0.05 to 30 pixels: values to rtol = atol = 1e-6
    and the floored radius (max(2, floor(r))) equal, where r crosses 1, 2
    and 3."""
    sizes = np.linspace(0.05, 30.0, 4001).astype(np.float32)
    h, w = np.meshgrid(sizes[::40], sizes, indexing="ij")
    for overlap in (0.1, 0.5):
        want = np.asarray(jax.jit(jtu.gaussian_radius, static_argnums=2)(
            jnp.asarray(h), jnp.asarray(w), overlap))
        got = ttu.gaussian_radius(torch.from_numpy(h), torch.from_numpy(w),
                                  overlap).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(np.maximum(2, np.floor(got)),
                                      np.maximum(2, np.floor(want)))
        assert want.min() < 1 and want.max() > 3


def test_draw_gaussians_left_edge():
    """A window cell left of the map is dropped here; the JAX package sends
    it to row H of its padded buffer, the last map row's far end. Every
    other cell agrees."""
    centers = np.array([[0.2, 5.0], [7.0, 11.6], [11.4, 0.3]], np.float32)
    radii = np.array([3.0, 2.0, 4.0], np.float32)
    valid = np.array([True, True, True])
    want = np.asarray(jtu.draw_gaussians(
        jnp.zeros((10, 12)), *map(jnp.asarray, (centers, radii, valid))))
    got = ttu.draw_gaussians(torch.zeros(10, 12),
                             *map(torch.from_numpy,
                                  (centers, radii, valid))).numpy()
    leaked = np.zeros_like(want, bool)
    leaked[-1, -3:] = True      # x = -3..-1 of the first gaussian
    np.testing.assert_allclose(got[~leaked], want[~leaked], atol=1e-6)
    assert (want[leaked] > 0).all() and not got[leaked].any()
    assert got[5, 0] == 1.0


def _loss_inputs(seed, b=2, hw=48, c=3, m=6, n_pos=None):
    rng = np.random.RandomState(seed)
    logits = rng.randn(b, hw, c).astype(np.float32) * 2
    target = np.clip(rng.rand(b, hw, c) ** 4, 0, 1).astype(np.float32)
    ind = rng.randint(0, hw, (b, m)).astype(np.int32)
    mask = rng.rand(b, m) > 0.4 if n_pos is None else np.zeros((b, m), bool)
    cat = rng.randint(0, c, (b, m)).astype(np.int32)
    reg = rng.randn(b, hw, 4).astype(np.float32)
    anno = rng.randn(b, m, 4).astype(np.float32)
    return logits, target, ind, mask, cat, reg, anno


@pytest.mark.parametrize("n_pos", [None, 0], ids=["positives", "no_positive"])
def test_losses_and_gradients(n_pos):
    logits, target, ind, mask, cat, reg, anno = _loss_inputs(3, n_pos=n_pos)
    assert mask.any() == (n_pos is None)

    def jfocal(x):
        return jlosses.fast_focal_loss(jlosses.clamped_sigmoid(x), target,
                                       ind, mask, cat)

    def jl1(r):
        return (jlosses.reg_l1_loss(r, ind, mask, anno) * jnp.arange(
            1.0, 5.0)).sum()

    tl, tr = (torch.from_numpy(a).requires_grad_(True) for a in (logits, reg))
    tind, tmask, tcat = (torch.from_numpy(a).long() if a.dtype != bool
                         else torch.from_numpy(a) for a in (ind, mask, cat))
    focal = tlosses.fast_focal_loss(tlosses.clamped_sigmoid(tl),
                                    torch.from_numpy(target), tind, tmask,
                                    tcat)
    l1_vec = tlosses.reg_l1_loss(tr, tind, tmask, torch.from_numpy(anno))
    l1 = (l1_vec * torch.arange(1.0, 5.0)).sum()
    (focal + l1).backward()
    for got, grad, fn, x in ((focal, tl.grad, jfocal, logits),
                             (l1, tr.grad, jl1, reg)):
        val, g = jax.jit(jax.value_and_grad(fn))(jnp.asarray(x))
        np.testing.assert_allclose(got.item(), float(val), rtol=1e-6)
        g = np.asarray(g)
        np.testing.assert_allclose(grad.numpy(), g, rtol=0,
                                   atol=1e-6 * np.abs(g).max() + 1e-12)
    np.testing.assert_allclose(
        l1_vec.detach().numpy(),
        np.asarray(jlosses.reg_l1_loss(reg, ind, mask, anno)), rtol=1e-6,
        atol=1e-9)


def _bn_close(tmod, upd, got_y, want_y, got_gx, want_gx):
    np.testing.assert_allclose(got_y, want_y, atol=1e-5)
    np.testing.assert_allclose(got_gx, want_gx, atol=1e-5)
    np.testing.assert_allclose(tmod.running_mean.numpy(),
                               np.asarray(upd["mean"]), atol=1e-6)
    np.testing.assert_allclose(tmod.running_var.numpy(),
                               np.asarray(upd["var"]), atol=1e-6)


def _affine(rng, c):
    return {"scale": (1 + 0.1 * rng.randn(c)).astype(np.float32),
            "bias": (0.1 * rng.randn(c)).astype(np.float32)}, {
        "mean": (0.1 * rng.randn(c)).astype(np.float32),
        "var": (0.5 + rng.rand(c)).astype(np.float32)}


def _load(tmod, params, stats):
    tmod.load_state_dict({
        "weight": torch.from_numpy(params["scale"]),
        "bias": torch.from_numpy(params["bias"]),
        "running_mean": torch.from_numpy(stats["mean"]),
        "running_var": torch.from_numpy(stats["var"])})
    return tmod.train()


def test_masked_batchnorm_training():
    """Biased variance over the valid rows, pooled over batch and rows;
    running statistics 0.99 old + 0.01 batch."""
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 40, 16) * 3 + 2).astype(np.float32)
    mask = rng.rand(2, 40) > 0.35
    dy = rng.randn(2, 40, 16).astype(np.float32)
    params, stats = _affine(rng, 16)
    jm = jlayers.MaskedBatchNorm()

    def f(xx):
        y, upd = jm.apply({"params": params, "batch_stats": stats}, xx,
                          jnp.asarray(mask), train=True,
                          mutable=["batch_stats"])
        return (y * dy).sum(), (y, upd["batch_stats"])

    (_, (want_y, upd)), want_gx = jax.jit(jax.value_and_grad(
        f, has_aux=True))(jnp.asarray(x))
    tmod = _load(MaskedBatchNorm(16), params, stats)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tmod(xt, torch.from_numpy(mask))
    (y * torch.from_numpy(dy)).sum().backward()
    _bn_close(tmod, upd, y.detach().numpy(), want_y, xt.grad.numpy(),
              want_gx)
    assert not y[~torch.from_numpy(mask)].any()


@pytest.mark.parametrize("eps", [1e-3, 1e-5], ids=["neck", "head"])
def test_flax_batchnorm2d_training(eps):
    """flax nn.BatchNorm(momentum 0.99): fast biased variance, running
    statistics 0.99 old + 0.01 batch; NCHW here, NHWC in flax."""
    rng = np.random.RandomState(5)
    x = (rng.randn(2, 5, 6, 8) * 2 + 1).astype(np.float32)
    dy = rng.randn(2, 5, 6, 8).astype(np.float32)
    params, stats = _affine(rng, 8)
    jm = fnn.BatchNorm(use_running_average=False, momentum=0.99, epsilon=eps)

    def f(xx):
        y, upd = jm.apply({"params": params, "batch_stats": stats}, xx,
                          mutable=["batch_stats"])
        return (y * dy).sum(), (y, upd["batch_stats"])

    (_, (want_y, upd)), want_gx = jax.jit(jax.value_and_grad(
        f, has_aux=True))(jnp.asarray(x))
    tmod = _load(FlaxBatchNorm2d(8, eps=eps), params, stats)
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_(True)
    y = tmod(xt)
    (y * torch.from_numpy(dy).permute(0, 3, 1, 2)).sum().backward()
    _bn_close(tmod, upd, y.detach().permute(0, 2, 3, 1).numpy(), want_y,
              xt.grad.permute(0, 2, 3, 1).numpy(), want_gx)
    with torch.no_grad():  # eval: the running statistics
        tmod.eval()
        want = fnn.BatchNorm(use_running_average=True, epsilon=eps).apply(
            {"params": params, "batch_stats": upd}, x)
        np.testing.assert_allclose(
            tmod(xt.detach()).permute(0, 2, 3, 1).numpy(), np.asarray(want),
            atol=1e-5)


def test_one_cycle_schedules():
    """lr and b1 at every step through warm-up, anneal and past the end."""
    for total in (5, 100):
        jl, jb = jsched.one_cycle_lr(1e-3, total), jsched.one_cycle_momentum(
            total)
        tl, tb = tsched.one_cycle_lr(1e-3, total), tsched.one_cycle_momentum(
            total)
        for step in range(total + 3):
            np.testing.assert_allclose(tl(step), np.asarray(jl(step)),
                                       rtol=1e-6)
            np.testing.assert_allclose(tb(step), np.asarray(jb(step)),
                                       rtol=1e-6)


def test_adam_onecycle_matches_optax():
    """Three steps over warm-up and anneal (5 steps in all) on a small tree
    whose gradient norm goes 3, 40 and 12: unclipped, then clipped twice;
    weight decay on every leaf, bias correction with the current b1."""
    rng = np.random.RandomState(6)
    params = {"w": rng.randn(3, 4).astype(np.float32),
              "b": rng.randn(5).astype(np.float32)}
    grads = []
    for norm in (3.0, 40.0, 12.0):
        g = {k: rng.randn(*v.shape).astype(np.float32) for k, v in
             params.items()}
        scale = norm / np.sqrt(sum((v ** 2).sum() for v in g.values()))
        grads.append({k: (v * scale).astype(np.float32) for k, v in g.items()})
    jtx = jsched.adam_onecycle(1e-2, 5)
    jp, jstate = jax.tree_util.tree_map(jnp.asarray, params), None
    jstate = jtx.init(jp)
    tx = tsched.adam_onecycle(1e-2, 5)
    tp = [torch.from_numpy(params[k].copy()) for k in ("w", "b")]
    tstate = tx.init(tp)
    for g in grads:
        upd, jstate = jtx.update(jax.tree_util.tree_map(jnp.asarray, g),
                                 jstate, jp)
        jp = optax.apply_updates(jp, upd)
        tx.update([torch.from_numpy(g[k]) for k in ("w", "b")], tstate, tp)
        for k, t in zip(("w", "b"), tp):
            np.testing.assert_allclose(t.numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    assert tstate.count == 3
    # the norm-40 step's update is the same as that of its gradient
    # scaled to norm 10, and not of the gradient itself
    assert tsched.global_norm([torch.from_numpy(v) for v in
                               grads[1].values()]).item() > 10


def _small_fused_trainer():
    """A tiny CenterPoint + 3D-DF trainer on the CPU and one batch for it."""
    cfg = CenterPointConfig(
        pc_range=(-16.0, -16.0, -2.4, 16.0, 16.0, 2.4),
        voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64), max_voxels=256,
        stage_caps=(256, 128, 96, 64), tasks=(1, 2), max_objs=8)
    fcfg = FusedConfig(
        image_shape=(32, 48), image_layers=(1, 1, 1, 1), n_levels=2,
        num_cams=2, actr=ACTRConfig(d_model=16, n_heads=2, n_points=2,
                                    n_levels=2, dim_feedforward=32,
                                    lt_npoint=8, lt_nsample=4))
    state, step = build_centerpoint3ddf_trainer(cfg, fcfg, "cpu", seed=0)
    rng = np.random.RandomState(0)
    points = np.concatenate([rng.uniform(-15, 15, (2, 2048, 2)),
                             rng.uniform(-1.8, 1.8, (2, 2048, 1)),
                             rng.uniform(0, 1, (2, 2048, 2))], -1)
    box = np.array([1.0, 2.0, 0.0, 4.0, 2.0, 1.5, 0.3, 0.0, 0.0])
    batch = {"points": torch.tensor(points, dtype=torch.float32),
             "points_valid": torch.ones(2, 2048, dtype=torch.bool),
             "gt_boxes": torch.tensor(np.tile(box, (2, 4, 1)),
                                      dtype=torch.float32),
             "gt_classes": torch.zeros(2, 4, dtype=torch.long),
             "gt_valid": torch.ones(2, 4, dtype=torch.bool),
             "images": torch.tensor(rng.randn(2, 2, 32, 48, 3),
                                    dtype=torch.float32),
             "proj": torch.tensor(np.broadcast_to(camera_rig(2, (32, 48)),
                                                  (2, 2, 3, 4)).copy())}
    return state, step, batch


def test_frozen_image_branch():
    """CenterPoint + 3D-DF's image branch is frozen: after `.train()` the
    branch is still in eval mode (its running statistics unmoved by a
    step), its parameters need no gradient and are not in
    `create_train_state(...).params`; the rest of the model trains, and a
    training step leaves the branch as it was."""
    state, step, batch = _small_fused_trainer()
    model = state.model
    branch = model.image_branch
    assert model.training and model.detector.training
    assert not any(m.training for m in branch.modules())
    frozen = {id(p) for p in branch.parameters()}
    assert frozen and not any(p.requires_grad for p in branch.parameters())
    assert not frozen & {id(p) for p in state.params}
    assert len(state.params) == sum(
        1 for p in model.parameters() if id(p) not in frozen)
    assert not any(n.startswith("image_branch.") for n in state.param_names)

    before = {k: v.clone() for k, v in model.state_dict().items()}
    state, logs = step(state, batch)
    assert np.isfinite(float(logs["loss"]))
    after = model.state_dict()
    for k, v in before.items():
        if k.startswith("image_branch."):
            assert torch.equal(after[k], v), k
    assert any(not torch.equal(after[k], v) for k, v in before.items()
               if k.startswith("detector."))


def test_fused_step_unreached_leaves():
    """The fused step's loss reaches every trainable leaf but the last
    dual-query layer's image-only ones (BiGateSum1D_2's b_gate, the image
    FFN and its norm), which get zero gradients, as JAX gives them; a leaf
    cut from the loss anywhere else raises instead of taking zeros."""
    state, step, batch = _small_fused_trainer()
    logs, grads = step.grads(state, batch)
    unreached = step.unreached(state.model)
    names = sorted(n for n, p in zip(state.param_names, state.params)
                   if id(p) in unreached)
    assert all(not g.any() for p, g in zip(state.params, grads)
               if id(p) in unreached)
    last = "detector.backbone.fusion_hook.actr.layer0."
    assert names == sorted(last + n for n in (
        "gate.b_gate.weight", "gate.b_gate.bias", "i_ffn0.weight",
        "i_ffn0.bias", "i_ffn1.weight", "i_ffn1.bias", "norm_i.weight",
        "norm_i.bias")), names
    state.model.register_parameter("cut", torch.nn.Parameter(torch.ones(1)))
    with pytest.raises(RuntimeError, match="cut"):
        step.grads(state, batch)
