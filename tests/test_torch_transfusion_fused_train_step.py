"""The whole TransFusion + 3D-DF training step, df3d_torch against one jitted
df3d.train.trainer.make_fused_train_step on TransFusion3DDF:
tests/test_torch_transfusion_slice.py's config (the +-16 m grid, the tiny
TransFusion head, 2 cameras of 64x112, ResNet + FPN on one-block stages,
the `transfusion_3ddf_nusc` preset's ACTRv2 narrowed: one image level, two
LT + dual-query layers, q_method "sum") at batch 2, 2048 points per sample
over the grid, tests/test_torch_transfusion_train_step.py's boxes, seeded
images and the rig of `utils.synth.camera_rig`, `adam_onecycle(1e-3,
100)`, flax variables filled from seeded numpy and carried across by
df3d_torch.weights.

Aux off and aux on, as in tests/test_torch_fused_train_step.py: JAX's step
is the aux step with the aux weights as traced arguments (at (0, 0) its
aux-off step, at (1.0, 0.1) the aux step) on a model with the aux head,
whose seeded weights are drawn apart from the others; the port's aux-off
step (no head) is held on every leaf but `aux_seg`, its aux step on every
leaf and the aux logs. The ReLUs replayed are those of JAX's forward
without the head (the same forward otherwise); the head's one ReLU is not
replayed.

Exact: the queries, the Hungarian matches, cap_overflow and tf_matched;
the leaves the loss cannot reach (JAX's gradient exactly 0) are the
port's declared `ACTR.unreached_parameters` at two layers. Tolerances of
tests/test_torch_fused_train_step.py otherwise: per leaf, atol = 1e-4 *
max|ref| + 1e-6 on every trainable gradient leaf, the batch statistics
after the step (IFAT's and the detector's moved, the frozen image branch's
not) and the updated parameters, plus Adam's first-step jump; the
assignment costs 1e-5 * max|ref| + 1e-6; the losses rtol 1e-5. Two kinds
of gradient leaf are sums that cancel (`_grad_tol`): a leaf whose JAX
gradient is 0 up to rounding (max|ref| < 1e-5; IFAT's conv biases ahead
of its training-mode BatchNorms, 3.5e-6 here, 3.6e-6 apart) takes the
floor of tests/test_torch_fusion.py's `_grad_tol`, 1e-5 in place of 1e-6;
the attention-weight kernels, whose output gradient sums to 0 over each
softmax, scale with the size of the terms their gradient sums, max
|dy|^T |x| from the port's step, in place of max|ref| (the first layer's
gradient comes to 0.016 from terms of up to 0.042, 4.3e-6 apart, within
5.2e-6); so do the ACTR gates' biases, whose gradient sums the gate
logit's gradient over every row, with the sum of its |dy| (with the aux
head, layer 0's `a_gate` bias comes to 0.033 from terms summing to 0.81;
one ulp more on every point's intensity moves the port's f32 leaf by 2.4
times its `_tol`).

ReLU decisions: as in tests/test_torch_transfusion_train_step.py, each of
the port's ReLUs takes JAX's decision where the two disagree, at most a
few elements, each within 1e-4 of 0 (`test_relu_decisions`).

The f32 rounding of this step: the port's step also runs in f64 (model
and batch, the same replayed decisions). Every gradient leaf of that step
is held to JAX's at the tolerance above, and the port's f32 leaf to JAX's
at 3 times it. The derivation: with g the exact gradient, JAX's f32 leaf
is g + e_J and the port's f32 leaf g + e_P, and the f64 step is g to
within ~1e-9 of the tolerance; so |f32 - JAX| <= |e_P| + |e_J| =
|f32 - f64| + |f64 - JAX|. On an AVX-512 host (AMD EPYC, torch on one
thread; the test prints the three per run), in units of `_grad_tol`, over
both cases: |f64 - JAX| <= 0.475 (an attention-weight kernel),
|f32 - f64| <= 2.043 (the backbone below the hook, ACTR's LT and
`q_proj`), so |f32 - JAX| <= 2.52, within 3; it reads 2.15. The port's
f32 error is rounding noise, not a fault: one ulp more on every point's
intensity (`np.nextafter(points[..., 3], 2)` in the batch of `jax_run`,
the step run again) moved the f32 leaves by up to 1.60 `_tol` without
the aux head (2.4 on layer 0's `a_gate` bias with it) and the f64 leaves
by 0.005. The BLAS kernels a host picks set that rounding: at
1 times the tolerance the f32 comparison held on one kind of host and
not on another.

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

from df3d.models.detectors.fused import FusedConfig as JFusedConfig
from df3d.models.detectors.fused import TransFusion3DDF as JTransFusion3DDF
from df3d.models.detectors.transfusion import TransFusionConfig as JConfig
from df3d.models.fusion.actr import ACTRConfig as JACTRConfig
from df3d.models.heads import transfusion_head as jhead
from df3d.ops.voxelize import voxelize_batch as jvoxelize_batch
from df3d.train.schedules import adam_onecycle as jadam_onecycle
from df3d.train.trainer import TrainState as JTrainState
from df3d.train.trainer import make_fused_train_step as jmake_step
from df3d_torch.models.detectors.fused import FusedConfig, TransFusion3DDF
from df3d_torch.models.detectors.transfusion import TransFusionConfig
from df3d_torch.models.fusion.actr import ACTR, ACTRConfig
from df3d_torch.models.heads import transfusion_head as thead
from df3d_torch.train.schedules import adam_onecycle, global_norm
from df3d_torch.train.trainer import make_fused_train_step
from df3d_torch.utils.synth import camera_rig
from df3d_torch.weights import (
    params_from_flax, state_dict_from_flax, train_state_from_flax,
)
from torch_port_helpers import (
    AUX_LOGS, AUX_WEIGHTS, new_without_aux, recorded_jax_relus,
    replayed_relus, seeded_variables, without_aux,
)
from torch_port_helpers import one_torch_thread  # noqa: F401

# tests/test_torch_transfusion_slice.py's config
HEAD = dict(num_classes=3, num_proposals=16, hidden_channel=32, num_heads=4,
            ffn_channel=64, small_classes=(2,), bev_size=(8, 8),
            out_size_factor=8, voxel_size=(0.5, 0.5), pc_range=(-16.0, -16.0))
CFG = dict(pc_range=(-16.0, -16.0, -2.4, 16.0, 16.0, 2.4),
           voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64),
           max_voxels=512, num_point_features=4,
           stage_caps=(1024, 512, 256, 128))
ACTR_CFG = dict(d_model=16, n_heads=2, n_points=2, n_levels=1, num_layers=2,
                dim_feedforward=32, lt_npoint=8, lt_nsample=4,
                model_name="ACTRv2", q_method="sum",
                attn_layer="BiGateSum1D_2", hybrid=True)
FUSED = dict(image_shape=(64, 112), image_branch="resnet_fpn",
             image_layers=(1, 1, 1, 1), n_levels=1, num_cams=2,
             use_ifat=True, fusion_downsample=8)
LR_MAX, TOTAL_STEPS, WEIGHT_DECAY = 1e-3, 100, 0.01
# tests/test_torch_transfusion_train_step.py's boxes (classes 0, 1, 2, 0)
BOXES = np.array([[1.0, 2.0, 0.0, 4.0, 2.0, 1.5, 0.3, 0.0, 0.0],
                  [-6.0, -8.0, 0.2, 2.0, 1.0, 1.2, 1.0, 0.5, 0.0],
                  [8.0, 5.0, -0.3, 1.0, 1.0, 1.8, -0.5, 0.0, 0.3],
                  [3.0, -10.0, 0.0, 4.5, 2.0, 1.6, 2.0, 0.0, 0.0]],
                 np.float32)


def _prior(names, v):
    """The heatmap conv and the class branch at the -2.19 prior."""
    if names[-2] in ("hm_conv1", "cls_fc1"):
        return v * 0.1 if names[-1] == "kernel" else v - 2.19
    return v


def _batch(b=2, n=2048, half=15.0):
    rng = np.random.RandomState(0)
    points = np.concatenate([rng.uniform(-half, half, (b, n, 2)),
                             rng.uniform(-1.8, 1.8, (b, n, 1)),
                             rng.uniform(0, 1, (b, n, 1))], -1)
    boxes = np.tile(BOXES[None], (b, 2, 1))
    boxes[1, :4, :2] += (1.5, -0.5)
    gt_valid = np.zeros((b, 8), bool)
    gt_valid[:, :4] = True
    nc, hw = FUSED["num_cams"], FUSED["image_shape"]
    return {"points": points.astype(np.float32),
            "points_valid": np.ones((b, n), bool), "gt_boxes": boxes,
            "gt_classes": np.tile(np.int32([0, 1, 2, 0]), (b, 2)),
            "gt_valid": gt_valid,
            "images": rng.randn(b, nc, *hw, 3).astype(np.float32),
            "proj": np.broadcast_to(camera_rig(nc, hw),
                                    (b, nc, 3, 4)).copy()}


def _record_grads():
    """A pass-through transform whose state is the gradients it saw."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _recorder(fn, calls):
    def recording(*args):
        out = fn(*args)
        calls.append((args, out))
        return out
    return recording


@pytest.fixture(scope="module")
def jax_run():
    """JAX's step at both aux weights (one compiled program), its queries,
    ReLU inputs and Hungarian calls."""
    batch = _batch()
    jcfg = JConfig(head=jhead.TransFusionHeadCfg(**HEAD), **CFG)
    fused = dict(actr=JACTRConfig(**ACTR_CFG), **FUSED)
    jmodel = JTransFusion3DDF(jcfg, JFusedConfig(with_aux_seg=True, **fused))
    jplain = JTransFusion3DDF(jcfg, JFusedConfig(**fused))

    def init(points, images, proj):
        res = jvoxelize_batch(points, jnp.ones(points.shape[:2], bool),
                              jcfg.voxel_size, jcfg.pc_range, jcfg.grid_size,
                              jcfg.max_voxels, jcfg.max_points_per_voxel)
        return jmodel.init(jax.random.PRNGKey(0), res.features, res.coords,
                           images, proj, train=False)

    shapes = jax.eval_shape(init, *(jnp.asarray(batch[k][:1])
                                    for k in ("points", "images", "proj")))
    variables = seeded_variables(without_aux(shapes),
                                 np.random.RandomState(1), _prior)
    variables["params"]["aux_seg"] = seeded_variables(
        {"params": shapes["params"]["aux_seg"]},
        np.random.RandomState(2))["params"]
    tx = optax.chain(_record_grads(), jadam_onecycle(LR_MAX, TOTAL_STEPS))
    jstate = JTrainState.create(apply_fn=jmodel.apply,
                                params=variables["params"], tx=tx,
                                batch_stats=variables["batch_stats"])
    run = _jax_step_and_queries(jmodel, jplain, jcfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    out, jcalls = {}, []  # the recorder is traced into the program once
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhead, "ASSIGN_METHOD", "host")
        mp.setattr(jhead, "_hungarian_host",
                   _recorder(jhead._hungarian_host, jcalls))
        for name, w in AUX_WEIGHTS.items():
            start = len(jcalls)
            (new, jlogs), jqueries, jrelus = run(jstate, jbatch,
                                                 jnp.float32(w))
            new = jax.tree_util.tree_map(np.asarray, new)
            out[name] = (new, {k: np.asarray(v) for k, v in jlogs.items()},
                         jcalls[start:])
    return dict(batch=batch, variables=variables, steps=out,
                jqueries=jqueries, jrelus=jrelus)


@pytest.fixture(scope="module", params=sorted(AUX_WEIGHTS))
def step_run(request, jax_run):
    aux = request.param == "aux_on"
    batch, variables = jax_run["batch"], jax_run["variables"]
    new, jlogs, jcalls = jax_run["steps"][request.param]
    if not aux:
        variables, new = without_aux(variables), new_without_aux(new)

    cfg = TransFusionConfig(head=thead.TransFusionHeadCfg(**HEAD), **CFG)
    model = TransFusion3DDF(cfg, FusedConfig(actr=ACTRConfig(**ACTR_CFG),
                                             with_aux_seg=aux, **FUSED))
    state = train_state_from_flax(model, variables["params"],
                                  variables["batch_stats"],
                                  adam_onecycle(LR_MAX, TOTAL_STEPS))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_fused_train_step(cfg, aux=aux, image_hw=FUSED["image_shape"])
    queries, tcalls, terms = [], [], {}
    handles = [model.detector.bbox_head.register_forward_hook(
        lambda mod, inp, out: queries.append(
            {k: out[k].clone() for k in ("query_labels", "query_pos_xy")}))]
    for name, mod in model.named_modules():
        if name.endswith(".self_attn.attention_weights"):
            handles.append(mod.register_forward_hook(
                _summed_terms(f"{name}.weight", terms)))
        elif name.endswith((".gate.a_gate", ".gate.b_gate")):
            handles.append(mod.register_forward_hook(
                _summed_bias_terms(f"{name}.bias", terms)))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(thead, "hungarian_match",
                   _recorder(thead.hungarian_match, tcalls))
        with replayed_relus(jax_run["jrelus"],
                            getattr(model, "aux_seg", None)) as flips:
            logs, grads = step.grads(state, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
    for h in handles:
        h.remove()
    grads = dict(zip(state.param_names, [g.clone() for g in grads]))
    state = step.apply(state, list(grads.values()))
    return dict(model=model, state=state, logs=logs, grads=grads, new=new,
                jlogs=jlogs, before=before, jqueries=jax_run["jqueries"],
                queries=queries[0], jcalls=jcalls, tcalls=tcalls,
                flips=flips, terms=terms, aux=aux,
                grads64=_f64_grads(cfg, aux, variables, batch,
                                   jax_run["jrelus"]))


def _f64_grads(cfg, aux, variables, batch, jrelus):
    """The port's step in f64 (model and batch) from the same variables,
    its ReLUs replaying JAX's decisions: gradients by name, as numpy."""
    model = TransFusion3DDF(cfg, FusedConfig(actr=ACTRConfig(**ACTR_CFG),
                                             with_aux_seg=aux, **FUSED))
    state = train_state_from_flax(model, variables["params"],
                                  variables["batch_stats"],
                                  adam_onecycle(LR_MAX, TOTAL_STEPS))
    model.double()
    step = make_fused_train_step(cfg, aux=aux, image_hw=FUSED["image_shape"])
    b = {k: torch.from_numpy(v) for k, v in batch.items()}
    with replayed_relus(jrelus, getattr(model, "aux_seg", None)):
        _, grads = step.grads(state, {k: v.double() if v.is_floating_point()
                                      else v for k, v in b.items()})
    return {n: g.numpy() for n, g in zip(state.param_names, grads)}


def _jax_step_and_queries(jmodel, jplain, jcfg):
    """One jitted program: the JAX aux training step of `jmodel` at the aux
    weights `w` (seg, consistency), and the query labels and positions and
    the ReLU inputs (in call order) of the training-mode forward of the
    same state and batch through `jplain`, the model without the aux
    head."""

    @jax.jit
    def run(state, batch, w):
        step = jmake_step(jmodel, jcfg, aux=True,
                          image_hw=FUSED["image_shape"],
                          aux_seg_weight=w[0], aux_consistency_weight=w[1])
        r = jvoxelize_batch(batch["points"], batch["points_valid"],
                            jcfg.voxel_size, jcfg.pc_range, jcfg.grid_size,
                            jcfg.max_voxels, jcfg.max_points_per_voxel)
        with recorded_jax_relus([]) as relus:
            (preds, _), _ = jplain.apply(
                {"params": without_aux(state.params),
                 "batch_stats": state.batch_stats},
                r.features, r.coords, batch["images"], batch["proj"],
                train=True, mutable=["batch_stats", "intermediates"])
        return step(state, batch), {k: preds[k] for k in (
            "query_labels", "query_pos_xy")}, relus

    return run


def _summed_terms(name, store):
    """A forward hook on a Linear layer that stores under `name` the
    largest entry of |dy|^T |x|: the size of the terms its weight's
    gradient dy^T x sums, whatever they cancel to."""
    def hook(mod, inp, out):
        x = inp[0].detach().reshape(-1, inp[0].shape[-1]).abs()

        def on_grad(dy):
            dy = dy.detach().reshape(-1, dy.shape[-1]).abs()
            store[name] = float((dy.t() @ x).max())
        out.register_hook(on_grad)
    return hook


def _summed_bias_terms(name, store):
    """A forward hook on a Linear layer that stores under `name` the
    largest entry of the sum of |dy| over its rows: the size of the terms
    its bias's gradient, the sum of dy, sums, whatever they cancel to."""
    def hook(mod, inp, out):
        def on_grad(dy):
            dy = dy.detach().reshape(-1, dy.shape[-1]).abs()
            store[name] = float(dy.sum(0).max())
        out.register_hook(on_grad)
    return hook


def _tol(ref):
    return 1e-4 * np.abs(ref).max() + 1e-6


def _grad_tol(name, ref, terms):
    """A gradient leaf's tolerance: `_tol`, but for two kinds of leaf
    whose gradient is a sum that cancels. A leaf whose JAX gradient is 0
    up to rounding (max|ref| < 1e-5: IFAT's conv biases ahead of its
    training-mode BatchNorms, 3.5e-6 here, and ACTR's input projection
    bias, 1e-8) gets a floor of 1e-5. The attention-weight kernels
    (`terms`), whose output gradient sums to 0 over each softmax, scale
    with the terms their gradient sums (max |dy|^T |x|: 0.042 where the
    first layer's gradient comes to 0.016) in place of max|ref|; so do the
    gates' biases (the sum of |dy| over the rows)."""
    big = max(np.abs(ref).max(), terms.get(name, 0.0))
    floor = 1e-5 if np.abs(ref).max() < 1e-5 else 1e-6
    return 1e-4 * big + floor


def _frozen(name):
    return name.startswith("image_branch.")


def test_relu_decisions(step_run):
    """The port's ReLUs disagree with JAX's on a few elements at most, each
    within 1e-4 of 0 (rounding, not a different function)."""
    flips = step_run["flips"]
    assert sum(n for _, n, _ in flips) <= 4, flips
    assert all(z < 1e-4 for *_, z in flips), flips


def test_queries_and_matches(step_run):
    r = step_run
    for k, v in r["jqueries"].items():
        np.testing.assert_array_equal(r["queries"][k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert len(r["tcalls"]) == 1 and len(r["jcalls"]) == 2
    (cost, valid), matched = r["tcalls"][0]
    want = np.stack([out for _, out in r["jcalls"]])
    np.testing.assert_array_equal(matched.numpy(), want)
    jcost = np.stack([args[0] for args, _ in r["jcalls"]])
    np.testing.assert_allclose(cost.numpy(), jcost, rtol=0,
                               atol=1e-5 * np.abs(jcost).max() + 1e-6)
    assert (want >= 0).sum() == 8


def test_logs(step_run):
    """Every log; aux off, JAX's aux logs are exact zeros and the port has
    none."""
    r = step_run
    jlogs = dict(r["jlogs"])
    if not r["aux"]:
        assert all(jlogs.pop(k) == 0.0 for k in AUX_LOGS)
    assert set(r["logs"]) == set(jlogs)
    for k in ("cap_overflow", "tf_matched"):
        assert int(r["logs"][k]) == int(jlogs[k]), k
    for k, v in jlogs.items():
        np.testing.assert_allclose(r["logs"][k].item(), v, rtol=1e-5,
                                   err_msg=k)
    assert r["state"].step == 1


def test_every_trainable_gradient_leaf(step_run):
    """Every leaf the port trains against JAX's gradient: the port's f64
    step at the tolerance, its f32 step at 3 times it (derived in the
    module docstring); the frozen image branch is not in the port's state
    and has zero gradients in JAX. Prints the largest |f32 - f64|,
    |f64 - JAX| and |f32 - JAX| over the leaves, in tolerances."""
    r = step_run
    want = params_from_flax(r["model"], r["new"].opt_state[0])
    trainable = {n for n in want if not _frozen(n)}
    assert trainable == set(r["grads"]) == set(r["grads64"])
    assert sorted(k.rsplit(".", 2)[-2] for k in r["terms"]) == [
        "a_gate", "a_gate", "attention_weights", "attention_weights",
        "b_gate"], r["terms"]
    for name in set(want) - trainable:
        assert not want[name].any(), name
    worst = dict.fromkeys(("f32 - f64", "f64 - JAX", "f32 - JAX"), (0, ""))
    for name, g in r["grads"].items():
        ref, exact = want[name].numpy(), r["grads64"][name]
        tol = _grad_tol(name, ref, r["terms"])
        for k, (a, b) in (("f32 - f64", (g.numpy(), exact)),
                          ("f64 - JAX", (exact, ref)),
                          ("f32 - JAX", (g.numpy(), ref))):
            worst[k] = max(worst[k], (np.abs(a - b).max() / tol, name))
        np.testing.assert_allclose(exact, ref, rtol=0, atol=tol,
                                   err_msg=f"{name} (f64 step)")
        np.testing.assert_allclose(g.numpy(), ref, rtol=0, atol=3 * tol,
                                   err_msg=name)
    print("largest gaps over the leaves, in tolerances: " + ", ".join(
        f"|{k}| {v:.3f} ({n})" for k, (v, n) in worst.items()))


def test_unreached_leaves(step_run):
    """The leaves the port declares unreachable at two dual-query layers
    with q "sum" (the last layer's image-side gate projection, image FFN
    and its norm; the step raises if autograd leaves any other leaf without
    a gradient) have a JAX gradient of exactly 0. JAX's other exact zeros
    come from this input: every LT neighbourhood holds only its centre (2
    m radius on a 4 m stride-8 lattice), so LT's attention has one key and
    its position encoding a zero offset; the port's gradients are exactly
    0 on all of them too."""
    r = step_run
    want = params_from_flax(r["model"], r["new"].opt_state[0])
    zero = {n for n in r["grads"] if not want[n].any()}
    actr = next(m for m in r["model"].modules() if isinstance(m, ACTR))
    ids = {id(p) for p in actr.unreached_parameters()}
    declared = {n for n, p in r["model"].named_parameters() if id(p) in ids}
    assert len(declared) == 8 and declared <= zero, sorted(declared - zero)
    assert all(n.split(".")[-2].startswith(("b_gate", "i_ffn", "norm_i"))
               and ".layer1." in n for n in declared), declared
    for name in zero - declared:
        assert ".lidar_attn" in name and name.split(".")[-2] in (
            "query", "key", "pe0"), name
    for name in zero:
        assert not r["grads"][name].any(), name


def test_batch_stats_after_step(step_run):
    r = step_run
    want = state_dict_from_flax(r["model"], {
        "params": r["new"].params, "batch_stats": r["new"].batch_stats})
    got = r["model"].state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    moved = [k for k in stats if not torch.equal(want[k], r["before"][k])]
    assert any(".ifat." in k for k in moved)
    assert any(".bbox_head.key_pos_embed." in k for k in moved)
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
        t = _grad_tol(name, ref_grads[name].numpy(), r["terms"]) * clip
        atol = _tol(ref) + lr0 * np.abs(u(g + t) - u(g - t))
        err = np.abs(p.detach().numpy() - ref)
        assert (err <= atol).all(), (name, float((err - atol).max()))


def test_frozen_image_branch(step_run):
    """The port's image branch is unchanged by the step and stays in eval
    mode; JAX's moves by -lr * weight_decay * p."""
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


def test_aux_head_trains(step_run):
    """Aux on, the head's leaves have a gradient and move; aux off the
    port's model has no head."""
    r = step_run
    head = [n for n in r["grads"] if n.startswith("aux_seg.")]
    assert len(head) == (4 if r["aux"] else 0)
    for name in head:
        assert r["grads"][name].abs().max() > 0, name
        p = dict(r["model"].named_parameters())[name]
        assert not torch.equal(p.detach(), r["before"][name]), name
