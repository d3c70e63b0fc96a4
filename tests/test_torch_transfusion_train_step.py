"""The whole TransFusion-L training step, df3d_torch against one jitted
df3d.train.trainer.make_transfusion_train_step: tests/test_train_steps.py's
TransFusion config (the +-16 m grid, caps 256/192/128/96, a head of 8
proposals at hidden width 16 on its 8 x 8 BEV map) at batch 2, 4096 points
per sample over the grid, four boxes of three classes per sample and four
padding slots, `adam_onecycle(1e-3, 100)`, flax variables filled from
seeded numpy and carried across by df3d_torch.weights.

Exact: the queries (labels and BEV positions of the training forward), the
Hungarian matches (the JAX package's host assignment recorded as it runs
inside the jitted step, and the port's), cap_overflow and tf_matched. The
assignment costs: 1e-5 * max|ref| + 1e-6. Tolerances of
tests/test_torch_train_step.py otherwise: per leaf, atol = 1e-4 * max|ref|
+ 1e-6 on every gradient leaf (recorded by a pass-through transform ahead
of the optimizer), on the batch statistics after the step (the head's
heatmap, position-embedding and FFN norms among them) and on the updated
parameters, plus Adam's first-step jump lr * |u(g + t) - u(g - t)|; the
losses rtol 1e-5.

The key position embedding runs one row of BEV pixels for the batch, where
JAX runs B equal rows: its batch statistics agree to rounding, within the
tolerance above.

ReLU decisions. The two forwards agree to ~1e-5 of the values, and a few
ReLU inputs lie closer to 0 than that (seen: one element of an FFN branch,
|x| 7.3e-7): a ReLU there passes the gradient on one side only, and every
leaf upstream moves by up to ~20% of its max. So each of the port's ReLUs
takes JAX's decision where the two disagree (JAX's ReLU inputs come from
the training-mode forward in the same jitted program;
`torch_port_helpers.replayed_relus`), and `test_relu_decisions` holds that
to a few elements, each within 1e-4 of 0."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from df3d.models.detectors.transfusion import TransFusionConfig as JConfig
from df3d.models.detectors.transfusion import TransFusionL as JTransFusionL
from df3d.models.heads import transfusion_head as jhead
from df3d.ops.voxelize import voxelize_batch as jvoxelize_batch
from df3d.train.schedules import adam_onecycle as jadam_onecycle
from df3d.train.trainer import TrainState as JTrainState
from df3d.train.trainer import make_transfusion_train_step as jmake_step
from df3d_torch.models.detectors.transfusion import (
    TransFusionConfig, TransFusionL,
)
from df3d_torch.models.heads import transfusion_head as thead
from df3d_torch.train.schedules import adam_onecycle, global_norm
from df3d_torch.train.trainer import make_transfusion_train_step
from df3d_torch.weights import (
    params_from_flax, state_dict_from_flax, train_state_from_flax,
)
from torch_port_helpers import (
    recorded_jax_relus, replayed_relus, seeded_variables,
)
from torch_port_helpers import one_torch_thread  # noqa: F401

# tests/test_train_steps.py's TransFusion config
HEAD = dict(num_classes=3, num_proposals=8, hidden_channel=16, num_heads=2,
            ffn_channel=32, small_classes=(2,), bev_size=(8, 8),
            voxel_size=(0.5, 0.5), pc_range=(-16.0, -16.0))
CFG = dict(pc_range=(-16.0, -16.0, -2.4, 16.0, 16.0, 2.4),
           voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64),
           max_voxels=256, num_point_features=4,
           stage_caps=(256, 192, 128, 96))
LR_MAX, TOTAL_STEPS = 1e-3, 100
# four boxes a sample (gravity centre, 9-dof) of classes 0, 1, 2, 0, well
# right of the map's left edge
BOXES = np.array([[1.0, 2.0, 0.0, 4.0, 2.0, 1.5, 0.3, 0.0, 0.0],
                  [-6.0, -8.0, 0.2, 2.0, 1.0, 1.2, 1.0, 0.5, 0.0],
                  [8.0, 5.0, -0.3, 1.0, 1.0, 1.8, -0.5, 0.0, 0.3],
                  [3.0, -10.0, 0.0, 4.5, 2.0, 1.6, 2.0, 0.0, 0.0]],
                 np.float32)


def _prior(names, v):
    """The heatmap conv and the class branch as flax initialises their
    biases, at the -2.19 prior (with a small kernel)."""
    if names[-2] in ("hm_conv1", "cls_fc1"):
        return v * 0.1 if names[-1] == "kernel" else v - 2.19
    return v


def _batch(b=2, n=4096, half=15.0):
    rng = np.random.RandomState(0)
    points = np.concatenate([rng.uniform(-half, half, (b, n, 2)),
                             rng.uniform(-1.8, 1.8, (b, n, 1)),
                             rng.uniform(0, 1, (b, n, 1))], -1)
    boxes = np.tile(BOXES[None], (b, 2, 1))
    boxes[1, :4, :2] += (1.5, -0.5)
    gt_valid = np.zeros((b, 8), bool)
    gt_valid[:, :4] = True
    return {"points": points.astype(np.float32),
            "points_valid": np.ones((b, n), bool), "gt_boxes": boxes,
            "gt_classes": np.tile(np.int32([0, 1, 2, 0]), (b, 2)),
            "gt_valid": gt_valid}


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
def step_run():
    batch = _batch()
    jcfg = JConfig(head=jhead.TransFusionHeadCfg(**HEAD), **CFG)
    jmodel = JTransFusionL(jcfg)

    def init(points):
        res = jvoxelize_batch(points, jnp.ones(points.shape[:2], bool),
                              jcfg.voxel_size, jcfg.pc_range, jcfg.grid_size,
                              jcfg.max_voxels, jcfg.max_points_per_voxel)
        return jmodel.init(jax.random.PRNGKey(0), res.features, res.coords,
                           train=False)

    shapes = jax.eval_shape(init, jnp.asarray(batch["points"][:1]))
    variables = seeded_variables(shapes, np.random.RandomState(1), _prior)
    tx = optax.chain(_record_grads(), jadam_onecycle(LR_MAX, TOTAL_STEPS))
    jstate = JTrainState.create(apply_fn=jmodel.apply,
                                params=variables["params"], tx=tx,
                                batch_stats=variables["batch_stats"])
    jcalls = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jhead, "ASSIGN_METHOD", "host")
        mp.setattr(jhead, "_hungarian_host",
                   _recorder(jhead._hungarian_host, jcalls))
        (new, jlogs), jqueries, jrelus = _jax_step_and_queries(
            jmodel, jcfg)(jstate, {k: jnp.asarray(v)
                                   for k, v in batch.items()})
        new = jax.tree_util.tree_map(np.asarray, new)

    cfg = TransFusionConfig(head=thead.TransFusionHeadCfg(**HEAD), **CFG)
    model = TransFusionL(cfg)
    state = train_state_from_flax(model, variables["params"],
                                  variables["batch_stats"],
                                  adam_onecycle(LR_MAX, TOTAL_STEPS))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    step = make_transfusion_train_step(cfg)
    queries, tcalls = [], []
    handle = model.bbox_head.register_forward_hook(
        lambda mod, inp, out: queries.append(
            {k: out[k].clone() for k in ("query_labels", "query_pos_xy")}))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(thead, "hungarian_match",
                   _recorder(thead.hungarian_match, tcalls))
        with replayed_relus(jrelus) as flips:
            logs, grads = step.grads(state, {k: torch.from_numpy(v)
                                             for k, v in batch.items()})
    handle.remove()
    grads = dict(zip(state.param_names, [g.clone() for g in grads]))
    state = step.apply(state, list(grads.values()))
    return dict(model=model, state=state, logs=logs, grads=grads, new=new,
                jlogs={k: np.asarray(v) for k, v in jlogs.items()},
                before=before, jqueries=jqueries, queries=queries[0],
                jcalls=jcalls, tcalls=tcalls, flips=flips)


def _jax_step_and_queries(jmodel, jcfg):
    """One jitted program: the JAX training step, and the query labels and
    positions and the ReLU inputs (in call order) of the training-mode
    forward of the same state and batch."""
    step = jmake_step(jmodel, jcfg)

    @jax.jit
    def run(state, batch):
        r = jvoxelize_batch(batch["points"], batch["points_valid"],
                            jcfg.voxel_size, jcfg.pc_range, jcfg.grid_size,
                            jcfg.max_voxels, jcfg.max_points_per_voxel)
        with recorded_jax_relus([]) as relus:
            (preds, _), _ = jmodel.apply(
                {"params": state.params, "batch_stats": state.batch_stats},
                r.features, r.coords, train=True,
                mutable=["batch_stats", "intermediates"])
        return step(state, batch), {k: preds[k] for k in (
            "query_labels", "query_pos_xy")}, relus

    return run


def _tol(ref):
    return 1e-4 * np.abs(ref).max() + 1e-6


def test_queries_and_matches(step_run):
    """The queries of the training forward and the Hungarian matches are
    equal as integers; the assignment costs agree."""
    r = step_run
    for k, v in r["jqueries"].items():
        np.testing.assert_array_equal(r["queries"][k].numpy(), np.asarray(v),
                                      err_msg=k)
    assert len(r["tcalls"]) == 1 and len(r["jcalls"]) == 2  # one per sample
    (cost, valid), matched = r["tcalls"][0]
    want = np.stack([out for _, out in r["jcalls"]])
    np.testing.assert_array_equal(matched.numpy(), want)
    jcost = np.stack([args[0] for args, _ in r["jcalls"]])
    np.testing.assert_allclose(cost.numpy(), jcost, rtol=0,
                               atol=1e-5 * np.abs(jcost).max() + 1e-6)
    np.testing.assert_array_equal(
        valid.numpy(), np.stack([args[1] for args, _ in r["jcalls"]]))
    assert (want >= 0).sum() == 8


def test_relu_decisions(step_run):
    """The port's ReLUs disagree with JAX's on a few elements at most, each
    within 1e-4 of 0 (rounding, not a different function)."""
    flips = step_run["flips"]
    assert sum(n for _, n, _ in flips) <= 4, flips
    assert all(z < 1e-4 for *_, z in flips), flips


def test_logs(step_run):
    r = step_run
    assert set(r["logs"]) == set(r["jlogs"])
    for k in ("cap_overflow", "tf_matched"):
        assert int(r["logs"][k]) == int(r["jlogs"][k]), k
    assert int(r["jlogs"]["cap_overflow"]) > 0  # the caps drop rows here
    for k, v in r["jlogs"].items():
        np.testing.assert_allclose(r["logs"][k].item(), v, rtol=1e-5,
                                   err_msg=k)
    assert r["state"].step == 1


def test_every_gradient_leaf(step_run):
    r = step_run
    want = params_from_flax(r["model"], r["new"].opt_state[0])
    assert set(want) == set(r["grads"])
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
    moved = {k.rsplit(".", 1)[0] for k in stats
             if not torch.equal(want[k], r["before"][k])}
    assert {"bbox_head.hm_bn", "bbox_head.query_pos_embed.bn",
            "bbox_head.key_pos_embed.bn", "bbox_head.cls_bn0"} <= moved
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
        ref, g = want[name].numpy(), ref_grads[name].numpy() * clip
        t = _tol(ref_grads[name].numpy()) * clip
        atol = _tol(ref) + lr0 * np.abs(u(g + t) - u(g - t))
        err = np.abs(p.detach().numpy() - ref)
        assert (err <= atol).all(), (name, float((err - atol).max()))
