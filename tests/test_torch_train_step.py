"""The whole CenterPoint training step, df3d_torch against one jitted
df3d.train.trainer.make_centerpoint_train_step: `__graft_entry__._mesh_cfg()`
at batch 2 with `dryrun_multichip`'s gt layout (four equal boxes of class 0
per sample, four padding slots), `adam_onecycle(1e-3, 100)`, flax
variables filled from seeded numpy and carried across by
df3d_torch.weights.

The points are 4096 per sample, uniform over the grid's own range (+-15
m). On dryrun_multichip's own spread (+-25 m over the +-16 m grid, most of
the BEV map empty) the reference itself sits on a jump: one ulp more on
every point's intensity moves its gradient leaves by up to ~1e-3 of their
max, and there the port agrees with it at the tolerance below
(`test_dry_run_spread`).

Tolerances, per leaf, atol = 1e-4 * max|ref| + 1e-6 (f32, other summation
order): every gradient leaf (the reference's raw gradients, recorded by a
pass-through transform chained before the optimizer), the batch statistics
after the step and the updated parameters. Adam's first step maps a
gradient to g / (|g| + eps) * lr, a jump of 2 lr where g crosses 0, so an
updated parameter also gets lr * |u(g + t) - u(g - t)| on top of its
tolerance, with u that map and t its gradient's tolerance (clipped like the
gradient). Exact: cap_overflow. Loss and per-task logs: rtol 1e-5.

The port's ReLUs take JAX's decisions where the two disagree
(`replayed_relus`, JAX's inputs recorded by a training forward in the same
jitted program as the step): the convs and matmuls sum in another order
than XLA's, a host's BLAS kernels set that order, and a ReLU input within
rounding of 0 takes the other side on some hosts (two elements here on an
AVX-512 host, |x| 3.9e-7 and 1.0e-5, each moving every leaf upstream past
its tolerance). At most 4 elements a step, each within 1e-4 of 0."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from df3d.models.detectors.centerpoint import CenterPoint as JCenterPoint
from df3d.models.detectors.centerpoint import CenterPointConfig as JConfig
from df3d.ops.voxelize import voxelize_batch as jvoxelize_batch
from df3d.train.schedules import adam_onecycle as jadam_onecycle
from df3d.train.trainer import TrainState as JTrainState
from df3d.train.trainer import make_centerpoint_train_step as jmake_step
from df3d_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointConfig,
)
from df3d_torch.train.schedules import adam_onecycle, global_norm
from df3d_torch.train.trainer import make_centerpoint_train_step
from df3d_torch.weights import (
    params_from_flax, state_dict_from_flax, train_state_from_flax,
)
import torch_parallel_ranks
from torch_port_helpers import (
    recorded_jax_relus, replayed_relus, seeded_variables,
)

# __graft_entry__._mesh_cfg()
CFG = dict(
    pc_range=(-16.0, -16.0, -2.4, 16.0, 16.0, 2.4),
    voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64),
    max_voxels=256, num_point_features=5, stage_caps=(256, 128, 96, 64),
    tasks=(1, 2), max_objs=8, nms_pre_max_size=32, nms_post_max_size=4,
    post_center_range=(-20.0, -20.0, -4.0, 20.0, 20.0, 4.0),
)
LR_MAX, TOTAL_STEPS = 1e-3, 100


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
    return {"points": points.astype(np.float32),
            "points_valid": np.ones((b, n), bool),
            "gt_boxes": np.tile(box, (b, 8, 1)),
            "gt_classes": np.zeros((b, 8), np.int32), "gt_valid": gt_valid}


def _record_grads():
    """A pass-through transform whose state is the gradients it saw."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


@pytest.fixture(scope="module")
def step_run():
    batch = _batch()
    jcfg = JConfig(**CFG)
    jmodel = JCenterPoint(jcfg)

    def init(points):
        res = jvoxelize_batch(points, jnp.ones(points.shape[:2], bool),
                              jcfg.voxel_size, jcfg.pc_range, jcfg.grid_size,
                              jcfg.max_voxels, jcfg.max_points_per_voxel)
        return jmodel.init(jax.random.PRNGKey(0), res.features, res.coords,
                           train=False)

    shapes = jax.eval_shape(init, jnp.asarray(batch["points"][:1]))
    variables = seeded_variables(shapes, np.random.RandomState(1), _hm_prior)
    tx = optax.chain(_record_grads(), jadam_onecycle(LR_MAX, TOTAL_STEPS))
    jstate = JTrainState.create(apply_fn=jmodel.apply,
                                params=variables["params"], tx=tx,
                                batch_stats=variables["batch_stats"])
    jstep = _jax_step_and_relus(jmodel, jcfg)
    (new, jlogs), jrelus = jstep(jstate, {k: jnp.asarray(v)
                                          for k, v in batch.items()})
    new = jax.tree_util.tree_map(np.asarray, new)

    cfg = CenterPointConfig(**CFG)
    model = CenterPoint(cfg)
    # the decisions the port's step took (JAX's), for
    # test_two_ranks_against_jax
    relus = []
    with torch_parallel_ranks.relu_decisions(relus):
        state, step, logs, grads, flips = _port_grads(model, variables,
                                                      batch, jrelus)
    state = step.apply(state, list(grads.values()))
    return dict(model=model, state=state, logs=logs, grads=grads, new=new,
                jlogs={k: np.asarray(v) for k, v in jlogs.items()},
                jstep=jstep, jstate=jstate, variables=variables,
                relus=relus, flips=flips)


def _jax_step_and_relus(jmodel, jcfg):
    """One jitted program: the JAX package's training step and, on the
    same batch and state, a training forward whose ReLU inputs it returns
    beside the step's (state, logs)."""
    step = jmake_step(jmodel, jcfg)

    def run(state, batch):
        res = jvoxelize_batch(batch["points"], batch["points_valid"],
                              jcfg.voxel_size, jcfg.pc_range, jcfg.grid_size,
                              jcfg.max_voxels, jcfg.max_points_per_voxel)
        with recorded_jax_relus([]) as relus:
            jmodel.apply({"params": state.params,
                          "batch_stats": state.batch_stats},
                         res.features, res.coords, train=True,
                         mutable=["batch_stats"])
        return step(state, batch), relus

    return jax.jit(run)


def _check_replays(flips):
    assert sum(n for _, n, _ in flips) <= 4, flips
    assert all(z < 1e-4 for _, _, z in flips), flips


def _port_grads(model, variables, batch, jrelus):
    """The port's state from the flax variables and its step's (logs,
    gradients by parameter name) on a numpy batch, its ReLUs replaying
    the decisions of JAX's ReLU inputs `jrelus`; and the replays."""
    state = train_state_from_flax(model, variables["params"],
                                  variables["batch_stats"],
                                  adam_onecycle(LR_MAX, TOTAL_STEPS))
    step = make_centerpoint_train_step(model.cfg)
    with replayed_relus(jrelus) as flips:
        logs, grads = step.grads(state, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
    names = [n for n, _ in model.named_parameters()]
    return state, step, logs, {n: g.detach().clone()
                               for n, g in zip(names, grads)}, flips


def _tol(ref):
    return 1e-4 * np.abs(ref).max() + 1e-6


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


def test_every_gradient_leaf(step_run):
    r = step_run
    _check_replays(r.get("flips", []))
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
    assert stats
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
    assert clip < 1.0  # the step clips: the norm is above 10
    lr0, eps = float(r["state"].tx.lr(0)), 1e-8

    def u(g):  # Adam's first update direction for a clipped gradient g
        return g / (np.abs(g) + eps)

    for name, p in r["model"].named_parameters():
        ref, g = want[name].numpy(), ref_grads[name].numpy() * clip
        t = _tol(ref_grads[name].numpy()) * clip
        atol = _tol(ref) + lr0 * np.abs(u(g + t) - u(g - t))
        err = np.abs(p.detach().numpy() - ref)
        assert (err <= atol).all(), (name, float((err - atol).max()))


def test_dry_run_spread(step_run):
    """dryrun_multichip's spread of points (+-25 m over the +-16 m grid,
    most of the BEV map empty), 4096 per sample so the jitted reference is
    reused, at x0 and at x1, every point's intensity one ulp up. The
    reference's own gradients jump between x0 and x1: at random weights a
    ReLU input sits within rounding of 0 and takes the other side (by
    ~250 times the tolerance on some leaves). The port replays JAX's ReLU
    decisions, those at x0 or those at x1 (at most 4 elements each, within
    1e-4 of 0). Checks, every gradient leaf at the tolerance above: the
    port at x1 with x1's decisions against the reference at x1 (the same
    input); the port at x0 with x1's decisions against the reference
    within one ulp of x0 (at x1), so the jump is the decisions' and not
    the input's; and the port at x0 with x0's decisions against the
    reference at x0. Prints the leaves that jump, with the readings."""
    r = step_run
    x0 = _batch(half=25.0)
    x1 = dict(x0, points=x0["points"].copy())
    x1["points"][..., 3] = np.nextafter(x1["points"][..., 3], np.float32(2))
    model = CenterPoint(r["model"].cfg)
    ref, relus = {}, {}
    for key, batch in (("x0", x0), ("x1", x1)):
        (new, _), relus[key] = r["jstep"](
            r["jstate"], {k: jnp.asarray(v) for k, v in batch.items()})
        ref[key] = {k: v.numpy() for k, v in params_from_flax(
            model, jax.tree_util.tree_map(np.asarray,
                                          new.opt_state[0])).items()}
    got = {}
    for key, batch, decided in (("x0", x0, "x0"), ("x1", x1, "x1"),
                                ("x0@x1", x0, "x1")):
        _, _, _, grads, flips = _port_grads(model, r["variables"], batch,
                                            relus[decided])
        _check_replays(flips)
        got[key] = {k: v.numpy() for k, v in grads.items()}

    def off(a, b):
        return np.abs(a - b).max() - _tol(b)

    jumps = []
    for name, r0 in ref["x0"].items():
        r1, g0, g1 = ref["x1"][name], got["x0"][name], got["x1"][name]
        assert off(g1, r1) <= 0, (name, "at x1", off(g1, r1))
        assert off(got["x0@x1"][name], r1) <= 0, (
            name, "at x0 against x1", off(got["x0@x1"][name], r1))
        assert off(g0, r0) <= 0, (name, "at x0", off(g0, r0))
        if off(r1, r0) > 0:
            scale = np.abs(r0).max()
            jumps.append(
                f"{name}: reference x0 -> x1 {np.abs(r1 - r0).max() / scale:.3g}"
                f", port x0 -> x1 {np.abs(g1 - g0).max() / scale:.3g}, port -"
                f" reference at x0 {np.abs(g0 - r0).max() / scale:.3g}")
    print(f"{len(jumps)} of {len(ref['x0'])} gradient leaves of the "
          "reference jump by more than the tolerance between x0 and x1 "
          "(over the leaf's max at x0):\n" + "\n".join(jumps))


def test_two_ranks_against_jax(step_run, tmp_path):
    """The port's `DataParallelTrainStep` over 2 gloo CPU ranks, one
    sample each, from the same flax variables, against the jitted JAX step
    on the global batch of two (one `jit` program over the whole batch,
    as `dryrun_multichip` shards it): the logs, every gradient leaf, the
    batch statistics and the updated parameters, with the checks above.
    The ranks' statistics sum in another order, and a neck ReLU input
    within ~1e-5 of 0 can take the other side on a rank (which moves
    every gradient leaf upstream past its tolerance), so the ranks replay
    the port's one-process decisions, which are JAX's (`step_run`'s port
    step replays them): at most 4 elements a rank, each within 1e-4 of 0;
    the replays are printed."""
    r = step_run
    torch.save(r["relus"], tmp_path / "relus.pt")
    torch_parallel_ranks.spawn(
        torch_parallel_ranks.flax_state_rank, tmp_path, str(tmp_path), CFG,
        r["variables"], _batch(), LR_MAX, TOTAL_STEPS)
    got = torch.load(tmp_path / "flax_state.pt")
    for flips in got["flips"]:
        assert sum(n for n, _ in flips) <= 4
        assert all(z < 1e-4 for _, z in flips)
    model = CenterPoint(r["model"].cfg)
    state = train_state_from_flax(model, r["variables"]["params"],
                                  r["variables"]["batch_stats"],
                                  adam_onecycle(LR_MAX, TOTAL_STEPS))
    model.load_state_dict(got["state_dict"])
    state.step = 1
    dp = dict(r, model=model, state=state, logs=got["logs"],
              grads=got["grads"])
    for check in (test_logs, test_every_gradient_leaf,
                  test_batch_stats_after_step, test_updated_parameters):
        check(dp)
    print(f"ReLU replays per rank: {got['flips']}")
