"""df3d_torch's PointPillars against df3d's: mean_vfe, PillarVFE (eval,
and training with the batch statistics and their update), pillar_scatter
(padding rows dropped, the later of two rows on one pillar winning) and
the PointPillars detector (PillarVFE -> scatter -> the 3 / 5 / 5 neck ->
AnchorHeadSingle) on a 48x64 pillar grid, batch 2; the JAX package has no
test of the detector itself. Each pillar's points come from seeded numpy
frames as the JAX package's tests build them (`chip_smoke.pillar_inputs`:
the first `max_points_per_voxel` points of a pillar in frame order, the
pillars in key order; there is no pillar voxelizer in either package). Flax
variables are seeded numpy on `jax.eval_shape` trees, carried across by
df3d_torch.weights (strictly), and at `PointPillarConfig()`'s full width
the trees carry with every leaf landing once.

Every JAX function runs inside one jitted program (`_jax_program`).
Exact: the scattered canvas. Float outputs to 1e-4 * max|ref| + 1e-5
(f32, another summation order): the VFE's features and statistics and
the anchor head's cls, box and dir."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import pillar_inputs
from df3d.models import vfe as jvfe
from df3d.models.detectors import pointpillar as jpp
from df3d_torch.models import vfe as tvfe
from df3d_torch.models.detectors import pointpillar as tpp
from df3d_torch.weights import state_dict_from_flax
from torch_port_helpers import load_flax, seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
# 48 x 64 pillars of 0.16 m (a multiple of the neck's total stride 8)
GEOM = dict(pc_range=(0.0, -5.12, -3.0, 7.68, 5.12, 1.0),
            grid_size=(1, 64, 48), max_voxels=300, max_points_per_voxel=8,
            pillar_channels=16)
JCFG, TCFG = jpp.PointPillarConfig(**GEOM), tpp.PointPillarConfig(**GEOM)


def _tol(got, want, err_msg=""):
    """max |got - want| <= 1e-4 * max |want| + 1e-5."""
    want = np.asarray(want)
    atol = 1e-4 * (np.abs(want).max() if want.size else 0.0) + 1e-5
    np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=0,
                               err_msg=err_msg)


def _inputs():
    rng = np.random.RandomState(0)
    frames = []
    for _ in range(2):
        n = 350
        pts = np.concatenate([rng.uniform(0, 7.6, (n, 1)),
                              rng.uniform(-5, 5, (n, 1)),
                              rng.uniform(-2.5, 0.5, (n, 1)),
                              rng.uniform(0, 1, (n, 1))], -1)
        # a dense spot, so that some pillars hold more than P points
        pts[:150, :2] = rng.uniform(0, 0.3, (150, 2)) + [3.0, -5.0]
        frames.append(pillar_inputs(pts.astype(np.float32), JCFG))
    points, counts, coords = (np.stack(x) for x in zip(*frames))
    # two rows on one pillar (the later one wins) and a padding row with
    # features: pillar_scatter's edge cases
    dup = coords.copy()
    dup[0, 5] = dup[0, 2]
    dup[1, 7] = -1
    return dict(points=points, counts=counts, coords=coords, dup=dup,
                feats=rng.randn(2, JCFG.max_voxels, 6).astype(np.float32))


def _variables():
    vp = jnp.zeros((1, JCFG.max_voxels, JCFG.max_points_per_voxel, 4))
    n = jnp.ones((1, JCFG.max_voxels), jnp.int32)
    c = jnp.zeros((1, JCFG.max_voxels, 3), jnp.int32)
    shapes = jax.eval_shape(lambda *a: jpp.PointPillars(JCFG).init(
        KEY, *a, train=False), vp, n, c)
    return seeded_variables(shapes, np.random.RandomState(1))


def _jax_program():
    model = jpp.PointPillars(JCFG)
    vfe = jvfe.PillarVFE(JCFG.pillar_channels, JCFG.voxel_size,
                         JCFG.pc_range)

    @jax.jit
    def run(v, b):
        vfe_vars = {"params": v["params"]["vfe"],
                    "batch_stats": v["batch_stats"]["vfe"]}
        pts, cnt, coords = b["points"], b["counts"], b["coords"]
        train_out, updates = vfe.apply(vfe_vars, pts, cnt, coords, train=True,
                                       mutable=["batch_stats"])
        return dict(
            mean=jax.vmap(jvfe.mean_vfe)(pts, cnt),
            vfe=vfe.apply(vfe_vars, pts, cnt, coords, train=False),
            vfe_train=train_out, stats=updates["batch_stats"],
            canvas=jvfe.pillar_scatter(b["feats"], b["dup"], (64, 48)),
            preds=model.apply(v, pts, cnt, coords, train=False))

    return run


@pytest.fixture(scope="module")
def runs():
    batch = _inputs()
    variables = _variables()
    want = jax.tree_util.tree_map(np.array, _jax_program()(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}))
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = load_flax(tpp.PointPillars(TCFG), variables).eval()
    with torch.no_grad():
        preds = model(t["points"], t["counts"], t["coords"])
    return dict(batch=batch, t=t, want=want, model=model, preds=preds,
                variables=variables)


def test_inputs_cover_the_cases(runs):
    b = runs["batch"]
    assert (b["counts"] == JCFG.max_points_per_voxel).any()
    assert (b["counts"] == 0).any() and (b["coords"][..., 0] < 0).any()


def test_mean_vfe(runs):
    t = runs["t"]
    got = torch.stack([tvfe.mean_vfe(t["points"][i], t["counts"][i])
                       for i in range(2)])
    _tol(got.numpy(), runs["want"]["mean"], "mean")


def test_pillar_vfe_eval_and_train(runs):
    """Eval on the running statistics; training on the valid points'
    statistics, with the running ones moved as flax moves them (momentum
    0.99); empty pillars zero."""
    t, want = runs["t"], runs["want"]
    vfe = runs["model"].vfe
    with torch.no_grad():
        got = vfe(t["points"], t["counts"], t["coords"])
        _tol(got.numpy(), want["vfe"], "eval")
        assert not got[t["counts"] == 0].any()
        vfe.train()
        got = vfe(t["points"], t["counts"], t["coords"])
        vfe.eval()
    _tol(got.numpy(), want["vfe_train"], "train")
    bn, stats = vfe.pfn_bn, want["stats"]["pfn_bn"]
    _tol(bn.running_mean.numpy(), stats["mean"], "running mean")
    _tol(bn.running_var.numpy(), stats["var"], "running var")
    load_flax(runs["model"], runs["variables"])  # the statistics as loaded


def test_pillar_scatter(runs):
    """The canvas exactly: padding rows dropped, the later of two rows on
    one pillar kept."""
    t, b = runs["t"], runs["batch"]
    got = tvfe.pillar_scatter(t["feats"], t["dup"], (64, 48)).numpy()
    np.testing.assert_array_equal(got, runs["want"]["canvas"])
    y, x = b["dup"][0, 5, 1:]
    np.testing.assert_array_equal(got[0, y, x], b["feats"][0, 5])


def test_detector(runs):
    """PointPillars' anchor-head maps, batch 2."""
    for k in ("cls", "box", "dir"):
        _tol(runs["preds"][k].numpy(), runs["want"]["preds"][k], k)
    n_anchors = np.prod(TCFG.bev_size_xy) * 2
    assert runs["preds"]["box"].shape == (2, n_anchors, 7)
    assert runs["model"].anchors.shape == (n_anchors, 7)


def test_weights_carry_at_full_width():
    """`PointPillarConfig()` (KITTI: 432 x 496 pillars, 16 000 of 32
    points): the JAX package's flax tree (shapes from `jax.eval_shape`)
    carries into the port's module with every leaf landing in one entry
    and every entry filled."""
    jcfg, tcfg = jpp.PointPillarConfig(), tpp.PointPillarConfig()
    v, p = 64, jcfg.max_points_per_voxel
    shapes = jax.eval_shape(lambda *a: jpp.PointPillars(jcfg).init(
        KEY, *a, train=False), jnp.zeros((1, v, p, 4)),
        jnp.ones((1, v), jnp.int32), jnp.zeros((1, v, 3), jnp.int32))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    module = tpp.PointPillars(tcfg)
    sd = state_dict_from_flax(module, zeros)
    assert set(sd) == set(module.state_dict())
    assert len(jax.tree_util.tree_leaves(zeros)) == len(
        [k for k in sd if not k.endswith("num_batches_tracked")])
    assert tcfg.bev_size_xy == jcfg.bev_size_xy == (216, 248)
