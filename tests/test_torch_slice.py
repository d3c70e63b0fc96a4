"""The whole serving slice, df3d_torch against df3d: voxelize -> CenterPoint
-> centerpoint_predict on a small config, same seeded points, flax weights
carried across by df3d_torch.weights; the JAX side under one `jit`. Heatmap logits match to atol = rtol =
1e-3, boxes to atol 1e-3; voxel coords, cap overflows and kept (label,
slot) sets match exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d.models.detectors.centerpoint import CenterPoint as JCenterPoint
from df3d.models.detectors.centerpoint import CenterPointConfig as JConfig
from df3d.models.detectors.centerpoint import (
    centerpoint_predict as jcenterpoint_predict,
)
from df3d.ops.voxelize import voxelize_batch as jvoxelize_batch
from df3d_torch.entry import infer
from df3d_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointConfig,
)
from df3d_torch.ops.voxelize import voxelize_batch
from torch_port_helpers import load_flax, seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

# __graft_entry__._mesh_cfg()
CFG = dict(
    pc_range=(-16.0, -16.0, -2.4, 16.0, 16.0, 2.4),
    voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64),
    max_voxels=256, num_point_features=5, stage_caps=(256, 128, 96, 64),
    tasks=(1, 2), max_objs=8, nms_pre_max_size=32, nms_post_max_size=4,
    post_center_range=(-20.0, -20.0, -4.0, 20.0, 20.0, 4.0),
)


def _hm_logits_moderate(names, v):
    """Keep heatmap logits near the -2.19 prior, away from the sigmoid
    clamp, so the score order is not decided by rounding."""
    if "_hm" in "".join(names) and names[-2] == "Conv_1":
        return v * 0.1 if names[-1] == "kernel" else v - 2.19
    return v


@pytest.fixture(scope="module")
def slice_run():
    rng = np.random.RandomState(0)
    b, n = 2, 512
    points = np.concatenate([rng.uniform(-15, 15, (b, n, 2)),
                             rng.uniform(-1.8, 1.8, (b, n, 1)),
                             rng.uniform(0, 1, (b, n, 2))], -1)
    points = points.astype(np.float32)
    valid = np.ones((b, n), bool)

    jcfg = JConfig(**CFG)
    jmodel = JCenterPoint(jcfg)

    def voxelize(p, v):
        return jvoxelize_batch(p, v, jcfg.voxel_size, jcfg.pc_range,
                               jcfg.grid_size, jcfg.max_voxels,
                               jcfg.max_points_per_voxel)

    def init(p, v):
        res = voxelize(p, v)
        return jmodel.init(jax.random.PRNGKey(0), res.features, res.coords,
                           train=False)

    @jax.jit
    def run(variables, p, v):
        res = voxelize(p, v)
        (preds, _), inter = jmodel.apply(variables, res.features, res.coords,
                                         train=False,
                                         mutable=["intermediates"])
        return res, preds, inter, jcenterpoint_predict(jcfg, preds)

    jp, jv = jnp.asarray(points), jnp.asarray(valid)
    shapes = jax.eval_shape(init, jp, jv)
    variables = seeded_variables(shapes, np.random.RandomState(1),
                                 _hm_logits_moderate)
    res, jpreds, inter, jdet = run(variables, jp, jv)

    cfg = CenterPointConfig(**CFG)
    model = load_flax(CenterPoint(cfg), variables)
    tpoints, tvalid = torch.from_numpy(points), torch.from_numpy(valid)
    tres = voxelize_batch(tpoints, tvalid, cfg.voxel_size, cfg.pc_range,
                          cfg.grid_size, cfg.max_voxels,
                          cfg.max_points_per_voxel)
    tpreds, _, overflow = model(tres.features, tres.coords)
    tdet, overflow2 = infer(model, cfg, tpoints, tvalid)
    return dict(jres=res, jpreds=jpreds, jdet=jdet,
                jinter=inter["intermediates"]["backbone"], tres=tres,
                tpreds=tpreds, overflow=overflow, tdet=tdet,
                overflow2=overflow2)


def test_voxels_and_cap_overflow(slice_run):
    r = slice_run
    np.testing.assert_array_equal(r["tres"].coords.numpy(),
                                  np.asarray(r["jres"].coords))
    for name, t in r["overflow"].items():
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(r["jinter"][name][0]))
        np.testing.assert_array_equal(t.numpy(), r["overflow2"][name].numpy())


def test_head_maps(slice_run):
    r = slice_run
    for tp, jp in zip(r["tpreds"], r["jpreds"]):
        assert set(tp) == set(jp)
        for name in jp:
            np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                       atol=1e-3, rtol=1e-3, err_msg=name)


def test_detections(slice_run):
    t, j = slice_run["tdet"], slice_run["jdet"]
    valid = np.asarray(j["valid"])
    assert valid.any()
    np.testing.assert_array_equal(t["valid"].numpy(), valid)
    np.testing.assert_array_equal(t["labels"].numpy()[valid],
                                  np.asarray(j["labels"])[valid])
    np.testing.assert_allclose(t["boxes"].numpy()[valid],
                               np.asarray(j["boxes"])[valid], atol=1e-3)
    np.testing.assert_allclose(t["scores"].numpy(), np.asarray(j["scores"]),
                               atol=1e-5)
