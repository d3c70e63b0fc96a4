"""The whole camera+LiDAR slice, df3d_torch against df3d: voxelize ->
CenterPoint3DDF (DeepLabV3 image branch, multi-camera ACTRv2 fusion with
IFAT and LT) -> centerpoint_predict, on `__graft_entry__._mesh_cfg()`-sized
LiDAR with 2 cameras of 32x48 and a tiny ACTRv2, same seeded points,
images and rig, flax weights carried across by df3d_torch.weights.

Heatmap logits and the other head maps match to atol = rtol = 1e-3 (a deep
f32 stack in another summation order), boxes to atol 1e-3; voxel coords,
every cap overflow (cap_overflow_dense_tail included) and the kept
(label, slot) sets match exactly. The JAX model runs under `jit`, where
XLA fuses FPS's distance sums into the multiply-add chain the port rounds
like (see df3d_torch/ops/pointops.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d.models.detectors.centerpoint import CenterPointConfig as JConfig
from df3d.models.detectors.centerpoint import (
    centerpoint_predict as jcenterpoint_predict,
)
from df3d.models.detectors.fused import CenterPoint3DDF as JCenterPoint3DDF
from df3d.models.detectors.fused import FusedConfig as JFusedConfig
from df3d.models.fusion.actr import ACTRConfig as JACTRConfig
from df3d.ops.voxelize import voxelize_batch as jvoxelize_batch
from df3d_torch.entry import infer_fused
from df3d_torch.models.detectors.centerpoint import CenterPointConfig
from df3d_torch.models.detectors.fused import CenterPoint3DDF, FusedConfig
from df3d_torch.models.fusion.actr import ACTRConfig
from df3d_torch.ops.voxelize import voxelize_batch
from df3d_torch.utils.synth import camera_rig
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
ACTR = dict(d_model=16, n_heads=2, n_points=2, n_levels=2, num_layers=1,
            dim_feedforward=32, lt_npoint=8, lt_nsample=4,
            model_name="ACTRv2", q_method="gating",
            attn_layer="BiGateSum1D_2")
FUSED = dict(image_shape=(32, 48), image_branch="deeplabv3",
             image_layers=(1, 1, 1, 1), n_levels=2, num_cams=2,
             use_ifat=True, fusion_downsample=8)


def _hm_logits_moderate(names, v):
    """Keep heatmap logits near the -2.19 prior, away from the sigmoid
    clamp, so the score order is not decided by rounding."""
    if "_hm" in "".join(names) and names[-2] == "Conv_1":
        return v * 0.1 if names[-1] == "kernel" else v - 2.19
    return v


@pytest.fixture(scope="module")
def fused_run():
    rng = np.random.RandomState(0)
    b, n = 1, 512  # the serving batch; tests/test_torch_fusion.py
    # holds the fusion hook at batch 2
    points = np.concatenate([rng.uniform(-15, 15, (b, n, 2)),
                             rng.uniform(-1.8, 1.8, (b, n, 1)),
                             rng.uniform(0, 1, (b, n, 2))], -1)
    points = points.astype(np.float32)
    valid = np.ones((b, n), bool)
    images = rng.randn(b, 2, 32, 48, 3).astype(np.float32)
    proj = np.broadcast_to(camera_rig(2, (32, 48)), (b, 2, 3, 4)).copy()

    jcfg = JConfig(**CFG)
    jfused = JFusedConfig(actr=JACTRConfig(**ACTR), **FUSED)
    jmodel = JCenterPoint3DDF(jcfg, jfused)

    def jvoxelize(p, v):
        return jvoxelize_batch(p, v, jcfg.voxel_size, jcfg.pc_range,
                               jcfg.grid_size, jcfg.max_voxels,
                               jcfg.max_points_per_voxel)

    jin = [jnp.asarray(a) for a in (points, valid, images, proj)]
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *jvoxelize(*jin[:2])[:2], *jin[2:],
        train=False))
    variables = seeded_variables(shapes, np.random.RandomState(1),
                                 _hm_logits_moderate)

    @jax.jit  # one program: compiling it costs less than eager dispatch
    def jrun(v, p, val, im, pr):
        r = jvoxelize(p, val)
        (preds, _), inter = jmodel.apply(v, r.features, r.coords, im, pr,
                                         train=False,
                                         mutable=["intermediates"])
        return r, preds, inter, jcenterpoint_predict(jcfg, preds)

    res, jpreds, inter, jdet = jrun(variables, *jin)

    cfg = CenterPointConfig(**CFG)
    model = load_flax(CenterPoint3DDF(
        cfg, FusedConfig(actr=ACTRConfig(**ACTR), **FUSED)), variables)
    seen = []
    model.detector.backbone.fusion_hook.actr.register_forward_hook(
        lambda mod, inp, out: seen.append(inp[4].clone()))
    tpoints, tvalid = torch.from_numpy(points), torch.from_numpy(valid)
    timages, tproj = torch.from_numpy(images), torch.from_numpy(proj)
    tres = voxelize_batch(tpoints, tvalid, cfg.voxel_size, cfg.pc_range,
                          cfg.grid_size, cfg.max_voxels,
                          cfg.max_points_per_voxel)
    with torch.no_grad():
        tpreds, _, overflow = model(tres.features, tres.coords, timages,
                                    tproj)
    tdet, overflow2 = infer_fused(model, cfg, tpoints, tvalid, timages, tproj)
    return dict(jres=res, jpreds=jpreds, jdet=jdet,
                jinter=inter["intermediates"]["detector"]["backbone"],
                tres=tres, tpreds=tpreds, overflow=overflow, tdet=tdet,
                overflow2=overflow2, q_mask=seen[0])


def test_voxels_and_cap_overflow(fused_run):
    r = fused_run
    np.testing.assert_array_equal(r["tres"].coords.numpy(),
                                  np.asarray(r["jres"].coords))
    assert "cap_overflow_dense_tail" in r["overflow"]
    assert set(r["overflow"]) == {k for k in r["jinter"]
                                  if k.startswith("cap_overflow")}
    for name, t in r["overflow"].items():
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(r["jinter"][name][0]))
        np.testing.assert_array_equal(t.numpy(), r["overflow2"][name].numpy())


def test_cameras_see_voxels(fused_run):
    """Both cameras of the rig see some stage-4 voxels, and not all."""
    seen = fused_run["q_mask"].view(1, 2, -1)
    assert seen.any(-1).all() and not seen.all()


def test_head_maps(fused_run):
    r = fused_run
    for tp, jp in zip(r["tpreds"], r["jpreds"]):
        assert set(tp) == set(jp)
        for name in jp:
            np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                       atol=1e-3, rtol=1e-3, err_msg=name)


def test_detections(fused_run):
    t, j = fused_run["tdet"], fused_run["jdet"]
    valid = np.asarray(j["valid"])
    assert valid.any()
    np.testing.assert_array_equal(t["valid"].numpy(), valid)
    np.testing.assert_array_equal(t["labels"].numpy()[valid],
                                  np.asarray(j["labels"])[valid])
    np.testing.assert_allclose(t["boxes"].numpy()[valid],
                               np.asarray(j["boxes"])[valid], atol=1e-3)
    np.testing.assert_allclose(t["scores"].numpy(), np.asarray(j["scores"]),
                               atol=1e-5)
