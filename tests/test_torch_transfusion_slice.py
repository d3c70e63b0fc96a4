"""The TransFusion serving slices, df3d_torch against df3d: voxelize ->
TransFusionL -> transfusion_predict, and voxelize -> TransFusion3DDF
(ResNet + FPN image branch, the multi-camera ACTRv2 hook with IFAT and two
LT + dual-query layers on one image level, q_method "sum", as the
`transfusion_3ddf_nusc` preset) -> transfusion_predict. Tiny LiDAR config
(tests/test_transfusion_e2e.py's), batch 2, 2 cameras of 64x112 (FPN
levels that do not halve exactly), a tiny ACTR; same seeded points,
images and rig, flax weights carried across by df3d_torch.weights. Both
JAX models run under one `jit`, where XLA fuses FPS's distance sums into
the multiply-add chain the port rounds like.

Voxel coords, every cap overflow (cap_overflow_dense_tail included),
query labels and positions, and the FPS and ball-query indices of both LT
passes match exactly; the dense heatmap and every head branch to atol =
rtol = 1e-3 (a deep f32 stack in another summation order), boxes and
scores to 1e-3."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d.models.detectors.fused import FusedConfig as JFusedConfig
from df3d.models.detectors.fused import TransFusion3DDF as JTransFusion3DDF
from df3d.models.detectors.transfusion import TransFusionConfig as JConfig
from df3d.models.detectors.transfusion import TransFusionL as JTransFusionL
from df3d.models.detectors.transfusion import (
    transfusion_predict as jtransfusion_predict,
)
from df3d.models.fusion.actr import ACTRConfig as JACTRConfig
from df3d.models.heads.transfusion_head import TransFusionHeadCfg as JHeadCfg
from df3d.ops import pointops as jpo
from df3d.ops.voxelize import voxelize_batch as jvoxelize_batch
from df3d_torch.entry import infer_transfusion, infer_transfusion_fused
from df3d_torch.models.detectors.fused import FusedConfig, TransFusion3DDF
from df3d_torch.models.detectors.transfusion import (
    TransFusionConfig, TransFusionL,
)
from df3d_torch.models.fusion import pointformer
from df3d_torch.models.fusion.actr import ACTRConfig
from df3d_torch.models.heads.transfusion_head import TransFusionHeadCfg
from df3d_torch.ops.voxelize import voxelize_batch
from df3d_torch.utils.synth import camera_rig
from torch_port_helpers import load_flax, seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

HEAD = dict(num_classes=3, num_proposals=16, hidden_channel=32, num_heads=4,
            ffn_channel=64, small_classes=(2,), bev_size=(8, 8),
            out_size_factor=8, voxel_size=(0.5, 0.5), pc_range=(-16.0, -16.0))
CFG = dict(pc_range=(-16.0, -16.0, -2.4, 16.0, 16.0, 2.4),
           voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64),
           max_voxels=512, num_point_features=4,
           stage_caps=(1024, 512, 256, 128))
# the preset's ACTR (one level, two layers, q_method "sum"), narrowed
ACTR = dict(d_model=16, n_heads=2, n_points=2, n_levels=1, num_layers=2,
            dim_feedforward=32, lt_npoint=8, lt_nsample=4,
            model_name="ACTRv2", q_method="sum", attn_layer="BiGateSum1D_2",
            hybrid=True)
FUSED = dict(image_shape=(64, 112), image_branch="resnet_fpn",
             image_layers=(1, 1, 1, 1), n_levels=1, num_cams=2,
             use_ifat=True, fusion_downsample=8)
B, N_POINTS = 2, 500
HOOK_LEAVES = ("ifat", "actr", "actr_out_proj")


def _record(calls, fn):
    def recording(*args):
        out = fn(*args)
        calls.append(([a.clone() if torch.is_tensor(a) else a for a in args],
                      out))
        return out
    return recording


@pytest.fixture(scope="module")
def run():
    rng = np.random.RandomState(0)
    points = np.concatenate([rng.uniform(-15, 15, (B, N_POINTS, 2)),
                             rng.uniform(-1.8, 1.8, (B, N_POINTS, 1)),
                             rng.uniform(0, 1, (B, N_POINTS, 1))], -1)
    points = points.astype(np.float32)
    valid = rng.rand(B, N_POINTS) > 0.05
    images = rng.randn(B, 2, 64, 112, 3).astype(np.float32)
    proj = np.broadcast_to(camera_rig(2, (64, 112)), (B, 2, 3, 4)).copy()

    jcfg = JConfig(head=JHeadCfg(**HEAD), **CFG)
    jfused = JFusedConfig(actr=JACTRConfig(**ACTR), **FUSED)
    jlidar, jmodel = JTransFusionL(jcfg), JTransFusion3DDF(jcfg, jfused)

    def jvoxelize(p, v):
        return jvoxelize_batch(p, v, jcfg.voxel_size, jcfg.pc_range,
                               jcfg.grid_size, jcfg.max_voxels,
                               jcfg.max_points_per_voxel)

    jin = [jnp.asarray(a) for a in (points, valid, images, proj)]
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *jvoxelize(*jin[:2])[:2], *jin[2:],
        train=False))
    fused_vars = seeded_variables(shapes, np.random.RandomState(1))
    # TransFusion-L's tree is the fused detector's without the hook
    det = fused_vars["params"]["detector"]
    lidar_vars = {
        "params": dict(det, middle_encoder={
            k: v for k, v in det["middle_encoder"].items()
            if k not in HOOK_LEAVES}),
        "batch_stats": dict(
            fused_vars["batch_stats"]["detector"],
            middle_encoder={
                k: v for k, v in
                fused_vars["batch_stats"]["detector"]["middle_encoder"].items()
                if k not in HOOK_LEAVES})}

    @jax.jit  # one program: compiling it costs less than eager dispatch
    def jrun(fv, lv, p, val, im, pr):
        r = jvoxelize(p, val)
        (fpreds, _), finter = jmodel.apply(fv, r.features, r.coords, im, pr,
                                           train=False,
                                           mutable=["intermediates"])
        (lpreds, _), linter = jlidar.apply(lv, r.features, r.coords,
                                           train=False,
                                           mutable=["intermediates"])
        return (r, lpreds, linter, jtransfusion_predict(jcfg, lpreds),
                fpreds, finter, jtransfusion_predict(jcfg, fpreds))

    (res, jl_preds, jl_inter, jl_det, jf_preds, jf_inter,
     jf_det) = jrun(fused_vars, lidar_vars, *jin)

    cfg = TransFusionConfig(head=TransFusionHeadCfg(**HEAD), **CFG)
    lidar = load_flax(TransFusionL(cfg), lidar_vars)
    model = load_flax(TransFusion3DDF(
        cfg, FusedConfig(actr=ACTRConfig(**ACTR), **FUSED)), fused_vars)
    tin = [torch.from_numpy(a) for a in (points, valid, images, proj)]
    tres = voxelize_batch(tin[0], tin[1], cfg.voxel_size, cfg.pc_range,
                          cfg.grid_size, cfg.max_voxels,
                          cfg.max_points_per_voxel)
    fps_calls, ball_calls, seen = [], [], []
    model.detector.middle_encoder.fusion_hook.actr.register_forward_hook(
        lambda mod, inp, out: seen.append(inp[4].clone()))
    mp = pytest.MonkeyPatch()
    mp.setattr(pointformer, "furthest_point_sample",
               _record(fps_calls, pointformer.furthest_point_sample))
    mp.setattr(pointformer, "ball_query",
               _record(ball_calls, pointformer.ball_query))
    try:
        with torch.no_grad():
            tl_preds, _, tl_over = lidar(tres.features, tres.coords)
            tf_preds, _, tf_over = model(tres.features, tres.coords,
                                         *tin[2:])
    finally:
        mp.undo()
    tl_det, tl_over2 = infer_transfusion(lidar, cfg, *tin[:2])
    tf_det, tf_over2 = infer_transfusion_fused(model, cfg, *tin)
    return dict(
        res=res, tres=tres, fps_calls=fps_calls, ball_calls=ball_calls,
        q_mask=seen[0], lidar_vars=lidar_vars, fused_vars=fused_vars,
        lidar=dict(jpreds=jl_preds, jdet=jl_det,
                   jinter=jl_inter["intermediates"]["middle_encoder"],
                   tpreds=tl_preds, over=tl_over, tdet=tl_det,
                   over2=tl_over2),
        fused=dict(jpreds=jf_preds, jdet=jf_det,
                   jinter=jf_inter["intermediates"]["detector"][
                       "middle_encoder"],
                   tpreds=tf_preds, over=tf_over, tdet=tf_det,
                   over2=tf_over2))


PATHS = ["lidar", "fused"]


def test_voxels(run):
    np.testing.assert_array_equal(run["tres"].coords.numpy(),
                                  np.asarray(run["res"].coords))
    np.testing.assert_array_equal(run["tres"].features.numpy(),
                                  np.asarray(run["res"].features))


@pytest.mark.parametrize("path", PATHS)
def test_cap_overflow(run, path):
    r = run[path]
    names = {k for k in r["jinter"] if k.startswith("cap_overflow")}
    assert set(r["over"]) == names
    assert ("cap_overflow_dense_tail" in names) == (path == "fused")
    for name, t in r["over"].items():
        np.testing.assert_array_equal(t.numpy(),
                                      np.asarray(r["jinter"][name][0]))
        np.testing.assert_array_equal(t.numpy(), r["over2"][name].numpy())


@pytest.mark.parametrize("path", PATHS)
def test_head(run, path):
    r = run[path]
    t, j = r["tpreds"], r["jpreds"]
    assert set(t) == set(j)
    np.testing.assert_array_equal(t["query_labels"].numpy(),
                                  np.asarray(j["query_labels"]))
    np.testing.assert_array_equal(t["query_pos_xy"].numpy(),
                                  np.asarray(j["query_pos_xy"]))
    for name in j:
        np.testing.assert_allclose(t[name].numpy(), np.asarray(j[name]),
                                   atol=1e-3, rtol=1e-3, err_msg=name)


@pytest.mark.parametrize("path", PATHS)
def test_detections(run, path):
    t, j = run[path]["tdet"], run[path]["jdet"]
    assert t["boxes"].shape == (B, HEAD["num_proposals"], 9)
    np.testing.assert_array_equal(t["labels"].numpy(), np.asarray(j["labels"]))
    np.testing.assert_allclose(t["boxes"].numpy(), np.asarray(j["boxes"]),
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(t["scores"].numpy(), np.asarray(j["scores"]),
                               atol=1e-3)


def test_fusion_changes_the_result(run):
    """The hook is live: the fused head's inputs differ from the LiDAR
    path's on the same voxels."""
    a = run["lidar"]["tpreds"]["dense_heatmap"]
    b = run["fused"]["tpreds"]["dense_heatmap"]
    assert (a - b).abs().max() > 1e-3


def test_cameras_see_voxels(run):
    """Both cameras of the rig see some stride-8 voxels, and not all."""
    seen = run["q_mask"].view(B, 2, -1)
    assert seen.any(-1).all() and not seen.all()


def test_lt_fps_and_ball_query(run):
    """Both LT passes: the port's FPS centres and ball-query neighbours on
    the inputs it was given equal the JAX package's under `jit`."""
    assert len(run["fps_calls"]) == len(run["ball_calls"]) == 2
    for (args, got), (bargs, (bidx, bmask)) in zip(run["fps_calls"],
                                                   run["ball_calls"]):
        xyz, valid, npoint, chunks = args
        fps = jax.jit(lambda x, v: jpo.furthest_point_sample(
            x, v, npoint, chunks))
        centers, bxyz, bvalid, radius, k = bargs
        ball = jax.jit(lambda c, x, v: jpo.ball_query(c, x, v, radius, k))
        for s in range(xyz.shape[0]):
            want = np.asarray(fps(xyz[s].numpy(), valid[s].numpy()))
            np.testing.assert_array_equal(got[s].numpy(), want)
            wi, wm = ball(centers[s].numpy(), bxyz[s].numpy(),
                          bvalid[s].numpy())
            np.testing.assert_array_equal(bmask[s].numpy(), np.asarray(wm))
            np.testing.assert_array_equal(bidx[s].numpy(), np.asarray(wi))
        assert bmask.any()


@pytest.mark.parametrize("path", PATHS)
def test_weights_fill_every_entry(run, path):
    """Every flax leaf of the tree has a torch entry and every torch entry
    (but BatchNorm's step counters) a leaf."""
    from df3d_torch.weights import state_dict_from_flax

    variables = run[f"{path}_vars"]
    cfg = TransFusionConfig(head=TransFusionHeadCfg(**HEAD), **CFG)
    model = (TransFusionL(cfg) if path == "lidar" else TransFusion3DDF(
        cfg, FusedConfig(actr=ACTRConfig(**ACTR), **FUSED)))
    sd = state_dict_from_flax(model, variables)
    leaves = sum(1 for _ in jax.tree_util.tree_leaves(variables))
    counters = sum(k.endswith("num_batches_tracked") for k in sd)
    assert len(sd) - counters == leaves
    assert set(sd) == set(model.state_dict())
