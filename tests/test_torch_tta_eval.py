"""CenterPoint's eval step with det3d's double-flip TTA and the batch-norm
recalibration, df3d_torch against df3d.

* The expansions (points, projections, images) equal the JAX package's
  bit for bit.
* The batch-4 head maps of a small CenterPoint and a small CenterPoint +
  3D-DF (two 32x48 cameras, a tiny ACTRv2) equal JAX's `model.apply` on the
  expanded inputs to atol = rtol = 1e-3, as the serving slices hold them;
  the JAX side runs one jitted voxelize + apply on each of the four
  variants (in eval mode each sample's maps are its own).
* The merge follows the targets' geometry, not the JAX package's merge
  (ROADMAP section 3): on hm, height, dim and vel it equals the JAX
  package's bit for bit; on reg and rot, boxes and their three reflections
  drawn through the port's `assign_center_targets` and merged give back
  the identity variant's values at the centres, which the JAX package's
  merge misses by half a cell on each axis (one cell per flipped variant)
  and by the sign of sin.
* The whole eval step equals JAX's pieces composed with that geometric
  merge, written in jnp below: kept sets and labels equal, boxes to 1e-3,
  scores to 1e-5.
* `recalibrate_batch_stats` equals the JAX package's function fed the
  port's statistics before and after one training forward (numpy: nothing
  compiles), recovers the batch statistics at each norm's own momentum
  (CenterPoint's 0.99, TransFusion's 0.9 FFN and position-embedding norms),
  and leaves a frozen image branch's norms as they were.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d.models import tta as jtta
from df3d.models.detectors.centerpoint import CenterPoint as JCenterPoint
from df3d.models.detectors.centerpoint import CenterPointConfig as JConfig
from df3d.models.detectors.centerpoint import (
    centerpoint_predict as jcenterpoint_predict,
)
from df3d.models.detectors.fused import CenterPoint3DDF as JCenterPoint3DDF
from df3d.models.detectors.fused import FusedConfig as JFusedConfig
from df3d.models.fusion.actr import ACTRConfig as JACTRConfig
from df3d.ops.voxelize import voxelize_batch as jvoxelize_batch
from df3d.train.trainer import (
    recalibrate_batch_stats as jrecalibrate_batch_stats,
)
import df3d_torch.models.layers as tlayers
from df3d_torch.core.target_utils import assign_center_targets
from df3d_torch.entry import infer, infer_fused
from df3d_torch.models import tta
from df3d_torch.models.detectors.centerpoint import (
    CenterPoint, CenterPointConfig,
)
from df3d_torch.models.detectors.fused import CenterPoint3DDF, FusedConfig
from df3d_torch.models.detectors.transfusion import (
    TransFusionConfig, TransFusionL,
)
from df3d_torch.models.fusion.actr import ACTRConfig
from df3d_torch.models.heads.transfusion_head import TransFusionHeadCfg
from df3d_torch.models.layers import FlaxBatchNorm, MaskedBatchNorm
from df3d_torch.ops.voxelize import voxelize_batch
from df3d_torch.train.trainer import (
    make_centerpoint_eval_step, recalibrate_batch_stats,
)
from df3d_torch.utils.synth import camera_rig
from torch_port_helpers import load_flax, seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

# __graft_entry__._mesh_cfg(), as tests/test_torch_slice.py
CFG = dict(
    pc_range=(-16.0, -16.0, -2.4, 16.0, 16.0, 2.4),
    voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64),
    max_voxels=256, num_point_features=5, stage_caps=(256, 128, 96, 64),
    tasks=(1, 2), max_objs=8, nms_pre_max_size=32, nms_post_max_size=4,
    post_center_range=(-20.0, -20.0, -4.0, 20.0, 20.0, 4.0),
)
# tests/test_torch_fused_slice.py's camera+LiDAR config
ACTR = dict(d_model=16, n_heads=2, n_points=2, n_levels=2, num_layers=1,
            dim_feedforward=32, lt_npoint=8, lt_nsample=4,
            model_name="ACTRv2", q_method="gating",
            attn_layer="BiGateSum1D_2")
FUSED = dict(image_shape=(32, 48), image_branch="deeplabv3",
             image_layers=(1, 1, 1, 1), n_levels=2, num_cams=2,
             use_ifat=True, fusion_downsample=8)
MAP_TOL = dict(atol=1e-3, rtol=1e-3)


def _hm_logits_moderate(names, v):
    """Keep heatmap logits near the -2.19 prior, away from the sigmoid
    clamp, so the score order is not decided by rounding."""
    if "_hm" in "".join(names) and names[-2] == "Conv_1":
        return v * 0.1 if names[-1] == "kernel" else v - 2.19
    return v


def geometric_merge(preds):
    """The un-flip of the targets' geometry in jnp: a reflected axis maps
    cell i to n - 1 - i and a sub-cell offset to 1 - offset; (sin, cos)
    loses sin's sign under flip_y, cos's under flip_x, both under
    flip_both; vel as the JAX package's merge."""
    merged = []
    for task in preds:
        out = {}
        for name, m in task.items():
            m = m.reshape(m.shape[0] // 4, 4, *m.shape[1:])
            m1, m2, m3 = m[:, 1, ::-1], m[:, 2, :, ::-1], m[:, 3, ::-1, ::-1]
            if name == "reg":
                m1 = m1.at[..., 1].set(1.0 - m1[..., 1])
                m2 = m2.at[..., 0].set(1.0 - m2[..., 0])
                m3 = 1.0 - m3
            elif name == "rot":
                m1 = m1.at[..., 0].multiply(-1.0)
                m2 = m2.at[..., 1].multiply(-1.0)
                m3 = -m3
            elif name == "vel":
                m1 = m1.at[..., 1].multiply(-1.0)
                m2 = m2.at[..., 0].multiply(-1.0)
                m3 = -m3
            out[name] = (m[:, 0] + m1 + m2 + m3) / 4.0
        merged.append(out)
    return merged


@jax.jit  # one program for both models' maps (their heads are alike)
def _jdecode(preds):
    """The geometric merge, the JAX package's merge and predict on the
    geometric merge."""
    geo = geometric_merge(preds)
    return (geo, jtta.merge_center_head_maps(preds),
            jcenterpoint_predict(JConfig(**CFG), geo))


def _points(rng, b, n=512):
    return np.concatenate([rng.uniform(-15, 15, (b, n, 2)),
                           rng.uniform(-1.8, 1.8, (b, n, 1)),
                           rng.uniform(0, 1, (b, n, 2))], -1).astype(np.float32)


def _run(fused: bool):
    """Both packages' double-flip eval of one sample: JAX's pieces (expand;
    voxelize and apply, one jitted program run on each variant; geometric
    merge and predict, jitted), the port's eval step with its head maps
    captured."""
    rng = np.random.RandomState(0)
    b = 1
    inputs = [_points(rng, b), np.ones((b, 512), bool)]
    if fused:
        inputs += [rng.randn(b, 2, 32, 48, 3).astype(np.float32),
                   np.broadcast_to(camera_rig(2, (32, 48)),
                                   (b, 2, 3, 4)).copy()]
    jcfg = JConfig(**CFG)
    jmodel = (JCenterPoint3DDF(jcfg, JFusedConfig(actr=JACTRConfig(**ACTR),
                                                  **FUSED))
              if fused else JCenterPoint(jcfg))

    def jvoxelize(p, v):
        return jvoxelize_batch(p, v, jcfg.voxel_size, jcfg.pc_range,
                               jcfg.grid_size, jcfg.max_voxels,
                               jcfg.max_points_per_voxel)

    def expand(p, v, *cams):
        p, v = jtta.expand_points_double_flip(p), jnp.repeat(v, 4, axis=0)
        if cams:
            cams = (jtta.expand_images_double_flip(cams[0]),
                    jtta.expand_proj_double_flip(cams[1]))
        return (p, v, *cams)

    jin = [jnp.asarray(a) for a in inputs]
    shapes = jax.eval_shape(lambda: jmodel.init(
        jax.random.PRNGKey(0), *jvoxelize(*jin[:2])[:2], *jin[2:],
        train=False))
    variables = seeded_variables(shapes, np.random.RandomState(1),
                                 _hm_logits_moderate)

    # one jitted program a variant (XLA's compile grows with the batch:
    # ~37 s at batch 4 against ~83 s at batch 8 under a tier-1 run's load),
    # run on each of the four expanded variants
    @jax.jit
    def japply(v, p, val, *cams):
        r = jvoxelize(p, val)
        preds, _ = jmodel.apply(v, r.features, r.coords, *cams, train=False)
        return r.coords, preds

    jexp = expand(*jin)
    outs = [japply(variables, *(a[i:i + 1] for a in jexp))
            for i in range(4 * b)]
    jcoords = jnp.concatenate([c for c, _ in outs])
    jpreds = jax.tree_util.tree_map(lambda *x: jnp.concatenate(x),
                                    *[p for _, p in outs])
    jgeo, jpkg, jdet = _jdecode(jpreds)

    cfg = CenterPointConfig(**CFG)
    model = (CenterPoint3DDF(cfg, FusedConfig(actr=ACTRConfig(**ACTR),
                                              **FUSED))
             if fused else CenterPoint(cfg))
    model = load_flax(model, variables)
    head = model.detector.head if fused else model.head
    seen = []
    head.register_forward_hook(lambda mod, inp, out: seen.append(out))
    tin = [torch.from_numpy(a) for a in inputs]
    keys = ("points", "points_valid", "images", "proj")
    batch = dict(zip(keys, tin))
    det = make_centerpoint_eval_step(model, cfg, "double_flip", fused)(batch)
    texp = tta.expand_points_double_flip(tin[0])
    tres = voxelize_batch(texp, tin[1].repeat_interleave(4, 0),
                          cfg.voxel_size, cfg.pc_range, cfg.grid_size,
                          cfg.max_voxels, cfg.max_points_per_voxel)
    return dict(inputs=inputs, variables=variables,
                jcoords=jcoords, jpreds=jpreds, jgeo=jgeo, jpkg=jpkg,
                jdet=jdet, model=model, cfg=cfg, batch=batch, tpreds=seen[0],
                tcoords=tres.coords, tdet=det)


@pytest.fixture(scope="module", params=["lidar", "fused"])
def run(request):
    return _run(request.param == "fused")


def test_expansions_equal_jax():
    """Points, valid masks, images and composed projections of two samples
    (sample-major variants) equal the JAX package's expansions bit for
    bit."""
    rng = np.random.RandomState(2)
    b = 2
    inputs = [_points(rng, b, 64), rng.rand(b, 64) < 0.9,
              rng.randn(b, 2, 4, 6, 3).astype(np.float32),
              rng.randn(b, 2, 3, 4).astype(np.float32)]
    inputs[0][0, :3, :2] = 0.0  # signed zeros
    p, v, im, pr = (jnp.asarray(a) for a in inputs)
    jexp = (jtta.expand_points_double_flip(p), jnp.repeat(v, 4, axis=0),
            jtta.expand_images_double_flip(im),
            jtta.expand_proj_double_flip(pr))
    p, v, im, pr = (torch.from_numpy(a) for a in inputs)
    texp = (tta.expand_points_double_flip(p), v.repeat_interleave(4, 0),
            tta.expand_images_double_flip(im), tta.expand_proj_double_flip(pr))
    for t, j in zip(texp, jexp):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_flipped_points_project_to_the_same_pixels():
    """P' (F x) = P x for every variant of the composed projections."""
    rng = np.random.RandomState(5)
    proj = torch.from_numpy(rng.randn(2, 3, 3, 4).astype(np.float32))
    pts = torch.from_numpy(rng.randn(2, 7, 4).astype(np.float32))
    p4 = tta.expand_points_double_flip(pts)
    proj4 = tta.expand_proj_double_flip(proj)
    hom = torch.cat([pts[..., :3], torch.ones(2, 7, 1)], -1)
    hom4 = torch.cat([p4[..., :3], torch.ones(8, 7, 1)], -1)
    want = torch.einsum("bcij,bnj->bcni", proj, hom)
    got = torch.einsum("bcij,bnj->bcni", proj4, hom4)
    torch.testing.assert_close(got.view(2, 4, 3, 7, 3),
                               want[:, None].expand(2, 4, 3, 7, 3))


def test_batch4_head_maps(run):
    np.testing.assert_array_equal(run["tcoords"].numpy(),
                                  np.asarray(run["jcoords"]))
    assert run["tpreds"][0]["hm"].shape[0] == 4 * run["inputs"][0].shape[0]
    for tp, jp in zip(run["tpreds"], run["jpreds"]):
        assert set(tp) == set(jp)
        for name in jp:
            np.testing.assert_allclose(tp[name].numpy(), np.asarray(jp[name]),
                                       **MAP_TOL, err_msg=name)


def test_merge_against_jax(run):
    """On the JAX program's own batch-4 maps: the port's merge equals the
    JAX package's bit for bit on hm, height, dim and vel, and the
    geometric merge (jnp) on every map."""
    jpreds = [{k: torch.from_numpy(np.array(v)) for k, v in t.items()}
              for t in run["jpreds"]]
    merged = tta.merge_center_head_maps(jpreds)
    for got, pkg, geo in zip(merged, run["jpkg"], run["jgeo"]):
        for name in ("hm", "height", "dim", "vel"):
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(pkg[name]))
        for name in got:
            np.testing.assert_array_equal(got[name].numpy(),
                                          np.asarray(geo[name]))


def test_eval_step_detections(run):
    """The port's double-flip eval step against JAX's pieces composed with
    the geometric merge."""
    t, j = run["tdet"], run["jdet"]
    valid = np.asarray(j["valid"])
    assert valid.any() and t["boxes"].shape[0] == run["inputs"][0].shape[0]
    np.testing.assert_array_equal(t["valid"].numpy(), valid)
    np.testing.assert_array_equal(t["labels"].numpy()[valid],
                                  np.asarray(j["labels"])[valid])
    np.testing.assert_allclose(t["boxes"].numpy()[valid],
                               np.asarray(j["boxes"])[valid], atol=1e-3)
    np.testing.assert_allclose(t["scores"].numpy(), np.asarray(j["scores"]),
                               atol=1e-5)


def test_eval_step_without_tta_is_infer(run):
    model, cfg, batch = run["model"], run["cfg"], run["batch"]
    fused = "images" in batch
    got = make_centerpoint_eval_step(model, cfg, None, fused)(batch)
    serve = infer_fused if fused else infer
    want, _ = serve(model, cfg, *batch.values())
    for k in want:
        assert torch.equal(got[k], want[k]), k
    with pytest.raises(ValueError, match="tta"):
        make_centerpoint_eval_step(model, cfg, "flip_x")


# the round trip: a symmetric 16x16 BEV map of 2 m cells
GRID = dict(feature_size=(16, 16), voxel_size=(0.5, 0.5),
            pc_range=(-16.0, -16.0), out_size_factor=4)
BOXES = np.array([[3.3, -5.1, 0.2, 4.0, 1.8, 1.5, 0.7, 1.5, -0.4],
                  [-7.7, 9.4, -0.3, 2.0, 0.9, 1.7, -2.3, -0.2, 0.8],
                  [11.1, 2.6, 0.1, 4.5, 2.0, 1.6, 2.9, 0.0, 1.1]],
                 np.float32)


def _reflected_maps():
    """Dense reg, rot and vel maps (4, H, W, 2) of BOXES and their flip_y,
    flip_x and flip_both reflections, drawn from the port's targets, and
    the identity variant's centre indices and targets."""
    variants = []
    for sx, sy in ((1, 1), (1, -1), (-1, 1), (-1, -1)):
        b = BOXES.copy()
        b[:, 0] *= sx
        b[:, 1] *= sy
        b[:, 7] *= sx
        b[:, 8] *= sy
        yaw = BOXES[:, 6]
        b[:, 6] = np.arctan2(sy * np.sin(yaw), sx * np.cos(yaw))
        variants.append(b)
    tgt = assign_center_targets(
        torch.from_numpy(np.stack(variants)), torch.zeros(4, 3, dtype=torch.long),
        torch.ones(4, 3, dtype=torch.bool), 1, max_objs=8, **GRID)
    assert tgt["mask"][:, :3].all()
    h, w = GRID["feature_size"]
    maps = {}
    for name, cols in (("reg", [0, 1]), ("vel", [6, 7]), ("rot", [8, 9])):
        m = torch.zeros(4, h * w, 2)
        m.scatter_(1, tgt["inds"][:, :3, None].expand(-1, -1, 2),
                   tgt["anno_box"][:, :3, cols])
        maps[name] = m.view(4, h, w, 2)
    return maps, tgt["inds"][0, :3], tgt["anno_box"][0, :3]


def test_merge_geometric_round_trip():
    """Merged maps at the identity variant's centres give back its sub-cell
    offsets, (sin, cos) and velocities."""
    maps, inds, anno = _reflected_maps()
    merged = tta.merge_center_head_maps([maps])[0]
    for name, cols in (("reg", [0, 1]), ("vel", [6, 7]), ("rot", [8, 9])):
        got = merged[name].view(-1, 2)[inds]
        torch.testing.assert_close(got, anno[:, cols], atol=1e-6, rtol=0)


def test_jax_merge_misses_the_round_trip():
    """The JAX package's merge (df3d/models/tta.py:66-73) on the same maps:
    each flipped axis's offset comes back as offset - 1 in two of the
    three flipped variants, so the merged centre is half a cell off on
    each axis; sin comes back negated from flip_x and flip_both, so the
    merged sin is 0 and the heading a multiple of pi/2; vel agrees."""
    maps, inds, anno = _reflected_maps()
    merged = jtta.merge_center_head_maps(
        [{k: jnp.asarray(v.numpy()) for k, v in maps.items()}])[0]
    at = {k: np.asarray(v).reshape(-1, 2)[inds.numpy()]
          for k, v in merged.items()}
    np.testing.assert_allclose(at["reg"], anno[:, :2].numpy() - 0.5,
                               atol=1e-6)
    np.testing.assert_allclose(at["rot"][:, 0], 0.0, atol=1e-6)
    np.testing.assert_allclose(at["rot"][:, 1], anno[:, 9].numpy(),
                               atol=1e-6)
    assert (np.abs(anno[:, 8].numpy()) > 0.1).all()
    np.testing.assert_allclose(at["vel"], anno[:, 6:8].numpy(), atol=1e-6)


def _recorded_batch_stats(monkeypatch):
    """Every training norm's batch mean and variance as its forward
    computes them, by norm."""
    seen = {}
    update = tlayers._update_running

    def recording(bn, mean, var):
        seen[bn] = (mean.detach().clone(), var.detach().clone())
        return update(bn, mean, var)

    monkeypatch.setattr(tlayers, "_update_running", recording)
    return seen


def _norm_stats(model):
    return {name: {"mean": m.running_mean.numpy().copy(),
                   "var": m.running_var.numpy().copy()}
            for name, m in model.named_modules()
            if isinstance(m, (MaskedBatchNorm, FlaxBatchNorm))}


def _check_recalibration(model, forward, monkeypatch, momentum_of):
    """Recalibrate a copy of `model`; it must equal the JAX package's
    function fed the statistics before and after one training forward,
    norm by norm at that norm's momentum, and give back each norm's batch
    statistics. Returns the statistics (before, after) for more checks."""
    s0 = _norm_stats(model)
    stepped = copy.deepcopy(model).train()
    seen = _recorded_batch_stats(monkeypatch)
    with torch.no_grad():
        forward(stepped)
    s1 = _norm_stats(stepped)
    batch = {name: seen[m] for name, m in stepped.named_modules() if m in seen}
    assert sorted(batch) == sorted(s0)

    recal = copy.deepcopy(model)
    recalibrate_batch_stats(recal, lambda: forward(recal))
    assert not recal.training
    got = _norm_stats(recal)
    for name in s0:
        want = jrecalibrate_batch_stats(lambda _: {"x": s1[name]},
                                        {"x": s0[name]}, momentum_of(name))
        for k in ("mean", "var"):
            np.testing.assert_array_equal(got[name][k],
                                          np.asarray(want["x"][k]))
        mean, var = batch[name]
        scale = max(float(np.abs(s0[name]["mean"]).max()),
                    float(mean.abs().max()), 1.0)
        np.testing.assert_allclose(got[name]["mean"], mean.numpy(),
                                   atol=1e-4 * scale, err_msg=name)
        scale = max(float(s0[name]["var"].max()), float(var.max()), 1.0)
        np.testing.assert_allclose(got[name]["var"], var.numpy(),
                                   atol=1e-4 * scale, err_msg=name)
    return s0, s1, batch


def test_recalibrate_centerpoint(run, monkeypatch):
    """CenterPoint (every norm at 0.99), and CenterPoint + 3D-DF, whose
    frozen image branch keeps its norms, counters included."""
    model = run["model"].eval()
    cfg, batch = run["cfg"], run["batch"]
    res = voxelize_batch(batch["points"], batch["points_valid"],
                         cfg.voxel_size, cfg.pc_range, cfg.grid_size,
                         cfg.max_voxels, cfg.max_points_per_voxel)
    cams = (batch["images"], batch["proj"]) if "images" in batch else ()
    assert {m.momentum for m in model.modules()
            if isinstance(m, (MaskedBatchNorm, FlaxBatchNorm))} == {0.99}
    _check_recalibration(model, lambda m: m(res.features, res.coords, *cams),
                         monkeypatch, lambda name: 0.99)
    if cams:
        recal = copy.deepcopy(model)
        recalibrate_batch_stats(
            recal, lambda: recal(res.features, res.coords, *cams))
        before = model.image_branch.state_dict()
        after = recal.image_branch.state_dict()
        assert any(k.endswith("num_batches_tracked") for k in before)
        for k in before:
            assert torch.equal(before[k], after[k]), k


def test_recalibrate_transfusion_momenta(monkeypatch):
    """TransFusion-L's position-embedding and FFN norms move at 0.9: the
    port inverts each norm at its own momentum and recovers the batch
    statistics there too; the JAX package's single momentum (0.99) gives
    those norms statistics far from the batch's."""
    head = TransFusionHeadCfg(num_classes=3, num_proposals=16,
                              hidden_channel=32, num_heads=4, ffn_channel=64,
                              small_classes=(2,), bev_size=(8, 8),
                              out_size_factor=8, voxel_size=(0.5, 0.5),
                              pc_range=(-16.0, -16.0))
    cfg = TransFusionConfig(
        pc_range=(-16.0, -16.0, -2.4, 16.0, 16.0, 2.4),
        voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64), max_voxels=512,
        num_point_features=4, stage_caps=(1024, 512, 256, 128), head=head)
    model = TransFusionL(cfg).init_weights(
        torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():  # running statistics away from (0, 1)
        for m in model.modules():
            if isinstance(m, (MaskedBatchNorm, FlaxBatchNorm)):
                m.running_mean.uniform_(-0.5, 0.5)
                m.running_var.uniform_(0.5, 1.5)
    pts = torch.from_numpy(_points(np.random.RandomState(3), 2)[..., :4])
    res = voxelize_batch(pts, torch.ones(2, 512, dtype=torch.bool),
                         cfg.voxel_size, cfg.pc_range, cfg.grid_size,
                         cfg.max_voxels, cfg.max_points_per_voxel)
    momenta = {name: m.momentum for name, m in model.named_modules()
               if isinstance(m, (MaskedBatchNorm, FlaxBatchNorm))}
    fast = sorted(n for n, mo in momenta.items() if mo == 0.9)
    assert fast and set(momenta.values()) == {0.9, 0.99}
    s0, s1, batch = _check_recalibration(
        model, lambda m: m(res.features, res.coords), monkeypatch,
        momenta.get)
    for name in fast:
        single = jrecalibrate_batch_stats(lambda _: {"x": s1[name]},
                                          {"x": s0[name]}, 0.99)["x"]
        gap = np.abs(np.asarray(single["mean"]) - batch[name][0].numpy())
        assert gap.max() > 0.1, name
