"""The KITTI Voxel R-CNN serving slices, df3d_torch against one jitted JAX
`make_voxelrcnn_eval_step`: voxelize -> VoxelRCNN (VoxelBackBone8x, BEV
neck, anchor head) -> proposal_layer -> VoxelRCNNHead ->
voxel_rcnn_post_processing, LiDAR only (`fused=False`) and with
VoxelRCNN3DDF (`fused=True`: a one-block DeepLabV3 branch on one 32x104
camera with KITTI's P2 scaled to it, MVX at stride 1, and the preset's
ACTRv2 attention shape, 3 levels, 4 points, d_model 64, 8 heads of 8, with
a small LT and feed-forward). tests/test_import_voxelrcnn.py's tiny config
(a 64x64 grid, 16 RoIs, grid 4), batch 1, the same seeded points, image
and camera, flax weights carried across by df3d_torch.weights (strictly:
every leaf lands and every torch entry is filled).

Both paths run in one jitted JAX program, as the eval step runs, where XLA
fuses FPS's and the RoI search's distance sums and the voxel centres into
the multiply-add chains the port rounds like; the test reads the first
stage's outputs and sows, its conv plans and the RCNN head's outputs as
the eval step makes them, so that XLA compiles each once. Voxel coords,
every backbone stage's coords, every conv plan, every cap overflow, the
proposal NMS indices, roi_mask, the kept final boxes' indices and valid
match exactly (a JAX index is the one candidate box of the port's that its
box matches); the backbone's stage features, the RPN maps, RoIs, RCNN cls
and reg, final boxes and scores to 1e-4 * max|ref| + 1e-5."""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import df3d.models.backbones_3d as jbackbones
from df3d.models.detectors.fused import FusedConfig as JFusedConfig
from df3d.models.detectors.fused import VoxelRCNN3DDF as JVoxelRCNN3DDF
from df3d.models.detectors.voxel_rcnn import VoxelRCNN as JVoxelRCNN
from df3d.models.detectors.voxel_rcnn import VoxelRCNNConfig as JConfig
from df3d.models.fusion.actr import ACTRConfig as JACTRConfig
from df3d.models.heads import voxelrcnn_head as jrh
from df3d.ops.voxelize import voxelize_batch as jvoxelize_batch
from df3d.train.trainer import make_voxelrcnn_eval_step
from df3d_torch.core.box_coders import ResidualCoder
import df3d_torch.models.backbones_3d as tbackbones
from df3d_torch.core.nms import nms_bev
from df3d_torch.entry import infer_voxelrcnn, infer_voxelrcnn_fused
from df3d_torch.models.detectors.fused import FusedConfig, VoxelRCNN3DDF
from df3d_torch.models.detectors.voxel_rcnn import (
    VoxelRCNN, VoxelRCNNConfig,
)
from df3d_torch.models.fusion.actr import ACTRConfig
from df3d_torch.models.heads import anchor_head as tah
from df3d_torch.models.heads import voxelrcnn_head as trh
from df3d_torch.ops.voxelize import voxelize_batch
from df3d_torch.utils.synth import kitti_camera
from torch_port_helpers import recorded_plans, seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401
from df3d_torch.weights import load_voxelrcnn

KEY = jax.random.PRNGKey(0)
GEOM = dict(pc_range=(0.0, -16.0, -2.4, 32.0, 16.0, 2.4),
            voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64),
            max_voxels=512, num_point_features=4,
            stage_caps=(512, 384, 256, 128), test_pre_nms=128,
            test_post_nms=16)
SCALES = (("conv2", 2, 0.8), ("conv3", 4, 1.6), ("conv4", 8, 1.6))
HEAD = dict(grid_size=4, max_local=64)
# the preset's attention shape (3 levels, 4 points, d_model 64, 8 heads),
# a small LT and feed-forward
ACTR = dict(d_model=64, n_heads=8, n_points=4, n_levels=3, num_layers=1,
            dim_feedforward=32, lt_npoint=16, lt_nsample=8, lt_num_layers=1,
            model_name="ACTRv2", q_method="gating",
            attn_layer="BiGateSum1D_2")
IMAGE = (32, 104)
FUSED = dict(image_shape=IMAGE, image_branch="deeplabv3",
             image_layers=(1, 1, 1, 1), n_levels=3, num_cams=1,
             use_ifat=True, fusion_downsample=8)


def _configs(pkg_cfg, pkg_head):
    return pkg_cfg(**GEOM, rcnn=pkg_head.VoxelRCNNHeadCfg(
        scales=tuple(pkg_head.RoIPoolScaleCfg(*s, nsample=8)
                     for s in SCALES), **HEAD))


JCFG, TCFG = _configs(JConfig, jrh), _configs(VoxelRCNNConfig, trh)


def _tol(got, want, err_msg=""):
    """max |got - want| <= 1e-4 * max |want| + 1e-5."""
    want = np.asarray(want)
    atol = 1e-4 * (np.abs(want).max() if want.size else 0.0) + 1e-5
    np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=0,
                               err_msg=err_msg)


def _inputs():
    rng = np.random.RandomState(0)
    n = 1500
    points = np.concatenate([rng.uniform(0, 31, (1, n, 1)),
                             rng.uniform(-15, 15, (1, n, 1)),
                             rng.uniform(-1.8, 1.8, (1, n, 1)),
                             rng.uniform(0, 1, (1, n, 1))], -1)
    return dict(points=points.astype(np.float32),
                points_valid=np.ones((1, n), bool),
                images=rng.randn(1, *IMAGE, 3).astype(np.float32),
                proj=kitti_camera(IMAGE[1] / 1280.0)[None])


def _variables(model, head, fwd, seed):
    """Seeded {"rpn": ..., "rcnn": ...} params and batch_stats."""
    preds, rpn = jax.eval_shape(
        lambda *a: model.init_with_output(KEY, *a, train=False), *fwd)
    rpn = seeded_variables(rpn, np.random.RandomState(seed))
    r = GEOM["test_post_nms"]
    rois = jnp.zeros((1, r, 7)).at[..., 3:6].set(1.0)
    rcnn = seeded_variables(jax.eval_shape(
        lambda m: head.init(KEY, rois, jnp.ones((1, r), bool), m,
                            train=False), preds["ms"]),
        np.random.RandomState(seed + 1))
    return dict(
        params={"rpn": rpn["params"], "rcnn": rcnn["params"]},
        batch_stats={"rpn": rpn["batch_stats"], "rcnn": rcnn["batch_stats"]})


def _match(candidates, picked, tol):
    """The index of the one row of `candidates` (N, 7) that each row of
    `picked` (K, 7) equals within `tol`; every other row lies farther than
    10 * tol."""
    d = np.abs(candidates[None] - picked[:, None]).max(-1)   # (K, N)
    idx = d.argmin(-1)
    part = np.sort(d, -1)
    assert (part[:, 0] <= tol).all() and (part[:, 1] > 10 * tol).all()
    return idx


class _Recorded:
    """A flax module whose `apply`, as the eval step calls it, also keeps
    what the test reads: the cap overflows the model sows and its
    outputs (no second trace of the model)."""

    def __init__(self, module, store, key):
        self.module, self.store, self.key = module, store, key

    def apply(self, variables, *args, **kwargs):
        out, inter = self.module.apply(variables, *args, **kwargs,
                                       mutable=["intermediates"])
        self.store[self.key] = (out, inter.get("intermediates", {}))
        return out


@pytest.fixture(scope="module")
def slices():
    batch = _inputs()
    head = jrh.VoxelRCNNHead(JCFG.rcnn, JCFG.voxel_size, JCFG.pc_range)
    fcfg = JFusedConfig(actr=JACTRConfig(**ACTR), mvx_early=True, **FUSED)
    models = {"lidar": JVoxelRCNN(JCFG), "fused": JVoxelRCNN3DDF(JCFG, fcfg)}
    seen = {}
    steps = {k: make_voxelrcnn_eval_step(
        _Recorded(m, seen, (k, "rpn")), _Recorded(head, seen, (k, "rcnn")),
        JCFG, fused=k == "fused") for k, m in models.items()}

    def voxelize(b):
        return jvoxelize_batch(b["points"], b["points_valid"],
                               JCFG.voxel_size, JCFG.pc_range,
                               JCFG.grid_size, JCFG.max_voxels,
                               JCFG.max_points_per_voxel)

    res0 = jax.eval_shape(voxelize, batch)
    states = {}
    for i, (k, m) in enumerate(models.items()):
        fwd = (res0.features, res0.coords)
        if k == "fused":
            fwd += (batch["images"], batch["proj"])
        states[k] = _variables(m, head, fwd, 10 * (i + 1))

    plans = {k: [] for k in models}

    @jax.jit  # one program: both eval steps and what the test reads inside
    def run(states, batch):
        outs = {}
        for k in models:
            # the eval step reads the TrainState's two fields
            with recorded_plans(jbackbones, plans[k]):
                out = steps[k](SimpleNamespace(**states[k]), batch)
            preds, inter = seen[k, "rpn"]
            (cls, reg), _ = seen[k, "rcnn"]
            bb = inter["detector"]["backbone"] if k == "fused" else \
                inter["backbone"]
            outs[k] = dict(out=out, preds=preds, cls=cls, reg=reg,
                           overflow={n: v[0] for n, v in bb.items()
                                     if n.startswith("cap_overflow")},
                           plans=plans[k])
        return voxelize(batch), outs

    res, outs = jax.tree_util.tree_map(np.asarray, run(states, batch))

    t = {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}
    tres = voxelize_batch(t["points"], t["points_valid"], TCFG.voxel_size,
                          TCFG.pc_range, TCFG.grid_size, TCFG.max_voxels,
                          TCFG.max_points_per_voxel)
    tfcfg = FusedConfig(actr=ACTRConfig(**ACTR), **FUSED)
    ported = {"lidar": VoxelRCNN(TCFG), "fused": VoxelRCNN3DDF(TCFG, tfcfg)}
    runs = {}
    for k, rpn in ported.items():
        head_t = trh.VoxelRCNNHead(TCFG.rcnn, TCFG.voxel_size, TCFG.pc_range)
        load_voxelrcnn(rpn, head_t, states[k]["params"],
                       states[k]["batch_stats"])
        rpn.eval(), head_t.eval()
        extra = (t["images"], t["proj"]) if k == "fused" else ()
        with torch.no_grad(), recorded_plans(tbackbones, []) as t_plans:
            preds, overflow = rpn(tres.features, tres.coords, *extra)
        with torch.no_grad():
            infer = infer_voxelrcnn_fused if extra else infer_voxelrcnn
            det, overflow2 = infer(rpn, head_t, TCFG, t["points"],
                                   t["points_valid"], *extra)
            cls, reg = head_t(det["rois"], det["roi_mask"], preds["ms"])
            unfused = (rpn.detector(tres.features, tres.coords)[0]
                       if extra else None)
        runs[k] = dict(rpn=rpn, preds=preds, overflow=overflow, det=det,
                       overflow2=overflow2, cls=cls, reg=reg,
                       unfused=unfused, plans=t_plans)
    return dict(res=res, outs=outs, tres=tres, runs=runs)


PATHS = ("lidar", "fused")


def test_voxels(slices):
    np.testing.assert_array_equal(slices["tres"].coords.numpy(),
                                  slices["res"].coords)
    assert (slices["res"].coords[0, :, 0] >= 0).all()  # the cap is full


@pytest.mark.parametrize("path", PATHS)
def test_cap_overflow(slices, path):
    run, want = slices["runs"][path], slices["outs"][path]["overflow"]
    assert set(run["overflow"]) == set(want)
    for k, v in run["overflow"].items():
        np.testing.assert_array_equal(v.numpy(), want[k])
        np.testing.assert_array_equal(v.numpy(), run["overflow2"][k].numpy())
    assert sum(int(v.sum()) for v in want.values()) > 0


@pytest.mark.parametrize("path", PATHS)
def test_voxel_backbone(slices, path):
    """VoxelBackBone8x, fully sparse: every stage's coords and all 8 conv
    plans (4 submanifold, 4 strided) exactly, the stage features (conv1
    after MVX, conv4 after ACTR on the fused path) to the tolerance."""
    run, want = slices["runs"][path], slices["outs"][path]
    for k in ("conv1", "conv2", "conv3", "conv4"):
        np.testing.assert_array_equal(run["preds"]["ms"][k].coords.numpy(),
                                      want["preds"]["ms"][k].coords)
        _tol(run["preds"]["ms"][k].features.numpy(),
             want["preds"]["ms"][k].features, k)
    assert len(run["plans"]) == len(want["plans"]) == 8
    for i, (got, plan) in enumerate(zip(run["plans"], want["plans"])):
        np.testing.assert_array_equal(got.numpy(), plan, err_msg=f"plan {i}")


@pytest.mark.parametrize("path", PATHS)
def test_rpn_maps(slices, path):
    run, want = slices["runs"][path], slices["outs"][path]["preds"]
    for k in ("cls", "box", "dir"):
        _tol(run["preds"][k].numpy(), want[k], k)


def _tol_of(want):
    return 1e-4 * np.abs(want).max() + 1e-5


@pytest.mark.parametrize("path", PATHS)
def test_proposals(slices, path):
    """The proposal NMS's kept indices and roi_mask exactly; RoIs to the
    tolerance."""
    run, want = slices["runs"][path], slices["outs"][path]
    preds = run["preds"]
    scores, boxes = tah.anchor_head_decode(
        preds["cls"], preds["box"], preds["dir"],
        getattr(run["rpn"], "detector", run["rpn"]).anchors, ResidualCoder())
    idx, mask = nms_bev(boxes, scores.amax(-1), TCFG.test_nms_thresh,
                        TCFG.test_pre_nms, TCFG.test_post_nms)
    rois, roi_mask = want["out"]["rois"][0], want["out"]["roi_mask"][0]
    np.testing.assert_array_equal(mask[0].numpy(), roi_mask)
    np.testing.assert_array_equal(run["det"]["roi_mask"][0].numpy(), roi_mask)
    assert roi_mask.any()
    np.testing.assert_array_equal(
        idx[0].numpy()[roi_mask],
        _match(boxes[0].numpy(), rois[roi_mask], _tol_of(rois)))
    _tol(run["det"]["rois"].numpy(), want["out"]["rois"], "rois")


@pytest.mark.parametrize("path", PATHS)
def test_rcnn_head(slices, path):
    run, want = slices["runs"][path], slices["outs"][path]
    _tol(run["cls"].numpy(), want["cls"], "cls")
    _tol(run["reg"].numpy(), want["reg"], "reg")


@pytest.mark.parametrize("path", PATHS)
def test_detections(slices, path):
    """The final NMS's kept indices (of the boxes over the score
    threshold) and valid exactly; boxes and scores to the tolerance;
    labels all Car (0)."""
    run, want = slices["runs"][path], slices["outs"][path]
    det, out = run["det"], want["out"]
    refined = trh.decode_rcnn_boxes(det["rois"], run["reg"])
    scores = torch.sigmoid(run["cls"][..., 0]) * det["roi_mask"]
    idx, _ = nms_bev(refined, scores, TCFG.final_nms_thresh,
                     refined.shape[1], TCFG.final_max_boxes)
    valid = out["valid"][0]
    np.testing.assert_array_equal(det["valid"].numpy(), out["valid"])
    assert valid.any()
    np.testing.assert_array_equal(
        idx[0].numpy()[valid],
        _match(refined[0].numpy(), out["boxes"][0][valid],
               _tol_of(out["boxes"])))
    np.testing.assert_array_equal(det["labels"].numpy(), out["labels"])
    _tol(det["boxes"].numpy(), out["boxes"], "boxes")
    _tol(det["scores"].numpy(), out["scores"], "scores")


def test_fusion_changes_the_result(slices):
    """The camera moves the fused RPN's maps: the same first stage without
    the hook's inputs gives other class logits."""
    run = slices["runs"]["fused"]
    diff = (run["preds"]["cls"] - run["unfused"]["cls"]).abs().max()
    assert diff > 1e-2
