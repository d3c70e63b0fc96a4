"""df3d_torch's Voxel R-CNN modules against df3d's, one part at a time,
with the same seeded inputs and flax weights carried across by
df3d_torch.weights: anchors, the residual coder and the anchor decode, the
RoI grid, the two-stage neighbour search, the RCNN head in eval mode, its
box decode, the proposal NMS and the final post-processing; and the ACTR
hook's voxel centres and LT's neighbour sets on KITTI's stride-8 lattice.
VoxelBackBone8x (coords, plans, overflows, features) is held in
tests/test_torch_voxelrcnn_slice.py, inside the JAX eval step, so that
XLA compiles it once.

Every JAX function runs inside one jitted program, as the eval step runs
it: the neighbour search ranks lattice distances, whose last bit XLA's
fused multiply-adds decide (the port rounds as they do). Tolerances (f32,
another summation order): the coders and the RoI grid 1e-5; the head
1e-4 of its max; the proposal boxes 1e-4. Anchors, neighbour indices and
masks, and NMS keep sets match exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d.core import nms as jnms
from df3d.core.box_coders import ResidualCoder as JCoder
from df3d.core.calib import voxel_centers_from_coords as jcenters
from df3d.models.detectors import voxel_rcnn as jvr
from df3d.models.heads import anchor_head as jah
from df3d.models.heads import voxelrcnn_head as jrh
from df3d.ops import pointops as jpo
from df3d.ops import roi_ops as jroi
from df3d.ops import sparse as jsp
from df3d_torch.core.box_coders import ResidualCoder
from df3d_torch.core.calib import voxel_centers_fma, voxel_centers_from_coords
from df3d_torch.core.nms import nms_bev
from df3d_torch.models.detectors import voxel_rcnn as tvr
from df3d_torch.models.fusion import pointformer as tpf
from df3d_torch.models.fusion.actr import ACTRConfig
from df3d_torch.models.fusion.hooks import (
    ACTRFusionSpec, MultiCamACTRFusionHook,
)
from df3d_torch.models.heads import anchor_head as tah
from df3d_torch.models.heads import voxelrcnn_head as trh
from df3d_torch.ops import roi_ops as troi
from df3d_torch.ops import sparse as tsp
from df3d_torch.utils.synth import kitti_camera
from torch_port_helpers import load_flax, seeded_variables

KEY = jax.random.PRNGKey(0)
# tests/test_import_voxelrcnn.py's tiny config, in both packages
GEOM = dict(pc_range=(0.0, -16.0, -2.4, 32.0, 16.0, 2.4),
            voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64),
            max_voxels=512, num_point_features=4,
            stage_caps=(512, 384, 256, 128))
SCALES = ((("conv2", 2, 0.8), ("conv3", 4, 1.6), ("conv4", 8, 1.6)))
HEAD = dict(grid_size=4, max_local=64)
JCFG = jvr.VoxelRCNNConfig(**GEOM, rcnn=jrh.VoxelRCNNHeadCfg(
    scales=tuple(jrh.RoIPoolScaleCfg(*s, nsample=8) for s in SCALES),
    **HEAD))
TCFG = tvr.VoxelRCNNConfig(**GEOM, rcnn=trh.VoxelRCNNHeadCfg(
    scales=tuple(trh.RoIPoolScaleCfg(*s, nsample=8) for s in SCALES),
    **HEAD))
# a 32 x 32 BEV map: 2048 anchors, so the proposal NMS (pre 1024) takes
# the chunked IoU path; 0.26 m apart, so neighbouring cars overlap > 0.7
NMS_GEOM = dict(grid_size=(24, 256, 256),
                pc_range=(0.0, -4.0, -2.4, 8.0, 4.0, 2.4))
KITTI_VS, KITTI_PCR = (0.05, 0.05, 0.1), (0.0, -40.0, -3.0, 70.4, 40.0, 1.0)
CAR = dict(size=(3.9, 1.6, 1.56), bottom_height=-1.78, matched_threshold=0.6,
           unmatched_threshold=0.45)
PED = dict(size=(0.8, 0.6, 1.73), bottom_height=-0.6, matched_threshold=0.5,
           unmatched_threshold=0.35)


def _close(got, want, rel, err_msg=""):
    """max |got - want| <= rel * max |want| (+ rel)."""
    want = np.asarray(want)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * (scale + 1),
                               rtol=0, err_msg=err_msg)


def _rois(rng, r, lo, hi, heading=True):
    box = np.concatenate([rng.uniform(lo, hi, (r, 3)),
                          rng.uniform(1.0, 4.5, (r, 3)),
                          rng.uniform(-np.pi, np.pi, (r, 1)) * heading], -1)
    return box.astype(np.float32)


def _lattice(shape, origin=(0, 0, 0)):
    """Every coord of a (z, y, x) block, key order."""
    zz, yy, xx = np.meshgrid(*[np.arange(s) + o for s, o in
                               zip(shape, origin)], indexing="ij")
    return np.stack([zz, yy, xx], -1).reshape(-1, 3).astype(np.int32)


def _neighbour_cases():
    """(name, coords (N, 3) with -1 padding rows, voxel_size, pc_range,
    downsample, rois (R, 7), grid, coarse radius, max_local, radius,
    nsample)."""
    rng = np.random.RandomState(5)
    cases = []
    # an exact lattice (centres at 0.125 + 0.25 k): around a RoI centred on
    # a voxel the 256th neighbour falls inside the shell at d^2 = 16 * 0.25^2
    # (251 voxels nearer, 6 on it), which is also the coarse radius; grid 2
    # of a 1 m RoI puts the grid points on voxel centres, with 33 voxels
    # within 0.5 m, the 6 at 0.5 m exactly on the radius
    cube = _lattice((9, 9, 9))
    coords = np.concatenate([cube, -np.ones((40, 3), np.int32)])
    rois = np.array([[1.125, 1.125, 1.125, 1.0, 1.0, 1.0, 0.0],
                     [1.125, 0.875, 1.375, 1.0, 1.0, 1.0, 0.0]], np.float32)
    cases.append(("exact_lattice", coords, (0.25, 0.25, 0.25),
                  (0.0, 0.0, 0.0, 10.0, 10.0, 10.0), 1, rois, 2, 1.0, 256,
                  0.5, 40))
    # KITTI's stride-2 lattice (0.1 m, 0.2 m in z): the same ties in exact
    # arithmetic, decided by rounding
    block = _lattice((7, 13, 13), origin=(3, 197, 100))
    vs = np.float32(2) * np.asarray(KITTI_VS, np.float32)
    centre = (block[len(block) // 2, ::-1] * vs
              + np.asarray(KITTI_PCR[:3], np.float32) + vs / 2)
    rois = np.array([[*centre, 0.8, 0.8, 0.8, 0.0],
                     [*(centre + np.float32(0.05)), 1.2, 1.2, 1.2, 0.0]],
                    np.float32)
    cases.append(("kitti_lattice", block, KITTI_VS, KITTI_PCR, 2, rois, 6,
                  4.0, 256, 0.4, 16))
    # random sparse voxels at stride 2 and random RoIs among them
    sites = {tuple(int(v) for v in (rng.randint(0, 11), rng.randint(150, 250),
                                    rng.randint(100, 180)))
             for _ in range(2500)}
    coords = np.array(sorted(sites), np.int32)
    coords = np.concatenate([coords, -np.ones((17, 3), np.int32)])
    rois = _rois(rng, 12, 0.0, 1.0)
    rois[:, 0] = rng.uniform(10.5, 17.5, 12)
    rois[:, 1] = rng.uniform(-24.0, -16.0, 12)
    rois[:, 2] = rng.uniform(-2.8, -1.2, 12)
    cases.append(("random", coords, KITTI_VS, KITTI_PCR, 2, rois, 6, 4.0,
                  256, 0.4, 16))
    return cases


CASES = _neighbour_cases()
# LT at KITTI's stride 8 (0.4 x 0.4 x 0.8 m cells): every third cell in x
# and y and every second in z, so a voxel's neighbours one step apart in z
# and in x or y lie exactly on the 2 m radius (1.2^2 + 1.6^2 = 4), and
# fewer than nsample lie within it; in front of the camera, which sees all
LT_NPOINT, LT_RADIUS, LT_NSAMPLE = 32, 2.0, 32


def _lt_lattice():
    zz, yy, xx = np.meshgrid(np.arange(3) * 2 + 1, np.arange(6) * 3 + 20,
                             np.arange(6) * 3 + 150, indexing="ij")
    block = np.stack([zz, yy, xx], -1).reshape(-1, 3)
    return np.concatenate([block, -np.ones((11, 3), int)]).astype(np.int32)


def _stages(rng):
    """Random VoxelBackBone8x stage tensors conv2..conv4 of the tiny config
    (features, coords with -1 padding rows), key-sorted."""
    ms = {}
    for k, ds, width, n, pad in (("conv2", 2, 32, 300, 84),
                                 ("conv3", 4, 64, 150, 106),
                                 ("conv4", 8, 64, 60, 68)):
        shape = (25 // ds + 1, 64 // ds, 64 // ds)
        flat = np.sort(rng.choice(np.prod(shape), n, replace=False))
        coords = np.stack(np.unravel_index(flat, shape), -1).astype(np.int32)
        ms[k] = (np.concatenate([rng.randn(n, width),
                                 np.zeros((pad, width))]).astype(np.float32),
                 np.concatenate([coords, -np.ones((pad, 3), np.int32)]))
    return {k: (f[None], c[None]) for k, (f, c) in ms.items()}


def _inputs():
    rng = np.random.RandomState(0)
    x = {}
    # coder and anchor decode: some direction logits tie (the first bin wins)
    x["anchors"] = _rois(rng, 60, -30.0, 30.0)
    x["enc"] = (0.5 * rng.randn(2, 60, 7)).astype(np.float32)
    x["cls"] = rng.randn(2, 60, 1).astype(np.float32)
    d = rng.randn(2, 60, 2).astype(np.float32)
    d[:, ::7, 1] = d[:, ::7, 0]
    x["dir"] = d
    x["grid_rois"] = _rois(rng, 9, -30.0, 30.0)
    x["dec_rois"] = _rois(rng, 2 * 9, -30.0, 30.0).reshape(2, 9, 7)
    x["dec_reg"] = (0.3 * rng.randn(2, 9, 7)).astype(np.float32)
    # the head: random stage tensors, 16 RoIs among their voxels, the last
    # three masked
    x["ms"] = _stages(rng)
    rois = _rois(rng, 16, 0.0, 1.0)
    rois[:, 0] = rng.uniform(2, 30, 16)
    rois[:, 1] = rng.uniform(-14, 14, 16)
    rois[:, 2] = rng.uniform(-1.5, 1.5, 16)
    x["head_rois"] = rois[None]
    x["head_mask"] = (np.arange(16) < 13)[None]
    # the proposal NMS: 2048 anchors, logits with exact ties among them
    cfg = jvr.VoxelRCNNConfig(**NMS_GEOM)
    a = 2 * cfg.bev_size_xy[0] * cfg.bev_size_xy[1]
    logits = rng.randn(1, a, 1).astype(np.float32)
    logits[0, 1::5] = logits[0, ::5][:len(logits[0, 1::5])]
    x["nms_preds"] = {"cls": logits,
                      "box": (0.3 * rng.randn(1, a, 7)).astype(np.float32),
                      "dir": rng.randn(1, a, 2).astype(np.float32)}
    # the final post-processing: RoIs with a masked tail
    x["post_rois"] = _rois(rng, 40, 0.0, 20.0)[None]
    x["post_mask"] = (np.arange(40) < 33)[None]
    x["post_cls"] = rng.randn(1, 40, 1).astype(np.float32)
    x["post_reg"] = (0.2 * rng.randn(1, 40, 7)).astype(np.float32)
    x["cases"] = [(c[1], c[5]) for c in CASES]
    x["lt_coords"] = _lt_lattice()
    return x


@pytest.fixture(scope="module")
def parts():
    """The JAX package's outputs, one jitted program, and the inputs."""
    x = _inputs()
    head = jrh.VoxelRCNNHead(JCFG.rcnn, JCFG.voxel_size, JCFG.pc_range)
    nms_cfg = jvr.VoxelRCNNConfig(**NMS_GEOM)

    def sparse(ms):
        return {k: jsp.SparseTensor(f, c, (1, 1, 1)) for k, (f, c) in
                ms.items()}

    head_vars = seeded_variables(jax.eval_shape(
        lambda ms: head.init(KEY, x["head_rois"], x["head_mask"],
                             sparse(ms), train=False), x["ms"]),
        np.random.RandomState(2))

    @jax.jit  # one program: the eval step runs these under jit too
    def run(x, head_vars):
        out = {}
        coder = JCoder()
        out["decoded"] = coder.decode(x["enc"], x["anchors"][None])
        out["scores"], out["boxes"] = jah.anchor_head_decode(
            x["cls"], x["enc"], x["dir"], x["anchors"], coder)
        out["grid"] = jroi.roi_grid_points(x["grid_rois"], 6)
        out["rcnn_boxes"] = jrh.decode_rcnn_boxes(x["dec_rois"],
                                                  x["dec_reg"])
        for (name, _, vs, pcr, ds, _, g, coarse, nloc, rad,
             ns), (coords, rois) in zip(CASES, x["cases"]):
            # the arrays are arguments, not constants XLA could fold
            xyz = jcenters(coords, vs, pcr, ds)
            valid = coords[:, 0] >= 0
            lidx, lmask = jroi.collect_local_voxels(rois[:, :3], xyz, valid,
                                                    coarse, nloc)
            grid = jroi.roi_grid_points(rois, g)
            nidx, found = jroi.grid_ball_query(grid, xyz, lidx, lmask, rad,
                                               ns)
            d2 = jnp.sum((rois[:, None, :3] - xyz[None]) ** 2, -1)
            out[name] = (lidx, lmask, nidx, found,
                         jnp.sort(jnp.where(valid[None], d2, 1e10), -1))
        out["head"] = head.apply(head_vars, x["head_rois"], x["head_mask"],
                                 sparse(x["ms"]), train=False)
        anchors = jvr.build_anchors(nms_cfg)
        scores, boxes = jah.anchor_head_decode(
            x["nms_preds"]["cls"], x["nms_preds"]["box"],
            x["nms_preds"]["dir"], anchors, coder)
        # proposal_layer's NMS (the eval step's proposal_layer is held in
        # tests/test_torch_voxelrcnn_slice.py)
        out["nms_scores"], out["nms_boxes"] = scores[0].max(-1), boxes[0]
        out["nms"] = jnms.nms_bev(boxes[0], scores[0].max(-1),
                                  nms_cfg.test_nms_thresh,
                                  nms_cfg.test_pre_nms,
                                  nms_cfg.test_post_nms)
        # the ACTR hook's voxel centres and LT's FPS and ball query, as
        # df3d/models/fusion/pointformer.py runs them (exact FPS at 32)
        xyz = jcenters(x["lt_coords"], KITTI_VS, KITTI_PCR, 8)
        valid = x["lt_coords"][:, 0] >= 0
        ci = jpo.furthest_point_sample(xyz, valid, LT_NPOINT)
        idx, mask = jpo.ball_query(xyz[ci], xyz, valid, LT_RADIUS,
                                   LT_NSAMPLE)
        out["lt"] = (xyz, ci, idx, mask)
        out["post"] = jvr.voxel_rcnn_post_processing(
            JCFG, x["post_rois"], None, x["post_mask"], x["post_cls"],
            x["post_reg"])
        return out

    out = jax.tree_util.tree_map(np.asarray, run(x, head_vars))
    return dict(x=x, out=out, head_vars=head_vars)


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("two_classes", [False, True])
def test_anchors(two_classes):
    """Location-major (y, x, class, rotation), equal to the last bit; the
    class id of each, in the same order."""
    classes = [jah.AnchorClassCfg("Car", **CAR)]
    tclasses = [tah.AnchorClassCfg("Car", **CAR)]
    if two_classes:
        classes.append(jah.AnchorClassCfg("Pedestrian", **PED))
        tclasses.append(tah.AnchorClassCfg("Pedestrian", **PED))
    jcfg = jvr.VoxelRCNNConfig(anchor_classes=tuple(classes))
    tcfg = tvr.VoxelRCNNConfig(anchor_classes=tuple(tclasses))
    want = np.asarray(jvr.build_anchors(jcfg))
    got = tvr.build_anchors(tcfg).numpy()
    assert got.shape == (200 * 176 * 2 * len(classes), 7)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(tvr.anchor_class_ids(tcfg).numpy(),
                                  np.asarray(jvr.anchor_class_ids(jcfg)))
    # the second anchor of a location is its 90-degree twin; the next
    # location is one x step on
    per_loc = 2 * len(classes)
    np.testing.assert_array_equal(got[1, :6], got[0, :6])
    assert got[per_loc, 0] > got[0, 0] and got[per_loc, 1] == got[0, 1]


def test_coder_and_anchor_decode(parts):
    x, out = parts["x"], parts["out"]
    got = ResidualCoder().decode(_t(x["enc"]), _t(x["anchors"])[None])
    np.testing.assert_allclose(got.numpy(), out["decoded"], atol=1e-5,
                               rtol=1e-5)
    scores, boxes = tah.anchor_head_decode(
        _t(x["cls"]), _t(x["enc"]), _t(x["dir"]), _t(x["anchors"]),
        ResidualCoder())
    np.testing.assert_allclose(scores.numpy(), out["scores"], atol=1e-6)
    np.testing.assert_allclose(boxes.numpy(), out["boxes"], atol=1e-5,
                               rtol=1e-5)


def test_head_layout():
    """The 1x1 convs' outputs pair with the anchors location-major: the
    prediction of anchor (y, x, a) reads the map at (y, x)."""
    head = tah.AnchorHeadSingle(5, 1, 2)
    bev = torch.zeros(1, 3, 4, 5)
    bev[0, 2, 1] = 1.0
    torch.nn.init.ones_(head.conv_cls.weight)
    torch.nn.init.zeros_(head.conv_cls.bias)
    cls = head(bev)[0].view(3, 4, 2)
    assert cls[2, 1].eq(5.0).all() and cls.sum() == 10.0


def test_roi_grid_points(parts):
    got = troi.roi_grid_points(_t(parts["x"]["grid_rois"]), 6)
    assert got.shape == (9, 216, 3)
    np.testing.assert_allclose(got.numpy(), parts["out"]["grid"], atol=1e-5,
                               rtol=1e-6)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_neighbour_search(parts, case):
    """Stage 1 (the max_local nearest voxels) and stage 2 (first nsample by
    local order within the radius): indices and masks equal. On the exact
    lattice the max_local-th neighbour ties with the next one, and 6 of
    each grid point's 33 neighbours lie exactly on the radius."""
    name, coords, vs, pcr, ds, rois, g, coarse, nloc, rad, ns = case
    lidx, lmask, nidx, found, d2_sorted = parts["out"][name]
    coords_t = _t(coords)[None]
    xyz = voxel_centers_fma(coords_t, vs, pcr, ds)
    valid = coords_t[..., 0] >= 0
    rois_t = _t(rois)[None]
    t_lidx, t_lmask = troi.collect_local_voxels(rois_t[..., :3], xyz, valid,
                                                coarse, nloc)
    np.testing.assert_array_equal(t_lidx[0].numpy(), lidx)
    np.testing.assert_array_equal(t_lmask[0].numpy(), lmask)
    grid = troi.roi_grid_points(rois_t, g)
    t_nidx, t_found = troi.grid_ball_query(grid, xyz, t_lidx, t_lmask, rad,
                                           ns)
    np.testing.assert_array_equal(t_found[0].numpy(), found)
    np.testing.assert_array_equal(t_nidx[0].numpy(), nidx)
    assert found.any()
    if name == "exact_lattice":
        # ties straddle the cut at the max_local-th neighbour; each grid
        # point has 33 neighbours within the radius, fewer than nsample
        assert (d2_sorted[:, nloc - 1] == d2_sorted[:, nloc]).all()
        assert (found.sum(-1) == 33).all()
    if name == "random":
        assert not found.all()


def test_actr_hook_lt_ties_at_the_radius(parts, monkeypatch):
    """The single-camera ACTR hook at KITTI's stride 8: the voxel centres it
    gives LT equal the jitted JAX hook's to the last bit (XLA computes idx *
    size + origin as one fused multiply-add), and LT's FPS centres and
    ball-query sets equal JAX's, where many pairs lie exactly on the 2 m
    radius. Centres rounded in two steps differ and flip some of those
    pairs."""
    coords = parts["x"]["lt_coords"]
    want_xyz, want_ci, want_idx, want_mask = parts["out"]["lt"]
    seen = []

    def ball_query(centers, xyz, valid, radius, k):
        got = bq(centers, xyz, valid, radius, k)
        seen.append((centers, xyz, valid, radius, k) + got)
        return got

    bq = tpf.ball_query
    monkeypatch.setattr(tpf, "ball_query", ball_query)
    actr = ACTRConfig(dim_feedforward=16, lt_npoint=LT_NPOINT,
                      lt_radius=LT_RADIUS, lt_nsample=LT_NSAMPLE,
                      lt_num_layers=1)
    torch.manual_seed(0)
    hook = MultiCamACTRFusionHook(ACTRFusionSpec(actr, 8), KITTI_VS,
                                  KITTI_PCR, (384, 1280), 1, 64, (8, 8, 8))
    g = torch.Generator().manual_seed(1)
    st = tsp.SparseTensor(torch.randn(1, len(coords), 64, generator=g),
                          _t(coords)[None], (5, 200, 176))
    feats = [torch.randn(1, 1, h, w, 8, generator=g)
             for h, w in ((12, 40), (6, 20), (3, 10))]
    with torch.no_grad():
        hook(st, feats, _t(kitti_camera())[None, None], stage="conv4")
    (centers, xyz, valid, radius, k, idx, mask), = seen
    assert (radius, k) == (LT_RADIUS, LT_NSAMPLE)
    np.testing.assert_array_equal(valid[0].numpy(), coords[:, 0] >= 0)
    np.testing.assert_array_equal(xyz[0].numpy(), want_xyz)
    np.testing.assert_array_equal(centers[0].numpy(), want_xyz[want_ci])
    np.testing.assert_array_equal(mask[0].numpy(), want_mask)
    np.testing.assert_array_equal(idx[0].numpy(), want_idx)
    # the lattice puts pairs on the radius, and the last bit decides them:
    # JAX's sets hold some and leave out others
    cells = coords[want_ci][:, None].astype(np.int64) - coords[None]
    on = ((cells * (8, 4, 4)) ** 2).sum(-1) == 400     # decimetres
    on &= coords[None, :, 0] >= 0
    found = np.zeros_like(on)
    for s, (i, m) in enumerate(zip(want_idx, want_mask)):
        found[s, i[m]] = True
    assert 0 < (on & found).sum() < on.sum()
    assert (want_mask.sum(-1) < LT_NSAMPLE).all()
    eager = voxel_centers_from_coords(_t(coords)[None], KITTI_VS, KITTI_PCR,
                                      8)
    assert (eager[0].numpy() != want_xyz).any()


def test_rcnn_head(parts):
    """The RCNN head in eval mode on the stage tensors (its norms at eps
    1e-3): cls and reg to 1e-4 of their max, zero for masked RoIs."""
    out, x = parts["out"], parts["x"]
    head = load_flax(trh.VoxelRCNNHead(TCFG.rcnn, TCFG.voxel_size,
                                       TCFG.pc_range), parts["head_vars"])
    assert all(m.eps == 1e-3 for m in head.modules()
               if isinstance(m, trh.MaskedBatchNorm))
    ms = {k: tsp.SparseTensor(_t(f), _t(c), (1, 1, 1))
          for k, (f, c) in x["ms"].items()}
    with torch.no_grad():
        cls, reg = head(_t(x["head_rois"]), _t(x["head_mask"]), ms)
    want_cls, want_reg = out["head"]
    _close(cls.numpy(), want_cls, 1e-4, "cls")
    _close(reg.numpy(), want_reg, 1e-4, "reg")
    assert not cls[0, 13:].any() and cls[0, :13].abs().min() > 0


def test_decode_rcnn_boxes(parts):
    x = parts["x"]
    got = trh.decode_rcnn_boxes(_t(x["dec_rois"]), _t(x["dec_reg"]))
    np.testing.assert_allclose(got.numpy(), parts["out"]["rcnn_boxes"],
                               atol=1e-5, rtol=1e-5)


def test_proposal_nms(parts):
    """Decode + NMS over 2048 anchors at pre 1024 (the chunked IoU): the
    kept indices and mask exactly; `proposal_layer`'s RoIs (the kept
    boxes) to 1e-4."""
    out, x = parts["out"], parts["x"]
    cfg = tvr.VoxelRCNNConfig(**NMS_GEOM)
    preds = {k: _t(v) for k, v in x["nms_preds"].items()}
    anchors = tvr.build_anchors(cfg)
    scores, boxes = tah.anchor_head_decode(preds["cls"], preds["box"],
                                           preds["dir"], anchors,
                                           ResidualCoder())
    idx, mask = nms_bev(boxes, scores.amax(-1), cfg.test_nms_thresh,
                        cfg.test_pre_nms, cfg.test_post_nms)
    want_idx, want_mask = out["nms"]
    np.testing.assert_array_equal(mask[0].numpy(), want_mask)
    np.testing.assert_array_equal(idx[0].numpy(), want_idx)
    # NMS suppressed some of the 100 best-scored candidates
    best = torch.sort(scores.amax(-1)[0], descending=True,
                      stable=True).indices[:cfg.test_post_nms]
    assert want_mask.any() and set(want_idx) != set(best.tolist())
    rois, roi_scores, roi_mask = tvr.proposal_layer(cfg, preds, anchors)
    np.testing.assert_array_equal(roi_mask[0].numpy(), want_mask)
    _close(rois[0].numpy(), out["nms_boxes"][want_idx], 1e-4, "rois")
    np.testing.assert_allclose(roi_scores[0].numpy(),
                               out["nms_scores"][want_idx] * want_mask,
                               atol=1e-6)


def test_post_processing(parts):
    """Refined boxes, sigmoid scores, NMS at 0.1 and the 0.3 threshold:
    valid exactly, boxes and scores to 1e-5."""
    x, want = parts["x"], parts["out"]["post"]
    got = tvr.voxel_rcnn_post_processing(
        TCFG, _t(x["post_rois"]), _t(x["post_mask"]), _t(x["post_cls"]),
        _t(x["post_reg"]))
    np.testing.assert_array_equal(got["valid"].numpy(), want["valid"])
    assert 0 < want["valid"].sum()
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    np.testing.assert_allclose(got["boxes"].numpy(), want["boxes"],
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["scores"].numpy(), want["scores"],
                               atol=1e-6)
