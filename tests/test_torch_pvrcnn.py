"""df3d_torch's PV-RCNN against df3d's: the chain voxelize -> PVRCNN
(VoxelBackBone8x, BEV neck, anchor head, VoxelSetAbstraction over the raw
points and all four sparse stages, the BEV sample, PointHeadSimple's
weighting) -> proposal_layer -> PVRCNNRoIHead -> voxel_rcnn_post_processing
on tests/test_pvrcnn.py's tiny geometry (a 64x64 grid) with every VSA
scale, batch 2; and its parts: FPS, every ball query of the keypoints and
the RoI head's two-stage neighbour search, point_fg_labels with keypoints
on enlarged box faces, point_cls_loss, sample_image_features past the
map's edges, MLP. Flax variables are seeded numpy on `jax.eval_shape`
trees, carried across by df3d_torch.weights (strictly), and at full
KITTI width (`PVRCNNConfig()`) the trees carry with every leaf landing
once.

Every JAX function runs inside one jitted program (`_jax_program`),
where XLA fuses FPS's and the ball queries' distance sums, the voxel
centres and the box test into the multiply-add chains the port rounds
like. Exact: FPS indices, keypoints, every ball-query index and mask, the
RoI neighbour indices and masks (of a keypoint with no neighbour, the
masks: see `test_ball_queries`), the backbone's stage coords, the
proposal NMS's kept boxes and roi_mask, the final valid mask, fg labels.
The chain's proposal NMS, RoI neighbour search and final NMS read floats
that differ from JAX's by rounding, so they take JAX's decision where
theirs differs, as a near tie and only so (`_jax_decisions`, held in
`test_chain`).
Float outputs to 1e-4 * max|ref| + 1e-5 (f32, another summation order):
the stage features, RPN maps, VSA features, fg logits, the loss, RoIs, the
RoI head's cls and reg, final boxes and scores, the bilinear sample and
the MLP."""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d.core import boxes as jboxes
from df3d.core.calib import voxel_centers_from_coords as jcenters
from df3d.models.detectors import pv_rcnn as jpv
from df3d.models.detectors import voxel_rcnn as jvr
from df3d.models.fusion.projection import sample_image_features as jsample
from df3d.models.heads import point_head as jph
from df3d.models.layers import MLP as JMLP
from df3d.models.pfe import VSAConfig as JVSAConfig
from df3d.models.pfe import VSAScaleCfg as JVSAScaleCfg
from df3d.ops import pointops as jpo
from df3d.ops import roi_ops as jroi
from df3d.ops.voxelize import voxelize_batch as jvoxelize_batch
from df3d_torch.core.boxes import enlarge_box3d, points_in_boxes
from df3d_torch.entry import infer_pvrcnn
from df3d_torch.models.detectors import pv_rcnn as tpv
from df3d_torch.models.detectors import voxel_rcnn as tvr
from df3d_torch.models.fusion.projection import sample_image_features
from df3d_torch.models.heads.point_head import (
    point_cls_loss, point_fg_labels,
)
from df3d_torch.models.layers import MLP
from df3d_torch.models.pfe import VSAConfig, VSAScaleCfg
from df3d_torch.ops import pointops as tpo
from df3d_torch.ops import roi_ops as troi
from df3d_torch.ops.voxelize import voxelize_batch
from df3d_torch.weights import state_dict_from_flax
from torch_port_helpers import load_flax, seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
GEOM = dict(pc_range=(0.0, -16.0, -2.4, 32.0, 16.0, 2.4),
            voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64),
            max_voxels=256, num_point_features=4,
            stage_caps=(256, 192, 128, 96), test_pre_nms=128,
            test_post_nms=8)
# every VSA scale (tests/test_pvrcnn.py's TINY has conv3 alone)
SCALES = (("conv1", 1, 0.8), ("conv2", 2, 1.2), ("conv3", 4, 1.6),
          ("conv4", 8, 2.4))
VSA = dict(num_keypoints=48, raw_radius=1.0, raw_nsample=8, out_channels=32)
ROI = dict(roi_grid_size=3, roi_max_local=32, roi_nsample=4, roi_radius=2.0)
N_POINTS = 400
GT = np.array([[[8.0, 0.0, 0.0, 4.0, 2.0, 1.6, 0.0],
                [20.0, 5.0, -0.5, 6.0, 3.0, 2.0, 0.7]]] * 2, np.float32)


def _config(pkg_vr, pkg_pv, scale_cfg, vsa_cfg):
    return pkg_pv.PVRCNNConfig(
        base=pkg_vr.VoxelRCNNConfig(**GEOM),
        vsa=vsa_cfg(scales=tuple(scale_cfg(k, d, r, nsample=4, mlp=(8, 8))
                                 for k, d, r in SCALES), **VSA), **ROI)


JCFG = _config(jvr, jpv, JVSAScaleCfg, JVSAConfig)
TCFG = _config(tvr, tpv, VSAScaleCfg, VSAConfig)


def _tol(got, want, err_msg=""):
    """max |got - want| <= 1e-4 * max |want| + 1e-5."""
    want = np.asarray(want)
    atol = 1e-4 * (np.abs(want).max() if want.size else 0.0) + 1e-5
    np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=0,
                               err_msg=err_msg)


def _face_points(rng, boxes, per_box=40):
    """Points on the faces of `boxes` (M, 7) grown by 0.2 m (one local
    coordinate at +-half the grown size, rotated into the world frame in
    f32) and around them."""
    out = []
    for b in boxes:
        big = b[3:6] + np.float32(0.2)
        c, s = np.cos(b[6]), np.sin(b[6])
        for _ in range(per_box):
            loc = rng.uniform(-0.6, 0.6, 3) * big
            k = rng.randint(3)
            loc[k] = np.sign(loc[k] + 1e-9) * big[k] / 2
            out.append([b[0] + loc[0] * c - loc[1] * s,
                        b[1] + loc[0] * s + loc[1] * c, b[2] + loc[2]])
    return np.asarray(out, np.float32)


def _inputs():
    rng = np.random.RandomState(0)
    points = np.concatenate([rng.uniform(0, 31, (2, N_POINTS, 1)),
                             rng.uniform(-15, 15, (2, N_POINTS, 1)),
                             rng.uniform(-1.8, 1.8, (2, N_POINTS, 1)),
                             rng.uniform(0, 1, (2, N_POINTS, 1))], -1)
    # half of them in four clusters (std 0.6 m, full ball-query groups),
    # all on a 5 cm lattice, so that FPS and the ball queries meet ties
    centres = np.array([[8.0, 0.0, 0.0], [20.0, 5.0, -0.5], [12.0, -8.0, 0.5],
                        [25.0, 10.0, 0.0]])
    half = N_POINTS // 2
    points[:, half:, :3] = (centres[rng.randint(0, 4, (2, half))]
                            + 0.6 * rng.randn(2, half, 3))
    points[..., :3] = np.round(points[..., :3] * 20) / 20
    valid = np.ones((2, N_POINTS), bool)
    valid[1, -50:] = False
    faces = np.stack([_face_points(rng, GT[0]), _face_points(rng, GT[1])])
    # RoIs on the clusters (the chain's own RoIs hold few keypoints), one
    # of them masked
    rois = np.concatenate([centres[None, [0, 1, 2, 3, 0]].repeat(2, 0)
                           + 0.3 * rng.randn(2, 5, 3),
                           rng.uniform(2.0, 4.0, (2, 5, 3)),
                           rng.uniform(-np.pi, np.pi, (2, 5, 1))], -1)
    roi_mask = np.ones((2, 5), bool)
    roi_mask[1, 4] = False
    return dict(points=points.astype(np.float32), valid=valid,
                rois=rois.astype(np.float32), roi_mask=roi_mask,
                gt_boxes=GT, gt_valid=np.array([[True, True], [True, False]]),
                face_points=faces,
                bev=rng.randn(2, 8, 12, 5).astype(np.float32),
                uv=rng.uniform(-0.2, 1.2, (2, 64, 2)).astype(np.float32),
                mlp_x=rng.randn(2, 7, 6).astype(np.float32))


def _variables():
    """Seeded flax variables of the chain's three modules."""
    model, head = jpv.PVRCNN(JCFG), jpv.PVRCNNRoIHead(JCFG)
    pts = jnp.zeros((1, N_POINTS, 4))
    ok = jnp.ones((1, N_POINTS), bool)
    res = jax.eval_shape(lambda p, v: jvoxelize_batch(
        p, v, JCFG.base.voxel_size, JCFG.base.pc_range, JCFG.base.grid_size,
        JCFG.base.max_voxels, 5), pts, ok)
    out, shapes = jax.eval_shape(lambda *a: model.init_with_output(
        KEY, *a, train=False), res.features, res.coords, pts, ok)
    r = GEOM["test_post_nms"]
    rois = jnp.zeros((1, r, 7)).at[..., 3:6].set(1.0)
    hshapes = jax.eval_shape(lambda k, f: head.init(
        KEY, rois, jnp.ones((1, r), bool), k, f, train=False),
        out["keypoints"], out["kp_feats"])
    mshapes = jax.eval_shape(lambda x: JMLP((5, 3)).init(KEY, x),
                             jnp.zeros((1, 6)))
    return dict(model=seeded_variables(shapes, np.random.RandomState(1)),
                head=seeded_variables(hshapes, np.random.RandomState(2)),
                mlp=seeded_variables(mshapes, np.random.RandomState(3)))


def _jax_program():
    """The one jitted JAX program every case reads."""
    cfg = JCFG.base
    model, head = jpv.PVRCNN(JCFG), jpv.PVRCNNRoIHead(JCFG)
    anchors = jvr.build_anchors(cfg)

    @jax.jit
    def run(v, b):
        res = jvoxelize_batch(b["points"], b["valid"], cfg.voxel_size,
                              cfg.pc_range, cfg.grid_size, cfg.max_voxels,
                              cfg.max_points_per_voxel)
        out = model.apply(v["model"], res.features, res.coords, b["points"],
                          b["valid"], train=False)
        rois, roi_scores, roi_mask = jvr.proposal_layer(cfg, out, anchors,
                                                        False)
        cls, reg = head.apply(v["head"], rois, roi_mask, out["keypoints"],
                              out["kp_feats"], train=False)
        det = jvr.voxel_rcnn_post_processing(cfg, rois, roi_scores, roi_mask,
                                             cls, reg)
        xyz = b["points"][..., :3]
        kp = out["keypoints"]
        fps = jax.vmap(lambda x, m: jpo.furthest_point_sample(
            x, m, JCFG.vsa.num_keypoints))(xyz, b["valid"])
        groups = {"raw": jax.vmap(lambda k, x, m: jpo.ball_query(
            k, x, m, JCFG.vsa.raw_radius, JCFG.vsa.raw_nsample))(
                kp, xyz, b["valid"])}
        for s in JCFG.vsa.scales:
            st = out["ms"][s.feature_key]
            centres = jcenters(st.coords, cfg.voxel_size, cfg.pc_range,
                               s.downsample)
            groups[s.feature_key] = jax.vmap(
                lambda k, x, m: jpo.ball_query(k, x, m, s.radius,
                                               s.nsample))(
                kp, centres, st.valid)

        def neighbours(rois_s, kp_s):
            grid = jroi.roi_grid_points(rois_s, JCFG.roi_grid_size)
            lidx, lmask = jroi.collect_local_voxels(
                rois_s[:, :3], kp_s, jnp.ones(kp_s.shape[0], bool), 4.0,
                JCFG.roi_max_local)
            return (lidx, lmask) + jroi.grid_ball_query(
                grid, kp_s, lidx, lmask, JCFG.roi_radius, JCFG.roi_nsample)

        # the chain's decisions, in the order the port's path takes them:
        # the proposal NMS, the RoI head's two-stage neighbour search, the
        # final NMS (the same functions on the same values as inside
        # proposal_layer, the head and the post-processing)
        scores, boxes = jvr.anchor_head_decode(
            out["cls"], out["box"], out["dir"], anchors, jvr.ResidualCoder())
        proposal_in = (boxes, scores.max(-1))
        proposal_nms = jax.vmap(lambda x, s: jvr.NMS.nms_bev(
            x, s, cfg.test_nms_thresh, cfg.test_pre_nms,
            cfg.test_post_nms))(*proposal_in)
        chain_nb = jax.vmap(neighbours)(rois, kp)
        every = jnp.ones(kp.shape[:2], bool)
        final_in = (jvr.decode_rcnn_boxes(rois, reg),
                    jax.nn.sigmoid(cls[..., 0]) * roi_mask)
        final_nms = jax.vmap(lambda x, s: jvr.NMS.nms_bev(
            x, s, cfg.final_nms_thresh, x.shape[0], cfg.final_max_boxes))(
            *final_in)
        decisions = [
            (proposal_in, proposal_nms),
            ((rois[..., :3], kp, every), chain_nb[:2]),
            ((jax.vmap(lambda r: jroi.roi_grid_points(
                r, JCFG.roi_grid_size))(rois), kp) + chain_nb[:2],
             chain_nb[2:]),
            (final_in, final_nms)]
        labels = jph.point_fg_labels(kp, b["gt_boxes"], b["gt_valid"])
        face_labels = jph.point_fg_labels(b["face_points"], b["gt_boxes"],
                                          b["gt_valid"])
        big = jboxes.enlarge_box3d(b["gt_boxes"], (0.2, 0.2, 0.2))
        return dict(
            coords=res.coords, out=out, rois=rois, roi_mask=roi_mask,
            cls=cls, reg=reg, det=det, fps=fps, groups=groups,
            decisions=decisions,
            neighbours=jax.vmap(neighbours)(b["rois"], kp),
            head_on_clusters=head.apply(v["head"], b["rois"], b["roi_mask"],
                                        kp, out["kp_feats"], train=False),
            labels=labels, face_labels=face_labels,
            face_inside=jax.vmap(jboxes.points_in_boxes)(b["face_points"],
                                                         big),
            loss=jph.point_cls_loss(out["point_fg_logits"], labels),
            loss_valid=jph.point_cls_loss(out["point_fg_logits"], labels,
                                          b["valid"][:, :kp.shape[1]]),
            sample=jsample(b["bev"], b["uv"], b["uv"][..., 0] < 1.1),
            mlp=JMLP((5, 3)).apply(v["mlp"], b["mlp_x"]))

    return run


@contextlib.contextmanager
def _jax_decisions(decisions):
    """Give the port's chain JAX's decisions where its own differ: the
    proposal NMS, the RoI head's two-stage neighbour search and the final
    NMS, in that call order, each a ((JAX's tensor inputs), (JAX's idx,
    mask)) of `_jax_program`. A call whose outputs differ from JAX's gets
    JAX's, and yields a replay (call, rows that differ: a sample's NMS, a
    RoI's local keypoints or a grid point's group, the most its
    float inputs lie from JAX's over `_tol`'s bound, whether the port's
    function on JAX's inputs gives JAX's outputs exactly)."""
    calls, replays = iter(decisions), []
    patched = [(tvr, "nms_bev"), (tpv, "collect_local_voxels"),
               (tpv, "grid_ball_query")]
    originals = {(m, n): getattr(m, n) for m, n in patched}

    def wrap(fn, name):
        def decided(*args):
            got = fn(*args)
            jargs, jout = next(calls)
            want = tuple(torch.from_numpy(np.asarray(w)).to(g.dtype)
                         for w, g in zip(jout, got))
            if all(torch.equal(g, w) for g, w in zip(got, want)):
                return got
            jargs = [torch.from_numpy(np.asarray(a)) for a in jargs]
            off = max(float((a - j).abs().max()) / (
                1e-4 * float(j.abs().max()) + 1e-5)
                for a, j in zip(args, jargs) if j.is_floating_point())
            own = fn(*jargs, *args[len(jargs):])
            rows = sum((g != w).flatten(got[0].dim() - 1).any(-1)
                       for g, w in zip(got, want)).bool()
            replays.append((name, int(rows.sum()), off,
                            all(torch.equal(o, w.to(o.dtype))
                                for o, w in zip(own, want))))
            return want
        return decided

    for m, n in patched:
        setattr(m, n, wrap(originals[m, n], n))
    try:
        yield replays
    finally:
        for (m, n), fn in originals.items():
            setattr(m, n, fn)
        assert next(calls, None) is None, "a decision was never taken"


@pytest.fixture(scope="module")
def runs():
    batch = _inputs()
    variables = _variables()
    want = jax.tree_util.tree_map(np.array, _jax_program()(
        variables, {k: jnp.asarray(v) for k, v in batch.items()}))

    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    model = load_flax(tpv.PVRCNN(TCFG), variables["model"]).eval()
    head = load_flax(tpv.PVRCNNRoIHead(TCFG), variables["head"]).eval()
    cfg = TCFG.base
    with torch.no_grad():
        res = voxelize_batch(t["points"], t["valid"], cfg.voxel_size,
                             cfg.pc_range, cfg.grid_size, cfg.max_voxels,
                             cfg.max_points_per_voxel)
        preds, _ = model(res.features, res.coords, t["points"], t["valid"])
    with _jax_decisions(want["decisions"]) as replays:
        det, _ = infer_pvrcnn(model, head, TCFG, t["points"], t["valid"])
    return dict(batch=batch, t=t, want=want, variables=variables,
                model=model, head=head, res=res, preds=preds,
                rois=det["rois"], roi_mask=det["roi_mask"],
                cls=det["rcnn_cls"], reg=det["rcnn_reg"], det=det,
                replays=replays)


def test_fps_and_keypoints(runs):
    """Exact D-FPS over the raw points (invalid points never picked; the
    second sample has 50) and the keypoints it picks."""
    t, want = runs["t"], runs["want"]
    idx = tpo.furthest_point_sample(t["points"][..., :3], t["valid"],
                                    TCFG.vsa.num_keypoints)
    np.testing.assert_array_equal(idx.numpy(), want["fps"])
    assert runs["batch"]["valid"][1][want["fps"][1]].all()
    np.testing.assert_array_equal(runs["preds"]["keypoints"].numpy(),
                                  want["out"]["keypoints"])


@pytest.mark.parametrize("group", ["raw"] + [s[0] for s in SCALES])
def test_ball_queries(runs, group):
    """Each ball query of the keypoints, the raw points' and each sparse
    stage's (voxel centres at its stride, padding rows invalid): indices
    and masks exactly, with some groups full and some empty."""
    t, want, preds = runs["t"], runs["want"], runs["preds"]
    kp = torch.from_numpy(want["out"]["keypoints"])
    if group == "raw":
        xyz, valid = t["points"][..., :3], t["valid"]
        radius, ns = TCFG.vsa.raw_radius, TCFG.vsa.raw_nsample
    else:
        s = next(s for s in TCFG.vsa.scales if s.feature_key == group)
        st = preds["ms"][group]
        from df3d_torch.core.calib import voxel_centers_fma
        xyz = voxel_centers_fma(st.coords, TCFG.base.voxel_size,
                                TCFG.base.pc_range, s.downsample)
        valid, radius, ns = st.valid, s.radius, s.nsample
    idx, mask = tpo.ball_query(kp, xyz, valid, radius, ns)
    widx, wmask = want["groups"][group]
    np.testing.assert_array_equal(mask.numpy(), wmask)
    some = wmask.any(-1)
    np.testing.assert_array_equal(idx.numpy()[some], widx[some])
    # a keypoint with no neighbour: index 0 in every slot, as pointnet2's
    # kernel leaves it; JAX's approx_max_k under `jit` gives the first of
    # an unstable sort of n equal keys there (176 of 256 rows), which no
    # caller reads (every slot is masked)
    assert (idx.numpy()[~some] == 0).all()
    assert some.any() and (wmask.sum(-1) > 1).any()


def test_backbone_stages(runs):
    """Voxel coords and every stage's coords exactly, features to the
    tolerance; the RPN maps."""
    want, preds = runs["want"], runs["preds"]
    np.testing.assert_array_equal(runs["res"].coords.numpy(), want["coords"])
    for k in ("conv1", "conv2", "conv3", "conv4"):
        np.testing.assert_array_equal(preds["ms"][k].coords.numpy(),
                                      want["out"]["ms"][k].coords)
        _tol(preds["ms"][k].features.numpy(), want["out"]["ms"][k].features,
             k)
    for k in ("cls", "box", "dir"):
        _tol(preds[k].numpy(), want["out"][k], k)


def test_vsa_and_point_head(runs):
    """The weighted keypoint features and the fg logits."""
    want, preds = runs["want"]["out"], runs["preds"]
    _tol(preds["kp_feats"].numpy(), want["kp_feats"], "kp_feats")
    _tol(preds["point_fg_logits"].numpy(), want["point_fg_logits"],
         "point_fg_logits")
    assert np.abs(want["kp_feats"]).max() > 0


def test_point_labels_and_loss(runs):
    """point_fg_labels exactly, for the keypoints and for points on the
    faces of the grown gt boxes (the box test at its edge: XLA's sin, cos
    and multiply-adds decide the side); point_cls_loss over all and over
    valid keypoints."""
    t, want, preds = runs["t"], runs["want"], runs["preds"]
    kp = torch.from_numpy(want["out"]["keypoints"])
    labels = point_fg_labels(kp, t["gt_boxes"], t["gt_valid"])
    np.testing.assert_array_equal(labels.numpy(), want["labels"])
    faces = point_fg_labels(t["face_points"], t["gt_boxes"], t["gt_valid"])
    np.testing.assert_array_equal(faces.numpy(), want["face_labels"])
    inside = points_in_boxes(t["face_points"], enlarge_box3d(
        t["gt_boxes"], (0.2, 0.2, 0.2)))
    np.testing.assert_array_equal(inside.numpy(), want["face_inside"])
    assert 0 < want["face_inside"].mean() < 1 and want["labels"].any()
    logits = torch.from_numpy(want["out"]["point_fg_logits"])
    _tol(point_cls_loss(logits, labels).item(), want["loss"], "loss")
    kvalid = t["valid"][:, :kp.shape[1]].float()
    _tol(point_cls_loss(logits, labels, kvalid).item(), want["loss_valid"],
         "loss valid")


def test_roi_neighbours_and_head(runs):
    """The RoI head on RoIs over the clusters, given JAX's keypoints and
    features: the local keypoints and the grid points' neighbours exactly,
    cls and reg to the tolerance (zero for the masked RoI)."""
    want, head = runs["want"], runs["head"]
    rois = runs["t"]["rois"]
    kp = torch.from_numpy(want["out"]["keypoints"])
    grid = troi.roi_grid_points(rois, TCFG.roi_grid_size)
    every = torch.ones(kp.shape[:2], dtype=torch.bool)
    lidx, lmask = troi.collect_local_voxels(rois[..., :3], kp, every, 4.0,
                                            TCFG.roi_max_local)
    nidx, nmask = troi.grid_ball_query(grid, kp, lidx, lmask,
                                       TCFG.roi_radius, TCFG.roi_nsample)
    for got, w, name in zip((lidx, lmask, nidx, nmask), want["neighbours"],
                            ("local idx", "local mask", "idx", "mask")):
        np.testing.assert_array_equal(got.numpy(), w, err_msg=name)
    assert want["neighbours"][3].mean() > 0.05
    with torch.no_grad():
        cls, reg = head(rois, runs["t"]["roi_mask"], kp,
                        torch.from_numpy(want["out"]["kp_feats"]))
    _tol(cls.numpy(), want["head_on_clusters"][0], "cls")
    _tol(reg.numpy(), want["head_on_clusters"][1], "reg")
    assert not reg[1, 4].any()


def _match(candidates, picked, tol):
    """The index of the one row of `candidates` (N, 7) that each row of
    `picked` (K, 7) equals within `tol`; every other row lies farther."""
    d = np.abs(candidates[None] - picked[:, None]).max(-1)
    part = np.sort(d, -1)
    assert (part[:, 0] <= tol).all() and (part[:, 1] > tol).all()
    return d.argmin(-1)


def test_chain(runs):
    """The whole chain on the port's own intermediates: the proposals
    (roi_mask exactly, each RoI the one JAX box it matches), the RoI
    head's cls and reg, the final boxes, scores and valid mask. The
    proposal NMS, the RoI neighbour search and the final NMS take JAX's
    decisions where the port's differ (`_jax_decisions`): at most 4 rows
    in all, each call's float inputs within the tolerance below of JAX's
    (a near tie: 1e-4 * max|ref| + 1e-5), and the port's function on
    JAX's own inputs giving JAX's decision exactly."""
    replays = runs["replays"]
    print(f"replayed decisions (call, rows, inputs' distance over the "
          f"tolerance, exact on JAX's inputs): {replays}")
    assert sum(n for _, n, _, _ in replays) <= 4, replays
    assert all(off <= 1 and own for _, _, off, own in replays), replays
    want = runs["want"]
    np.testing.assert_array_equal(runs["roi_mask"].numpy(), want["roi_mask"])
    tol = 1e-4 * np.abs(want["rois"]).max() + 1e-5
    for i in range(2):
        m = want["roi_mask"][i]
        assert m.any()
        np.testing.assert_array_equal(
            _match(runs["rois"][i].numpy()[m], want["rois"][i][m], tol),
            np.arange(int(m.sum())))
    _tol(runs["rois"].numpy(), want["rois"], "rois")
    _tol(runs["cls"].numpy(), want["cls"], "cls")
    _tol(runs["reg"].numpy(), want["reg"], "reg")
    np.testing.assert_array_equal(runs["det"]["valid"].numpy(),
                                  want["det"]["valid"])
    _tol(runs["det"]["boxes"].numpy(), want["det"]["boxes"], "boxes")
    _tol(runs["det"]["scores"].numpy(), want["det"]["scores"], "scores")


def test_sample_image_features(runs):
    """The bilinear sample against the JAX package's, corners past the
    map's edges reading zeros and masked rows zero."""
    t, want = runs["t"], runs["want"]
    got = sample_image_features(t["bev"], t["uv"], t["uv"][..., 0] < 1.1)
    _tol(got.numpy(), want["sample"], "sample")
    assert (want["sample"][runs["batch"]["uv"][..., 0] >= 1.1] == 0).all()


def test_mlp(runs):
    got = load_flax(MLP(6, (5, 3)), runs["variables"]["mlp"])(
        runs["t"]["mlp_x"])
    _tol(got.detach().numpy(), runs["want"]["mlp"], "mlp")


def test_weights_carry_at_full_width():
    """`PVRCNNConfig()` (KITTI, 2048 keypoints, 100 RoIs, grid 6): the JAX
    package's flax trees (shapes from `jax.eval_shape`) carry into the
    port's modules with every leaf landing in one entry and every entry
    filled."""
    jcfg, tcfg = jpv.PVRCNNConfig(), tpv.PVRCNNConfig()
    n, v = 1000, 500
    out, shapes = jax.eval_shape(lambda *a: jpv.PVRCNN(jcfg).init_with_output(
        KEY, *a, train=False), jnp.zeros((1, v, 4)),
        jnp.zeros((1, v, 3), jnp.int32), jnp.zeros((1, n, 4)),
        jnp.ones((1, n), bool))
    hshapes = jax.eval_shape(lambda k, f: jpv.PVRCNNRoIHead(jcfg).init(
        KEY, jnp.zeros((1, 100, 7)), jnp.ones((1, 100), bool), k, f,
        train=False), out["keypoints"], out["kp_feats"])
    for module, tree in ((tpv.PVRCNN(tcfg), shapes),
                         (tpv.PVRCNNRoIHead(tcfg), hshapes)):
        zeros = jax.tree_util.tree_map(
            lambda s: np.zeros(s.shape, np.float32), tree)
        sd = state_dict_from_flax(module, zeros)
        assert set(sd) == set(module.state_dict())
        n_leaves = len(jax.tree_util.tree_leaves(zeros))
        assert n_leaves == len([k for k in sd
                                if not k.endswith("num_batches_tracked")])
    assert dataclasses.asdict(tcfg.vsa) == dataclasses.asdict(jcfg.vsa)
