"""df3d_torch's Voxel R-CNN training parts against df3d's, one at a time,
on seeded numpy inputs: the residual coder's encode, `iou_nearest_bev`,
`boxes_to_corners_3d`, `weighted_smooth_l1`, the anchor target assigner
(with two gts forcing one anchor), the sin-difference and the anchor head
loss (with direction bins on their boundaries), `assign_rpn_targets`, the
training proposal layer (NMS at 0.8), the proposal target layer (JAX's
noise draws passed in), `canonical_reg_targets` (with anti-aligned RoIs),
`rcnn_loss`, `voxel_rcnn_train_losses` and the RCNN head in training mode
(batch statistics, gradients through the neighbour gather and the
max-pool).

Every JAX function runs in one jitted program, as the training step runs
it (XLA's fused multiply-adds decide the last bit of what the thresholds
and floors read). Exact: labels, best gts, force-matches, the RoIs and gts
the sampler picks, reg_valid, mask, NMS keep masks. Losses rtol 1e-5;
values (codes, IoUs, corners, targets) 1e-5; gradients (via `jax.vjp`,
one seeded cotangent) per leaf 1e-4 * max|ref| + 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d.core.box_coders import ResidualCoder as JCoder
from df3d.core.boxes import boxes_to_corners_3d as jcorners
from df3d.core.iou import iou_nearest_bev as jnearest
from df3d.models import losses as jlosses
from df3d.models.detectors import voxel_rcnn as jvr
from df3d.models.heads import anchor_head as jah
from df3d.models.heads import voxelrcnn_head as jrh
from df3d.ops import sparse as jsp
from df3d_torch.core.box_coders import ResidualCoder
from df3d_torch.core.boxes import boxes_to_corners_3d
from df3d_torch.core.iou import iou_nearest_bev
from df3d_torch.models import losses as tlosses
from df3d_torch.models.detectors import voxel_rcnn as tvr
from df3d_torch.models.heads import anchor_head as tah
from df3d_torch.models.heads import voxelrcnn_head as trh
from df3d_torch.ops import sparse as tsp
from df3d_torch.weights import params_from_flax, state_dict_from_flax
from torch_port_helpers import seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
# tests/test_train_steps.py's Voxel R-CNN geometry (an 8 x 8 BEV map, 128
# anchors), its training NMS and a head of 8 RoIs a sample
GEOM = dict(pc_range=(0.0, -16.0, -2.4, 32.0, 16.0, 2.4),
            voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64),
            max_voxels=256, num_point_features=4,
            stage_caps=(256, 192, 128, 96), train_pre_nms=64,
            train_post_nms=16)
HEAD = dict(grid_size=3, max_local=32, roi_per_image=8)
SCALES = (("conv2", 2, 0.8), ("conv3", 4, 1.6))
# a 32 x 32 BEV map of anchors 0.26 m apart (2048), for the proposal NMS
# at pre 1024 (the chunked IoU) and 0.8
NMS_GEOM = dict(grid_size=(24, 256, 256),
                pc_range=(0.0, -4.0, -2.4, 8.0, 4.0, 2.4),
                train_pre_nms=1024, train_post_nms=64)


def _configs(vr, rh, **geom):
    return vr.VoxelRCNNConfig(**geom, rcnn=rh.VoxelRCNNHeadCfg(
        scales=tuple(rh.RoIPoolScaleCfg(*s, nsample=4) for s in SCALES),
        **HEAD))


JCFG, TCFG = _configs(jvr, jrh, **GEOM), _configs(tvr, trh, **GEOM)
JNMS, TNMS = jvr.VoxelRCNNConfig(**NMS_GEOM), tvr.VoxelRCNNConfig(**NMS_GEOM)


def _t(a):
    return torch.from_numpy(np.array(a))


def _tol(got, want, err_msg=""):
    """Per leaf: max |got - want| <= 1e-4 * max|want| + 1e-6."""
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=1e-4 * np.abs(want).max() + 1e-6,
                               err_msg=err_msg)


def _close(got, want, err_msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-5, err_msg=err_msg)


def _boxes(rng, n, lo, hi, size=(1.0, 4.5)):
    return np.concatenate([rng.uniform(lo, hi, (n, 3)),
                           rng.uniform(*size, (n, 3)),
                           rng.uniform(-np.pi, np.pi, (n, 1))],
                          -1).astype(np.float32)


def _assign_case():
    """The geometry's anchors and 6 gts: gt 0 on anchor 40, gt 1 the same
    box 0.3 m on (anchor 40 is the best of both: two gts force one anchor),
    gt 2 small and between anchors (forced below the thresholds), gt 3
    masked, gt 4 at 90 degrees (dx and dy swapped), gt 5 far off the map
    (no anchor overlaps it), gt 6 spanning anchors 80 and 82 (IoU 0.46
    with each: the first is forced, the second ignored)."""
    anchors = np.asarray(jvr.build_anchors(JCFG))
    a, b, c = anchors[40], anchors[80], anchors[82]
    span = [(b[0] + c[0]) / 2, b[1], b[2], c[0] - b[0] + b[3], b[4], b[5], 0]
    gts = np.stack([a, a + [0.3, 0, 0, 0, 0, 0, 0],
                    [9.1, 2.3, -1.0, 1.0, 0.8, 1.5, 0.2],
                    a + [0.5, 0.5, 0, 0, 0, 0, 0.1],
                    [20.0, -6.0, -1.0, 3.9, 1.6, 1.5, 1.55],
                    [100.0, 0.0, -1.0, 3.9, 1.6, 1.5, 0.0],
                    span]).astype(np.float32)
    mask = np.array([True, True, True, False, True, True, True])
    return anchors, gts, mask


def _boundary_headings(anchors):
    """reg_targets headings that put rot_gt - 0.78539 on a direction-bin
    boundary (0, pi and 2 pi of limit_period's period) and 4 ulps either
    side, against every anchor's rotation."""
    rot = []
    for k in range(-1, 3):
        centre = np.float32(0.78539 + k * np.pi)
        vals = [centre]
        for _ in range(4):
            vals.append(np.nextafter(vals[-1], np.float32(np.inf)))
            vals.insert(0, np.nextafter(vals[0], np.float32(-np.inf)))
        rot += vals
    rot = np.asarray(rot, np.float32)
    n = len(anchors) // len(rot) * len(rot)
    t6 = np.zeros(len(anchors), np.float32)
    t6[:n] = np.tile(rot, n // len(rot)) - anchors[:n, 6]
    return t6


def _stages(rng):
    """Random stage tensors conv2, conv3 of the geometry (features, coords
    with -1 padding rows), key-sorted, batch 2."""
    ms = {}
    for k, ds, width, n, pad in (("conv2", 2, 32, 300, 84),
                                 ("conv3", 4, 64, 150, 106)):
        shape = (25 // ds + 1, 64 // ds, 64 // ds)
        fs, cs = [], []
        for _ in range(2):
            flat = np.sort(rng.choice(np.prod(shape), n, replace=False))
            coords = np.stack(np.unravel_index(flat, shape), -1)
            fs.append(np.concatenate([rng.randn(n, width),
                                      np.zeros((pad, width))]))
            cs.append(np.concatenate([coords, -np.ones((pad, 3))]))
        ms[k] = (np.stack(fs).astype(np.float32),
                 np.stack(cs).astype(np.int32))
    return ms


def _inputs():
    rng = np.random.RandomState(0)
    x = {}
    x["enc_boxes"] = _boxes(rng, 40, -30.0, 30.0, (0.0, 4.0))
    x["enc_boxes"][:3, 3:6] = 0.0        # sizes floored at 1e-5
    x["enc_anchors"] = _boxes(rng, 40, -30.0, 30.0)
    x["near_a"] = _boxes(rng, 30, -5.0, 5.0)
    x["near_b"] = _boxes(rng, 7, -5.0, 5.0)
    x["near_b"][0] = x["near_a"][0]      # IoU 1
    x["corners"] = _boxes(rng, 12, -30.0, 30.0)
    x["sl1"] = (0.4 * rng.randn(3, 20, 7)).astype(np.float32)
    x["sl1_t"] = (0.4 * rng.randn(3, 20, 7)).astype(np.float32)
    x["sl1_w"] = rng.rand(3, 20).astype(np.float32)
    x["sl1_g"] = rng.randn(3, 20, 7).astype(np.float32)
    x["assign"] = _assign_case()
    # the anchor head loss, batch 2: sample 0's targets from the assigner,
    # sample 1's all positive with headings on the direction boundaries
    anchors = x["assign"][0]
    a = len(anchors)
    x["preds"] = {"cls": rng.randn(2, a, 1).astype(np.float32),
                  "box": (0.3 * rng.randn(2, a, 7)).astype(np.float32),
                  "dir": rng.randn(2, a, 2).astype(np.float32)}
    x["boundary_t6"] = _boundary_headings(anchors)
    x["loss_g"] = rng.randn(3).astype(np.float32)
    # assign_rpn_targets: two samples' gts (4 slots, the last masked)
    g = _boxes(rng, 8, 0.0, 1.0).reshape(2, 4, 7)
    g[..., 0] = rng.uniform(2.0, 30.0, (2, 4))
    g[..., 1] = rng.uniform(-14.0, 14.0, (2, 4))
    g[..., 3:6] = (3.9, 1.6, 1.56)
    x["rpn_gt"] = g
    x["rpn_valid"] = np.array([[1, 1, 1, 0], [1, 1, 0, 1]], bool)
    # the proposal NMS: 2048 anchors, small residuals, so that neighbours
    # overlap around 0.8
    an = 2 * JNMS.bev_size_xy[0] * JNMS.bev_size_xy[1]
    x["nms_preds"] = {"cls": rng.randn(2, an, 1).astype(np.float32),
                      "box": (0.05 * rng.randn(2, an, 7)).astype(np.float32),
                      "dir": rng.randn(2, an, 2).astype(np.float32)}
    # the proposal target layer: 24 proposals a sample around 4 gts, some
    # on a gt (IoU above the foreground thresholds), two equal (the noise
    # decides), anti-aligned ones, the last 5 masked (the fourth gt's all
    # but one)
    gts = _boxes(rng, 8, 0.0, 1.0).reshape(2, 4, 7)
    gts[..., 0] = rng.uniform(2.0, 30.0, (2, 4))
    gts[..., 1] = rng.uniform(-14.0, 14.0, (2, 4))
    gts[..., 3:6] = rng.uniform(1.5, 4.5, (2, 4, 3))
    rois = np.repeat(gts, 6, 1) + np.concatenate([
        0.3 * rng.randn(2, 24, 3), 0.2 * rng.randn(2, 24, 3),
        0.2 * rng.randn(2, 24, 1)], -1)
    rois[:, 1::6, 6] += np.pi            # anti-aligned with their gt
    rois[:, 2::6, :2] += 2.5             # background
    rois[:, 5] = rois[:, 4]              # equal IoUs
    x["rois"] = rois.astype(np.float32)
    x["roi_scores"] = rng.rand(2, 24).astype(np.float32)
    x["roi_mask"] = np.arange(24)[None].repeat(2, 0) < 19
    x["gts"] = gts.astype(np.float32)
    # sample 1: one valid gt, whose proposals but one are masked, so that
    # most of its foreground slots stay empty
    x["gt_valid"] = np.array([[1, 1, 1, 1], [0, 0, 0, 1]], bool)
    x["rcnn_cls"] = rng.randn(2, 8, 1).astype(np.float32)
    x["rcnn_reg"] = (0.3 * rng.randn(2, 8, 7)).astype(np.float32)
    x["rcnn_g"] = rng.randn(4).astype(np.float32)
    # the RCNN head in training: random stage tensors, 8 RoIs a sample
    # among their voxels, the last two masked
    x["ms"] = _stages(rng)
    hr = _boxes(rng, 16, 0.0, 1.0).reshape(2, 8, 7)
    hr[..., 0] = rng.uniform(2, 30, (2, 8))
    hr[..., 1] = rng.uniform(-14, 14, (2, 8))
    hr[..., 2] = rng.uniform(-1.5, 1.5, (2, 8))
    x["head_rois"] = hr
    x["head_mask"] = np.arange(8)[None].repeat(2, 0) < 6
    x["head_g"] = (rng.randn(2, 8, 1).astype(np.float32),
                   rng.randn(2, 8, 7).astype(np.float32))
    return x


def _sparse(ms):
    return {k: jsp.SparseTensor(f, c, (1, 1, 1)) for k, (f, c) in ms.items()}


@pytest.fixture(scope="module")
def parts():
    """The JAX package's outputs and gradients, one jitted program."""
    x = _inputs()
    head = jrh.VoxelRCNNHead(JCFG.rcnn, JCFG.voxel_size, JCFG.pc_range)
    head_vars = seeded_variables(jax.eval_shape(
        lambda ms: head.init(KEY, x["head_rois"], x["head_mask"],
                             _sparse(ms), train=False), x["ms"]),
        np.random.RandomState(2))

    @jax.jit
    def run(x, head_vars, rng):
        out = {}
        coder = JCoder()
        out["enc"] = coder.encode(x["enc_boxes"], x["enc_anchors"])
        out["nearest"] = jnearest(x["near_a"], x["near_b"])
        out["corners"] = jcorners(x["corners"])

        def sl1(p):
            return jlosses.weighted_smooth_l1(
                p, x["sl1_t"], x["sl1_w"], code_weights=(1, 1, 1, 1, 1, 1, 2))

        val, vjp = jax.vjp(sl1, x["sl1"])
        out["sl1"], out["sl1_grad"] = val, vjp(x["sl1_g"])[0]

        anchors, gts, mask = x["assign"]
        out["assign"] = jah.assign_anchor_targets(anchors, gts, mask, 0.6,
                                                  0.45, coder)
        labels, regs, _ = out["assign"]
        labels = jnp.stack([labels, jnp.ones_like(labels)])
        regs = jnp.stack([regs, regs.at[:, 6].set(x["boundary_t6"])])
        gtc = jnp.zeros_like(labels)

        def head_loss(p):
            _, logs = jah.anchor_head_loss(
                p["cls"], p["box"], p["dir"], labels, regs, anchors, gtc,
                num_classes=1)
            return jnp.stack([logs["rpn_cls_loss"], logs["rpn_loc_loss"],
                              logs["rpn_dir_loss"]]), logs

        _, vjp, logs = jax.vjp(head_loss, x["preds"], has_aux=True)
        out["head_loss"] = logs
        out["head_loss_grad"] = vjp(x["loss_g"])[0]
        out["head_targets"] = (labels, regs)
        out["sin"] = jah.add_sin_difference(x["sl1"][..., 6],
                                            x["sl1_t"][..., 6])

        out["rpn_targets"] = jvr.assign_rpn_targets(
            JCFG, jvr.build_anchors(JCFG), x["rpn_gt"],
            jnp.zeros((2, 4), jnp.int32), x["rpn_valid"])
        out["proposals"] = jvr.proposal_layer(
            JNMS, x["nms_preds"], jvr.build_anchors(JNMS), train=True)

        keys = jax.random.split(rng, 2)
        noise = jax.vmap(lambda k: jax.random.uniform(k, (24,)) * 1e-3)(keys)
        out["noise"] = noise
        out["sampled"] = jax.vmap(
            lambda k, r, s, m, g, gv: jrh.sample_rois_for_training(
                k, r, s, m, g, gv, JCFG.rcnn))(
            keys, x["rois"], x["roi_scores"], x["roi_mask"], x["gts"],
            x["gt_valid"])
        out["canonical"] = jrh.canonical_reg_targets(
            x["rois"], jnp.repeat(x["gts"], 6, 1))

        def rcnn(cls, reg):
            _, logs = jrh.rcnn_loss(cls, reg, out["sampled"], JCFG.rcnn)
            return jnp.stack([logs[k] for k in (
                "rcnn_cls_loss", "rcnn_reg_loss", "rcnn_corner_loss",
                "rcnn_loss")]), logs

        _, vjp, logs = jax.vjp(rcnn, x["rcnn_cls"], x["rcnn_reg"],
                               has_aux=True)
        out["rcnn_loss"] = logs
        out["rcnn_loss_grad"] = vjp(x["rcnn_g"])
        out["train_losses"] = jvr.voxel_rcnn_train_losses(
            JCFG, {k: v[:, :len(anchors)] for k, v in x["preds"].items()},
            {"cls": x["rcnn_cls"], "reg": x["rcnn_reg"]},
            {"labels": labels, "reg_targets": regs, "anchors": anchors,
             "gt_classes_per_anchor": gtc}, out["sampled"])[1]

        def head_fwd(params, feats):
            ms = {k: (f, x["ms"][k][1]) for k, f in feats.items()}
            return head.apply({"params": params,
                               "batch_stats": head_vars["batch_stats"]},
                              x["head_rois"], x["head_mask"], _sparse(ms),
                              train=True, mutable=["batch_stats"])

        (cls, reg), vjp, stats = jax.vjp(
            head_fwd, head_vars["params"],
            {k: f for k, (f, _) in x["ms"].items()}, has_aux=True)
        out["head"] = (cls, reg, stats["batch_stats"])
        out["head_grad"] = vjp(x["head_g"])
        return out

    out = jax.tree_util.tree_map(np.asarray,
                                 run(x, head_vars, jax.random.PRNGKey(7)))
    return dict(x=x, out=out, head_vars=head_vars)


def test_residual_encode(parts):
    """encode against JAX's, and decode(encode(b)) gives b back (sizes
    floored at 1e-5)."""
    x = parts["x"]
    boxes, anchors = _t(x["enc_boxes"]), _t(x["enc_anchors"])
    got = ResidualCoder().encode(boxes, anchors)
    _close(got.numpy(), parts["out"]["enc"])
    back = ResidualCoder().decode(got, anchors)
    _close(back[3:].numpy(), x["enc_boxes"][3:])


def test_iou_nearest_bev(parts):
    """Equal to the last bit: the port rounds the union as XLA does under
    `jit` (the target assigner's thresholds and argmaxes read it)."""
    x = parts["x"]
    got = iou_nearest_bev(_t(x["near_a"]), _t(x["near_b"]))
    want = parts["out"]["nearest"]
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, 0] == 1.0 and (want > 0).sum() > 5


def test_boxes_to_corners(parts):
    got = boxes_to_corners_3d(_t(parts["x"]["corners"]))
    assert got.shape == (12, 8, 3)
    _close(got.numpy(), parts["out"]["corners"])


def test_weighted_smooth_l1(parts):
    x, out = parts["x"], parts["out"]
    p = _t(x["sl1"]).requires_grad_(True)
    loss = tlosses.weighted_smooth_l1(p, _t(x["sl1_t"]), _t(x["sl1_w"]),
                                      code_weights=(1, 1, 1, 1, 1, 1, 2))
    _close(loss.detach().numpy(), out["sl1"])
    loss.backward(_t(x["sl1_g"]))
    _tol(p.grad.numpy(), out["sl1_grad"])
    # both sides of beta = 1/9 are taken
    n = np.abs(x["sl1"] - x["sl1_t"])
    assert (n < 1 / 9).any() and (n > 1 / 9).any()


def test_assign_anchor_targets(parts):
    """Labels, best gts exactly, reg_targets to 1e-5: gts 0 and 1 both
    force anchor 40 (one duplicate-index set); gt 2 forces its best anchor
    below the unmatched threshold; the masked gt and the one off the map
    give no positive."""
    anchors, gts, mask = parts["x"]["assign"]
    labels, regs, best = tah.assign_anchor_targets(
        _t(anchors), _t(gts), _t(mask), 0.6, 0.45, ResidualCoder())
    w_labels, w_regs, w_best = parts["out"]["assign"]
    np.testing.assert_array_equal(labels.numpy(), w_labels)
    np.testing.assert_array_equal(best.numpy(), w_best)
    _close(regs.numpy(), w_regs)
    iou = iou_nearest_bev(_t(anchors), _t(gts))
    assert int(iou[:, 0].argmax()) == int(iou[:, 1].argmax()) == 40
    forced = int(iou[:, 2].argmax())
    assert w_labels[forced] == 1 and iou[forced].max() < 0.45
    assert iou[:, 5].max() == 0
    assert w_labels[80] == 1 and w_labels[82] == -1


def test_add_sin_difference(parts):
    x = parts["x"]
    got = tah.add_sin_difference(_t(x["sl1"][..., 6]), _t(x["sl1_t"][..., 6]))
    for g, w in zip(got, parts["out"]["sin"]):
        _close(g.numpy(), w)


def _anchor_loss(parts):
    x = parts["x"]
    labels, regs = (_t(v) for v in parts["out"]["head_targets"])
    preds = {k: _t(v).requires_grad_(True) for k, v in x["preds"].items()}
    total, logs = tah.anchor_head_loss(
        preds["cls"], preds["box"], preds["dir"], labels, regs,
        _t(x["assign"][0]), torch.zeros_like(labels), num_classes=1)
    return preds, total, logs


def test_anchor_head_loss(parts):
    """The three losses (rtol 1e-5) and their gradients in the class,
    box and direction logits, both samples: per-sample positive counts."""
    out = parts["out"]
    preds, _, logs = _anchor_loss(parts)
    for k, v in out["head_loss"].items():
        np.testing.assert_allclose(logs[k].item(), v, rtol=1e-5, err_msg=k)
    torch.stack([logs["rpn_cls_loss"], logs["rpn_loc_loss"],
                 logs["rpn_dir_loss"]]).backward(_t(parts["x"]["loss_g"]))
    for k, p in preds.items():
        _tol(p.grad.numpy(), out["head_loss_grad"][k], k)


def test_direction_bins_on_the_boundary(parts):
    """Sample 1's headings lie on the direction bins' boundaries and 4
    ulps either side: the bin each anchor's cross entropy takes (the sign
    of its gradient in the second bin's logit) equals JAX's, and both bins
    occur."""
    preds, _, logs = _anchor_loss(parts)
    logs["rpn_dir_loss"].backward()
    got = (preds["dir"].grad[1, :, 1] < 0).numpy()
    t6 = parts["x"]["boundary_t6"]
    _, regs = parts["out"]["head_targets"]
    want = tah.direction_targets(_t(regs[1, :, 6])
                                 + _t(parts["x"]["assign"][0][:, 6]))
    np.testing.assert_array_equal(got, want.numpy() == 1)
    # JAX's bins, read from its gradient the same way
    jgrad = parts["out"]["head_loss_grad"]["dir"]
    assert (t6 != 0).sum() > 100
    # the cotangent weights the dir loss by loss_g[2]
    sign = np.sign(parts["x"]["loss_g"][2])
    np.testing.assert_array_equal(got, sign * jgrad[1, :, 1] < 0)
    assert got.any() and not got.all()


def test_assign_rpn_targets(parts):
    x, want = parts["x"], parts["out"]["rpn_targets"]
    anchors = tvr.build_anchors(TCFG)
    got = tvr.assign_rpn_targets(TCFG, anchors, _t(x["rpn_gt"]),
                                 torch.zeros(2, 4, dtype=torch.int32),
                                 _t(x["rpn_valid"]))
    np.testing.assert_array_equal(got["labels"].numpy(), want["labels"])
    np.testing.assert_array_equal(got["gt_classes_per_anchor"].numpy(),
                                  want["gt_classes_per_anchor"])
    _close(got["reg_targets"].numpy(), want["reg_targets"])
    assert (want["labels"] == 1).sum(1).min() > 0


def test_training_proposals(parts):
    """`proposal_layer(train=True)`: pre 1024 (the chunked IoU), NMS at
    0.8, 64 kept: roi_mask exactly, RoIs and scores to 1e-5; the NMS
    suppressed some of the best-scored candidates."""
    x = parts["x"]
    preds = {k: _t(v) for k, v in x["nms_preds"].items()}
    rois, scores, mask = tvr.proposal_layer(TNMS, preds,
                                            tvr.build_anchors(TNMS),
                                            train=True)
    w_rois, w_scores, w_mask = parts["out"]["proposals"]
    assert rois.shape == (2, 64, 7)
    np.testing.assert_array_equal(mask.numpy(), w_mask)
    _close(rois.numpy(), w_rois)
    np.testing.assert_allclose(scores.numpy(), w_scores, rtol=0, atol=1e-6)
    best = torch.sort(torch.sigmoid(preds["cls"][..., 0]), dim=-1,
                      descending=True, stable=True).values[:, :64]
    assert w_mask.all() and (np.sort(w_scores, -1) != np.sort(
        best.numpy(), -1)).any()


def _sampled(parts):
    x, out = parts["x"], parts["out"]
    return trh.sample_rois_for_training(
        _t(x["rois"]), _t(x["roi_scores"]), _t(x["roi_mask"]), _t(x["gts"]),
        _t(x["gt_valid"]), _t(out["noise"]), TCFG.rcnn)


def test_sample_rois_for_training(parts):
    """The picked RoIs, their scores and gts, reg_valid and mask exactly
    (JAX's noise draws passed in); the cls targets to 1e-5. Foreground and
    background slots both fill, and masked slots exist."""
    got, want = _sampled(parts), parts["out"]["sampled"]
    for k in ("rois", "roi_scores", "gt_of_roi", "reg_valid", "mask"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    _close(got["cls_targets"].numpy(), want["cls_targets"])
    assert want["reg_valid"].any() and not want["mask"].all()
    assert (want["mask"] & ~want["reg_valid"]).any()


def test_canonical_reg_targets(parts):
    """The RoI-frame targets, anti-aligned RoIs (every sixth, turned by pi)
    flipped back into [-pi/2, pi/2]."""
    x = parts["x"]
    gt = _t(np.repeat(x["gts"], 6, 1))
    got = trh.canonical_reg_targets(_t(x["rois"]), gt)
    _close(got.numpy(), parts["out"]["canonical"])
    assert (np.abs(got[..., 6].numpy()) <= np.pi / 2).all()


def test_rcnn_loss(parts):
    """BCE, smooth-L1 and corner losses (rtol 1e-5) and their gradients in
    the head's cls and reg outputs."""
    x, out = parts["x"], parts["out"]
    cls = _t(x["rcnn_cls"]).requires_grad_(True)
    reg = _t(x["rcnn_reg"]).requires_grad_(True)
    _, logs = trh.rcnn_loss(cls, reg, _sampled(parts), TCFG.rcnn)
    for k, v in out["rcnn_loss"].items():
        np.testing.assert_allclose(logs[k].item(), v, rtol=1e-5, err_msg=k)
    assert out["rcnn_loss"]["rcnn_corner_loss"] > 0
    torch.stack([logs[k] for k in (
        "rcnn_cls_loss", "rcnn_reg_loss", "rcnn_corner_loss",
        "rcnn_loss")]).backward(_t(x["rcnn_g"]))
    _tol(cls.grad.numpy(), out["rcnn_loss_grad"][0], "cls")
    _tol(reg.grad.numpy(), out["rcnn_loss_grad"][1], "reg")


def test_voxel_rcnn_train_losses(parts):
    x, out = parts["x"], parts["out"]
    labels, regs = (_t(v) for v in out["head_targets"])
    anchors = _t(x["assign"][0])
    preds = {k: _t(v) for k, v in x["preds"].items()}
    _, logs = tvr.voxel_rcnn_train_losses(
        TCFG, preds, {"cls": _t(x["rcnn_cls"]), "reg": _t(x["rcnn_reg"])},
        {"labels": labels, "reg_targets": regs, "anchors": anchors,
         "gt_classes_per_anchor": torch.zeros_like(labels)}, _sampled(parts))
    assert set(logs) == set(out["train_losses"])
    for k, v in out["train_losses"].items():
        np.testing.assert_allclose(logs[k].item(), v, rtol=1e-5, err_msg=k)


def test_rcnn_head_training(parts):
    """The RCNN head in training mode: cls and reg, every norm's running
    statistics after the step (batch statistics over the valid voxels,
    neighbours and RoIs), the gradients of every parameter and of the
    stage features (through the neighbour gather and the max-pool)."""
    x, out = parts["x"], parts["out"]
    head = trh.VoxelRCNNHead(TCFG.rcnn, TCFG.voxel_size, TCFG.pc_range)
    head.load_state_dict(state_dict_from_flax(head, parts["head_vars"]))
    head.train()
    feats = {k: _t(f).requires_grad_(True) for k, (f, _) in x["ms"].items()}
    ms = {k: tsp.SparseTensor(feats[k], _t(c), (1, 1, 1))
          for k, (_, c) in x["ms"].items()}
    cls, reg = head(_t(x["head_rois"]), _t(x["head_mask"]), ms)
    w_cls, w_reg, w_stats = out["head"]
    _tol(cls.detach().numpy(), w_cls, "cls")
    _tol(reg.detach().numpy(), w_reg, "reg")
    want = state_dict_from_flax(head, {"params": parts["head_vars"]["params"],
                                       "batch_stats": w_stats})
    got = head.state_dict()
    for k in want:
        if k.endswith(("running_mean", "running_var")):
            _tol(got[k].numpy(), want[k].numpy(), k)
    torch.autograd.backward((cls, reg), tuple(_t(g) for g in x["head_g"]))
    w_params, w_feats = out["head_grad"]
    for name, g in params_from_flax(head, w_params).items():
        _tol(dict(head.named_parameters())[name].grad.numpy(), g.numpy(),
             name)
    for k, f in feats.items():
        _tol(f.grad.numpy(), w_feats[k], k)
        assert f.grad.abs().sum() > 0
