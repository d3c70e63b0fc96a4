"""The TransFusion training step's parts, df3d_torch against df3d on the same
seeded inputs: `iou_3d`, the box coder's encode (and decode's inverse of
it), the sigmoid focal and Gaussian focal losses with their gradients, the
flax-style BatchNorms over the last axis and over NCHW maps in training at
momentum 0.9 and 0.99, the Hungarian assignment against the JAX package's
host method, and `transfusion_targets_and_loss` on the same predictions
(its heatmap targets too, with the one difference at the map's left edge).

Tolerances (f32): IoU atol 1e-6; the coder 1e-6 relative; losses rtol 1e-6
and their gradients atol 1e-6 * max|ref|; norms atol 1e-5 (outputs, input
gradients) and 1e-6 (batch statistics); the assignment exact; the targets
and loss: matches exact, logs rtol 1e-5 (tf_matched exact), the gradient of
the total with respect to every prediction atol 1e-5 * max|ref| + 1e-7,
heatmap targets atol 1e-6."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from df3d.core import iou as jiou
from df3d.core import target_utils as jtu
from df3d.core.box_coders import TransFusionBBoxCoder as JCoder
from df3d.models import losses as jlosses
from df3d.models.heads import transfusion_head as jhead
from df3d_torch.core import iou as tiou
from df3d_torch.core.box_coders import TransFusionBBoxCoder
from df3d_torch.models import losses as tlosses
from df3d_torch.models.heads import transfusion_head as thead
from df3d_torch.models.layers import FlaxBatchNorm, FlaxBatchNorm2d
from df3d_torch.ops.assign import hungarian_match
from torch_port_helpers import one_torch_thread  # noqa: F401

# tests/test_torch_transfusion.py's tiny head (8 x 8 BEV map over +-16 m)
HEAD = dict(num_classes=3, num_proposals=16, hidden_channel=32, num_heads=4,
            ffn_channel=64, small_classes=(2,), bev_size=(8, 8),
            out_size_factor=8, voxel_size=(0.5, 0.5), pc_range=(-16.0, -16.0))


def _box(x, y, z, dx, dy, dz, yaw):
    return [x, y, z, dx, dy, dz, yaw]


# (a boxes, b boxes), gravity-centre (x, y, z, dx, dy, dz, yaw)
IOU_CASES = {
    "rotated": ([_box(0, 0, 0, 4, 2, 1.5, 0.3), _box(1, 0.5, 0.2, 3, 3, 2, 0.0),
                 _box(-20, 5, 1, 2, 1, 1, 2.0)],
                [_box(0.5, 0, 0.1, 4, 2, 1.5, -0.4), _box(1, 1, 0, 2, 2, 2, 1.2),
                 _box(-20.3, 5.2, 0.8, 2.5, 1, 1.2, 2.4)]),
    "disjoint": ([_box(0, 0, 0, 2, 2, 2, 0.0), _box(10, 10, 0, 1, 3, 1, 0.7)],
                 [_box(5, 0, 0, 2, 2, 2, 0.4), _box(-10, 10, 0, 1, 3, 1, 0.7)]),
    "coincident": ([_box(3, -2, 0.5, 4, 2, 1.5, 0.3),
                    _box(0, 0, 0, 1, 1, 1, 0.0)],
                   [_box(3, -2, 0.5, 4, 2, 1.5, 0.3),
                    _box(0, 0, 0, 1, 1, 1, 0.0)]),
    "z_disjoint": ([_box(0, 0, 0, 4, 2, 1.0, 0.3), _box(0, 0, 5, 4, 2, 2, 0.3)],
                   [_box(0, 0, 1.0, 4, 2, 1.0, 0.3),
                    _box(0, 0, 2.5, 4, 2, 1.0, 0.3)]),
}


@pytest.mark.parametrize("case", list(IOU_CASES))
def test_iou_3d(case):
    a, b = (np.asarray(x, np.float32) for x in IOU_CASES[case])
    want = np.asarray(jax.jit(jiou.iou_3d)(jnp.asarray(a), jnp.asarray(b)))
    got = tiou.iou_3d(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    if case == "disjoint":
        assert not want.any()
    elif case == "coincident":
        np.testing.assert_allclose(np.diag(got), 1.0, atol=1e-5)
    elif case == "z_disjoint":  # touching in z, then apart: no volume
        assert not want.any()
        assert tiou.iou_bev(torch.from_numpy(a), torch.from_numpy(b)).min() > 0.9
    else:
        assert (want > 0.05).sum() >= 3
    # leading batch dims broadcast
    got_b = tiou.iou_3d(torch.from_numpy(a)[None].expand(2, -1, -1),
                        torch.from_numpy(b)[None].expand(2, -1, -1))
    np.testing.assert_array_equal(got_b[1].numpy(), got)


CODER = dict(pc_range=(-54.0, -54.0), voxel_size=(0.075, 0.075),
             out_size_factor=8)


def _coder_boxes():
    rng = np.random.RandomState(0)
    return np.concatenate([rng.uniform(-50, 50, (2, 30, 2)),
                           rng.randn(2, 30, 1),
                           rng.uniform(0.3, 5, (2, 30, 3)),
                           rng.uniform(-np.pi, np.pi, (2, 30, 1)),
                           rng.randn(2, 30, 2)], -1).astype(np.float32)


def test_encode():
    boxes = _coder_boxes()
    want = np.asarray(JCoder(**CODER, code_size=10).encode(
        jnp.asarray(boxes)))
    got = TransFusionBBoxCoder(**CODER).encode(torch.from_numpy(boxes)).numpy()
    assert got.shape == (2, 30, 10) == want.shape
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_encode_decode_inverse():
    """decode(encode(boxes)) gives the bottom-centre boxes back."""
    boxes = torch.from_numpy(_coder_boxes())
    coder = TransFusionBBoxCoder(**CODER)
    c = coder.encode(boxes)
    back = coder.decode(c[..., :2], c[..., 2], c[..., 3:6], c[..., 6],
                        c[..., 7], c[..., 8:10])
    np.testing.assert_allclose(back.numpy(), boxes.numpy(), rtol=0,
                               atol=1e-4)


def _loss_case(name):
    rng = np.random.RandomState(2)
    pred_logits = (rng.randn(2, 16, 3) * 2).astype(np.float32)
    onehot = np.eye(3, dtype=np.float32)[rng.randint(0, 3, (2, 16))]
    onehot *= (rng.rand(2, 16, 1) > 0.5)
    hm = np.clip(rng.rand(2, 3, 8, 8), 1e-4, 1 - 1e-4).astype(np.float32)
    target = (rng.rand(2, 3, 8, 8) ** 3).astype(np.float32)
    target[0, 1, 2, 3] = target[1, 0, 5, 5] = 1.0     # peaks
    weights = (rng.rand(2, 16) > 0.2).astype(np.float32)
    class_weights = rng.rand(2, 16, 3).astype(np.float32)
    if name == "sigmoid_focal":
        return (pred_logits, lambda m, x: m.sigmoid_focal_loss(
            x, onehot, weights))
    if name == "sigmoid_focal_class_weights":  # weights of the loss's rank
        return (pred_logits, lambda m, x: m.sigmoid_focal_loss(
            x, onehot, class_weights))
    return hm, lambda m, x: m.gaussian_focal_loss(x, target)


@pytest.mark.parametrize("name", ["sigmoid_focal",
                                  "sigmoid_focal_class_weights",
                                  "gaussian_focal"])
def test_losses(name):
    """Per-element values and the gradient of a weighted sum."""
    x, fn = _loss_case(name)
    wsum = np.random.RandomState(3).rand(*x.shape).astype(np.float32)

    def jtotal(xx):
        return (fn(jlosses, xx) * wsum).sum()

    want = np.asarray(fn(jlosses, jnp.asarray(x)))
    _, want_g = jax.jit(jax.value_and_grad(jtotal))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    tm = _TorchArgs(tlosses)
    got = fn(tm, xt)
    (got * torch.from_numpy(wsum)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-6,
                               atol=1e-7)
    want_g = np.asarray(want_g)
    np.testing.assert_allclose(xt.grad.numpy(), want_g, rtol=0,
                               atol=1e-6 * np.abs(want_g).max())


class _TorchArgs:
    """The port's loss module with numpy arguments turned into tensors."""

    def __init__(self, mod):
        self.mod = mod

    def __getattr__(self, name):
        f = getattr(self.mod, name)
        return lambda *a: f(*(torch.from_numpy(x) if isinstance(x, np.ndarray)
                              else x for x in a))


@pytest.mark.parametrize("momentum", [0.9, 0.99])
@pytest.mark.parametrize("kind", ["last_axis", "nchw"])
def test_flax_batchnorm_training(kind, momentum):
    """flax nn.BatchNorm(momentum): batch mean and fast biased variance,
    running statistics momentum * old + (1 - momentum) * batch; then eval
    on the running statistics. Last axis: (B, P, C) as the position
    embeddings and FFN branches; NCHW against flax's NHWC."""
    rng = np.random.RandomState(5)
    shape = (2, 17, 8) if kind == "last_axis" else (2, 5, 6, 8)
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    dy = rng.randn(*shape).astype(np.float32)
    params = {"scale": (1 + 0.1 * rng.randn(8)).astype(np.float32),
              "bias": (0.1 * rng.randn(8)).astype(np.float32)}
    stats = {"mean": (0.1 * rng.randn(8)).astype(np.float32),
             "var": (0.5 + rng.rand(8)).astype(np.float32)}
    jm = fnn.BatchNorm(use_running_average=False, momentum=momentum,
                       epsilon=1e-5)

    def f(xx):
        y, upd = jm.apply({"params": params, "batch_stats": stats}, xx,
                          mutable=["batch_stats"])
        return (y * dy).sum(), (y, upd["batch_stats"])

    (_, (want_y, upd)), want_gx = jax.jit(jax.value_and_grad(
        f, has_aux=True))(jnp.asarray(x))
    cls = FlaxBatchNorm if kind == "last_axis" else FlaxBatchNorm2d
    tmod = cls(8, 1e-5, momentum)
    tmod.load_state_dict({
        "weight": torch.from_numpy(params["scale"]),
        "bias": torch.from_numpy(params["bias"]),
        "running_mean": torch.from_numpy(stats["mean"]),
        "running_var": torch.from_numpy(stats["var"])})
    tmod.train()

    def to_t(a):  # flax layout -> the module's
        t = torch.from_numpy(a)
        return t if kind == "last_axis" else t.permute(0, 3, 1, 2)

    def to_f(t):
        return (t if kind == "last_axis" else t.permute(0, 2, 3, 1)).numpy()

    xt = to_t(x).requires_grad_(True)
    y = tmod(xt)
    (y * to_t(dy)).sum().backward()
    np.testing.assert_allclose(to_f(y.detach()), np.asarray(want_y),
                               atol=1e-5)
    np.testing.assert_allclose(to_f(xt.grad), np.asarray(want_gx), atol=1e-5)
    np.testing.assert_allclose(tmod.running_mean.numpy(),
                               np.asarray(upd["mean"]), atol=1e-6)
    np.testing.assert_allclose(tmod.running_var.numpy(),
                               np.asarray(upd["var"]), atol=1e-6)
    with torch.no_grad():
        tmod.eval()
        want = fnn.BatchNorm(use_running_average=True, epsilon=1e-5).apply(
            {"params": params, "batch_stats": upd}, x)
        np.testing.assert_allclose(to_f(tmod(xt.detach())), np.asarray(want),
                                   atol=1e-5)


def _assign_case(name):
    rng = np.random.RandomState(7)
    if name == "random":
        cost = rng.randn(3, 8, 5).astype(np.float32)
        valid = rng.rand(3, 5) > 0.3
        valid[0] = True
    elif name == "tied_integers":
        cost = rng.randint(0, 3, (3, 8, 6)).astype(np.float32)
        valid = np.ones((3, 6), bool)
        valid[1, ::2] = False
    elif name == "no_valid_column":
        cost = rng.randn(2, 8, 4).astype(np.float32)
        valid = np.zeros((2, 4), bool)
    else:  # more valid columns than proposals
        cost = rng.rand(2, 3, 7).astype(np.float32)
        valid = np.ones((2, 7), bool)
        valid[1, 2] = False
    return cost, valid


@pytest.mark.parametrize("name", ["random", "tied_integers", "no_valid_column",
                                  "more_columns_than_rows"])
def test_hungarian_match(name):
    """Against the JAX package's host method, sample by sample: the same
    matched column of every row, -1 where none."""
    cost, valid = _assign_case(name)
    want = np.stack([jhead._hungarian_host(c, v)
                     for c, v in zip(cost, valid)])
    got = hungarian_match(torch.from_numpy(cost), torch.from_numpy(valid))
    assert got.dtype == torch.int64 and got.shape == cost.shape[:2]
    np.testing.assert_array_equal(got.numpy(), want)
    matched = got.numpy() >= 0
    assert (matched.sum(1) == np.minimum(valid.sum(1), cost.shape[1])).all()
    for s in range(len(cost)):  # each valid column used at most once
        cols = got[s][got[s] >= 0].numpy()
        assert len(set(cols)) == len(cols) and valid[s, cols].all()


def _targets_inputs(left_edge=False, seed=11):
    """Predictions of the tiny head for batch 2 and P 16, and 6 box slots a
    sample (4 valid, one of them of zero width). Some queries sit on boxes
    (IoU > 0), the others anywhere on the map. Boxes stay at least 3
    pixels right of the map's left edge, unless `left_edge` puts one at
    x = 0.4 pixels."""
    rng = np.random.RandomState(seed)
    b, p, m, ncls = 2, 16, 6, 3
    lo, cell = -16.0, 4.0  # pc_range and metres per BEV pixel
    boxes = np.zeros((b, m, 9), np.float32)
    boxes[..., 0] = rng.uniform(lo + 3.5 * cell, 14.0, (b, m))
    boxes[..., 1] = rng.uniform(-14.0, 14.0, (b, m))
    boxes[..., 2] = rng.uniform(-1, 1, (b, m))
    boxes[..., 3:6] = rng.uniform(1.0, 6.0, (b, m, 3))
    boxes[..., 6] = rng.uniform(-np.pi, np.pi, (b, m))
    boxes[..., 7:9] = rng.randn(b, m, 2)
    boxes[1, 2, 4] = 0.0                        # zero width: no heatmap
    if left_edge:
        boxes[0, 0, :2] = (lo + 0.4 * cell, 2.0)
    classes = rng.randint(0, ncls, (b, m)).astype(np.int32)
    valid = np.zeros((b, m), bool)
    valid[:, :4] = True
    center = rng.uniform(0, 8, (b, p, 2)).astype(np.float32)
    center[:, :4] = (boxes[:, :4, :2] - lo) / cell + rng.uniform(
        -0.2, 0.2, (b, 4, 2))
    dim = np.log(rng.uniform(1.0, 5.0, (b, p, 3)))
    preds = {"center": center,
             "height": rng.randn(b, p),
             "dim": dim,
             "rot": rng.randn(b, p, 2),
             "vel": rng.randn(b, p, 2),
             "cls": rng.randn(b, p, ncls) * 2,
             "dense_heatmap": rng.randn(b, 8, 8, ncls) * 2}
    preds = {k: np.asarray(v, np.float32) for k, v in preds.items()}
    return preds, boxes, classes, valid


def _jax_heatmap_targets(cfg, boxes, classes, valid):
    """The JAX loss's dense heatmap targets (its `render`, vmapped)."""
    def render(gt_s, gt_cls_s, gt_valid_s):
        dx_pix = gt_s[:, 3] / cfg.voxel_size[0] / cfg.out_size_factor
        dy_pix = gt_s[:, 4] / cfg.voxel_size[1] / cfg.out_size_factor
        radius = jnp.maximum(cfg.min_radius, jnp.floor(jtu.gaussian_radius(
            dy_pix, dx_pix, cfg.gaussian_overlap))).astype(jnp.float32)
        x_pix = (gt_s[:, 0] - cfg.pc_range[0]) / cfg.voxel_size[0] / \
            cfg.out_size_factor
        y_pix = (gt_s[:, 1] - cfg.pc_range[1]) / cfg.voxel_size[1] / \
            cfg.out_size_factor
        centers = jnp.stack([x_pix, y_pix], -1)
        return jax.vmap(lambda ci: jtu.draw_gaussians(
            jnp.zeros(cfg.bev_size), centers, radius,
            gt_valid_s & (gt_cls_s == ci) & (dx_pix > 0) & (dy_pix > 0)))(
            jnp.arange(cfg.num_classes))

    return np.asarray(jax.jit(jax.vmap(render))(
        *map(jnp.asarray, (boxes, classes, valid))))


@pytest.mark.parametrize("left_edge", [False, True],
                         ids=["off_the_edge", "left_edge"])
def test_heatmap_targets(left_edge):
    """The port's heatmap targets equal the JAX loss's, but for a box at
    the map's left edge: the JAX package sends its window cells left of the
    map to the last row's far end (ROADMAP section 3), the port drops
    them."""
    preds, boxes, classes, valid = _targets_inputs(left_edge)
    want = _jax_heatmap_targets(jhead.TransFusionHeadCfg(**HEAD), boxes,
                                classes, valid)
    got = thead.gaussian_heatmap_targets(
        thead.TransFusionHeadCfg(**HEAD),
        *map(torch.from_numpy, (boxes, classes, valid))).numpy()
    leaked = np.zeros_like(want, bool)
    if left_edge:  # x = -2, -1 of the radius-2 window, at the far end
        leaked[0, classes[0, 0], -1, -2:] = True
        assert (want[leaked] > got[leaked]).any()
    np.testing.assert_allclose(got[~leaked], want[~leaked], atol=1e-6)
    assert (got[leaked] <= want[leaked]).all()
    # 8 valid boxes, one of zero width, two may share a pixel
    assert (got == 1).sum() == (want == 1).sum() >= 6


def test_targets_and_loss():
    """`transfusion_targets_and_loss` on the same predictions and boxes as
    the JAX function: the Hungarian matches (recorded from both) equal, the
    logs, and the gradient of the total with respect to every prediction."""
    preds, boxes, classes, valid = _targets_inputs()
    jcfg, tcfg = (jhead.TransFusionHeadCfg(**HEAD),
                  thead.TransFusionHeadCfg(**HEAD))
    jmatches, tmatches = [], []
    host = jhead._hungarian_host

    def jrecording(cost, valid_cols):
        out = host(cost, valid_cols)
        jmatches.append(out)
        return out

    def jloss(p):
        return jhead.transfusion_targets_and_loss(
            jcfg, p, *map(jnp.asarray, (boxes, classes, valid)))

    mp = pytest.MonkeyPatch()
    mp.setattr(jhead, "_hungarian_host", jrecording)
    mp.setattr(jhead, "ASSIGN_METHOD", "host")
    try:
        (_, jlogs), jgrads = jax.jit(jax.value_and_grad(
            jloss, has_aux=True))({k: jnp.asarray(v)
                                   for k, v in preds.items()})
    finally:
        mp.undo()

    match = thead.hungarian_match

    def trecording(cost, valid_cols):
        out = match(cost, valid_cols)
        tmatches.append(out)
        return out

    tp = {k: torch.from_numpy(v).requires_grad_(True)
          for k, v in preds.items()}
    with pytest.MonkeyPatch.context() as m:
        m.setattr(thead, "hungarian_match", trecording)
        total, logs = thead.transfusion_targets_and_loss(
            tcfg, tp, *map(torch.from_numpy, (boxes, classes, valid)))
    total.backward()

    np.testing.assert_array_equal(tmatches[0].numpy(),
                                  np.stack(jmatches[:2]))
    assert int(logs["tf_matched"]) == int(jlogs["tf_matched"]) == 8
    assert set(logs) == set(jlogs)
    for k, v in jlogs.items():
        np.testing.assert_allclose(float(logs[k].detach()), float(v),
                                   rtol=1e-5,
                                   err_msg=k)
    for k, g in jgrads.items():
        g = np.asarray(g)
        np.testing.assert_allclose(tp[k].grad.numpy(), g, rtol=0,
                                   atol=1e-5 * np.abs(g).max() + 1e-7,
                                   err_msg=k)
        assert np.abs(g).max() > 0, k
