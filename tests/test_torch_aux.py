"""The fused detectors' aux objectives, df3d_torch's
`models.fusion.aux_losses`, `aux_heads` and `train.trainer.fused_aux_terms`
against the JAX package's (`aux_losses`, `aux_heads`, `trainer.
_fused_aux_terms`) under one `jax.jit` per case: the FG masks rendered
from projected gt boxes, the focal segmentation loss, the consistency
loss, their logs and the cotangents (`jax.vjp`) with respect to the seg
logits, the voxel features and the image features, and `AuxSegHead` with
flax weights carried across.

Cases: six cameras of `utils.synth.camera_rig` at 32x48 folded over two
samples (every box lies behind most cameras, depth <= 0.1 at its nearest
corner, and one straddles the image plane of the front camera; the second
sample holds no valid box) and KITTI's one camera with an all-zero
consistency mask (the normalizer is 1).

Tolerances: the masks equal (a rectangle edge within 1e-4 of a whole pixel
is printed); the losses rtol 1e-5; each cotangent 1e-5 * max|ref| + 1e-7.
The box corners are rotated with XLA's sin and cos (`core.boxes`), which
decide edges that land on a pixel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d.models.fusion import aux_heads as jaux
from df3d.models.fusion import aux_losses as jlosses
from df3d.train.trainer import _fused_aux_terms as jfused_aux_terms
from df3d_torch.models.detectors.fused import CenterPoint3DDF
from df3d_torch.models.fusion import aux_heads, aux_losses
from df3d_torch.train.trainer import fused_aux_terms
from df3d_torch.utils.synth import camera_rig, kitti_camera
from df3d_torch.weights import state_dict_from_flax
from torch_port_helpers import seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

IMAGE = (32, 48)
FEAT = (8, 12)
CHANNELS = 16
# gravity-centre boxes around the rig; the third straddles the front
# camera's image plane (its near corners behind the lens)
BOXES = np.array([[6.0, 1.0, -0.5, 4.2, 1.9, 1.6, 0.4],
                  [-5.0, -4.0, 0.0, 4.5, 2.0, 1.7, -1.2],
                  [0.9, 0.2, -0.2, 2.0, 1.0, 1.5, 0.3],
                  [2.0, 9.0, 0.3, 1.0, 0.8, 1.8, 2.5],
                  [12.0, -3.0, 0.0, 4.0, 1.8, 1.5, 3.0]], np.float32)


def _case(kind):
    """(batch, seg logits, voxel feats, image feats, mask) numpy."""
    rng = np.random.RandomState(0 if kind == "multicam" else 1)
    b = 2
    if kind == "multicam":
        nc = 6
        proj = np.broadcast_to(camera_rig(nc, IMAGE), (b, nc, 3, 4)).copy()
        valid = np.array([[1, 1, 1, 1, 0], [0, 0, 0, 0, 0]], bool)
    else:
        nc = 1
        proj = np.broadcast_to(kitti_camera(IMAGE[1] / 1280.0),
                               (b, 3, 4)).copy()
        valid = np.array([[1, 1, 1, 1, 1], [1, 0, 1, 0, 0]], bool)
    boxes = np.stack([BOXES, BOXES[::-1] * np.float32([1, -1, 1, 1, 1, 1,
                                                        -1])])
    if kind == "kitti":  # in front of the camera
        boxes[..., 0] = np.abs(boxes[..., 0]) + 4.0
    batch = {"gt_boxes": boxes, "gt_valid": valid, "proj": proj}
    seg = rng.randn(b * nc, *FEAT, 1).astype(np.float32) * 2.0
    n, c = 40, 8
    vf = rng.randn(b, n, c).astype(np.float32)
    ifeat = rng.randn(b, n, c).astype(np.float32)
    mask = (rng.rand(b, n) < 0.6) if kind == "multicam" else np.zeros(
        (b, n), bool)
    return batch, seg, vf, ifeat, mask


def _jax_side(batch, seg, vf, ifeat, mask, head_vars, feat):
    """One jitted program: `_fused_aux_terms` (total, logs) and its vjp
    with respect to (seg, vf, ifeat) at a unit cotangent, the FG masks of
    the folded boxes, a 2D-box mask, and the aux head on `feat`."""

    @jax.jit
    def run(batch, seg, vf, ifeat, mask, head_vars, feat):
        def total(seg, vf, ifeat):
            updates = {"intermediates": {
                "aux_seg_logits": (seg,),
                "aux_consistency": ((vf, ifeat, mask),)}}
            return jfused_aux_terms(updates, batch, IMAGE, 1.0, 0.1)

        t, logs = total(seg, vf, ifeat)
        _, vjp = jax.vjp(lambda *a: total(*a)[0], seg, vf, ifeat)
        cot = vjp(jnp.float32(1.0))
        proj, gt, gv = batch["proj"], batch["gt_boxes"], batch["gt_valid"]
        if proj.ndim == 4:
            nc = proj.shape[1]
            proj = proj.reshape(-1, 3, 4)
            gt, gv = jnp.repeat(gt, nc, 0), jnp.repeat(gv, nc, 0)
        fg = jaux.render_fg_from_gt3d(gt, gv, proj, FEAT, IMAGE)
        boxes2d = jnp.array([[1.5, 2.0, 7.0, 5.5], [8.2, -1.0, 20.0, 3.0],
                             [0.0, 0.0, 3.0, 3.0]])
        fg2d = jlosses.render_fg_mask_from_boxes2d(
            boxes2d, jnp.array([True, True, False]), FEAT)
        logits = jaux.AuxSegHead().apply(head_vars, feat)
        return t, logs, cot, fg, fg2d, logits

    out = run(batch, seg, vf, ifeat, mask, head_vars, feat)
    return jax.tree_util.tree_map(np.asarray, out)


def _edges(gt, gv, proj):
    """The rectangle edges (pixels at the feature resolution) of the
    valid boxes in front of the camera, on the port's side."""
    b, m = gt.shape[:2]
    from df3d_torch.core.boxes import boxes_to_corners_3d
    from df3d_torch.core.calib import project_to_image

    corners = boxes_to_corners_3d(gt[..., :7])
    uv, depth = project_to_image(proj, corners.reshape(b, m * 8, 3))
    uv, depth = uv.reshape(b, m, 8, 2), depth.reshape(b, m, 8)
    ok = gv & (depth.amin(-1) > 0.1)
    e = torch.stack([uv[..., 0].amin(-1) / IMAGE[1] * FEAT[1],
                     uv[..., 0].amax(-1) / IMAGE[1] * FEAT[1],
                     uv[..., 1].amin(-1) / IMAGE[0] * FEAT[0],
                     uv[..., 1].amax(-1) / IMAGE[0] * FEAT[0]], -1)
    return e[ok], ok, depth.amin(-1)


@pytest.fixture(scope="module", params=["multicam", "kitti"])
def case(request):
    kind = request.param
    batch, seg, vf, ifeat, mask = _case(kind)
    rng = np.random.RandomState(5)
    feat = rng.randn(3, *FEAT, CHANNELS).astype(np.float32)
    head_vars = seeded_variables(jax.eval_shape(
        lambda f: jaux.AuxSegHead().init(jax.random.PRNGKey(0), f), feat),
        np.random.RandomState(6))
    want = _jax_side(batch, seg, vf, ifeat, mask, head_vars, feat)

    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    segt, vft, ift = (torch.from_numpy(a).requires_grad_(True)
                      for a in (seg, vf, ifeat))
    aux = {"seg_logits": segt,
           "consistency": [(vft, ift, torch.from_numpy(mask))]}
    total, logs = fused_aux_terms(aux, t, IMAGE, 1.0, 0.1)
    cot = torch.autograd.grad(total, (segt, vft, ift))
    proj, gt, gv = t["proj"], t["gt_boxes"], t["gt_valid"]
    if proj.dim() == 4:
        nc = proj.shape[1]
        proj = proj.reshape(-1, 3, 4)
        gt, gv = gt.repeat_interleave(nc, 0), gv.repeat_interleave(nc, 0)
    fg = aux_heads.render_fg_from_gt3d(gt, gv, proj, FEAT, IMAGE)
    fg2d = aux_losses.render_fg_mask_from_boxes2d(
        torch.tensor([[1.5, 2.0, 7.0, 5.5], [8.2, -1.0, 20.0, 3.0],
                      [0.0, 0.0, 3.0, 3.0]]),
        torch.tensor([True, True, False]), FEAT)
    head = aux_heads.AuxSegHead(CHANNELS)
    head.load_state_dict(state_dict_from_flax(head, head_vars))
    with torch.no_grad():
        logits = head(torch.from_numpy(feat))
    got = dict(total=total.detach(), logs={k: v.detach()
                                           for k, v in logs.items()},
               cot=cot, fg=fg, fg2d=fg2d, logits=logits,
               edges=_edges(gt, gv, proj))
    return kind, got, want


def test_fg_masks_equal(case):
    kind, got, want = case
    edges, ok, near = got["edges"]
    close = edges[(edges - edges.round()).abs() < 1e-4]
    if len(close):
        print(f"{kind}: rectangle edges within 1e-4 of a pixel: "
              f"{close.tolist()}")
    np.testing.assert_array_equal(got["fg"].numpy(), want[3])
    np.testing.assert_array_equal(got["fg2d"].numpy(), want[4])
    assert want[3].any() and not want[3].all()
    if kind == "multicam":
        # boxes behind cameras and a sample with no valid box
        assert (near <= 0.1).any() and ok.any()
        assert not want[3][6:].any()


def test_losses_and_logs(case):
    kind, got, want = case
    t, logs = want[0], want[1]
    np.testing.assert_allclose(got["total"].item(), t, rtol=1e-5)
    assert set(got["logs"]) == set(logs) == {
        "aux_seg_loss", "aux_consistency_loss", "aux_loss"}
    for k, v in logs.items():
        np.testing.assert_allclose(got["logs"][k].item(), v, rtol=1e-5,
                                   err_msg=k)
    if kind == "kitti":  # an all-zero mask: the normalizer is 1
        assert logs["aux_consistency_loss"] == 0.0


def test_cotangents(case):
    kind, got, want = case
    for name, g, r in zip(("seg", "voxel", "image"), got["cot"], want[2]):
        np.testing.assert_allclose(g.numpy(), r, rtol=0,
                                   atol=1e-5 * np.abs(r).max() + 1e-7,
                                   err_msg=name)
    assert np.abs(want[2][0]).max() > 0
    if kind == "multicam":
        assert np.abs(want[2][1]).max() > 0


def test_aux_seg_head(case):
    _, got, want = case
    r = want[5]
    np.testing.assert_allclose(got["logits"].numpy(), r, rtol=0,
                               atol=1e-5 * np.abs(r).max() + 1e-6)


def test_aux_head_weights_are_strict():
    """A tree with `aux_seg` into a model without the head raises, and a
    model with the head takes no tree without it."""
    import dataclasses

    import torch_parallel_ranks as R
    from df3d_torch.entry import mesh_cfg

    fcfg = R._fused_centerpoint_config()
    with_head = CenterPoint3DDF(mesh_cfg(), dataclasses.replace(
        fcfg, with_aux_seg=True))
    plain = CenterPoint3DDF(mesh_cfg(), fcfg)
    head_tree = {"aux_seg": {
        "Conv_0": {"kernel": np.zeros((3, 3, 32, 32), np.float32),
                   "bias": np.zeros(32, np.float32)},
        "Conv_1": {"kernel": np.zeros((1, 1, 32, 1), np.float32),
                   "bias": np.zeros(1, np.float32)}}}
    with pytest.raises(KeyError, match="aux_seg"):
        state_dict_from_flax(plain, {"params": head_tree})
    others = tuple(k for k in with_head.state_dict()
                   if not k.startswith("aux_seg."))
    with pytest.raises(KeyError, match="aux_seg"):
        state_dict_from_flax(with_head, {"params": {}}, keep=others)
    got = state_dict_from_flax(with_head, {"params": head_tree}, keep=others)
    assert not got["aux_seg.conv.weight"].any()
    assert got["aux_seg.out.weight"].shape == (1, 32, 1, 1)


def test_aux_without_head_raises():
    """aux on a model built without the head raises, as the JAX package's
    step raises when no aux logits were sown."""
    import torch_parallel_ranks as R
    from df3d_torch import entry
    from df3d_torch.train.trainer import (
        create_train_state, make_fused_train_step,
    )

    cfg, fcfg = entry.mesh_cfg(), R._fused_centerpoint_config()
    state = create_train_state(CenterPoint3DDF(cfg, fcfg),
                               entry.adam_onecycle(1e-3, 100))
    step = make_fused_train_step(cfg, aux=True, image_hw=fcfg.image_shape)
    batch = R.tensors(R._nusc_batch(5, fcfg))
    with pytest.raises(ValueError, match="with_aux_seg"):
        step(state, batch)
    with pytest.raises(ValueError, match="image_hw"):
        make_fused_train_step(cfg, aux=True)
    with pytest.raises(ValueError, match="with_aux_seg"):
        entry.build_centerpoint3ddf_trainer(cfg, fcfg, "cpu", aux=True,
                                            with_aux_seg=False)
