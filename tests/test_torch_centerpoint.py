"""df3d_torch's CenterPoint modules against df3d's, one module at a time,
with the same seeded inputs and flax weights carried across by
df3d_torch.weights. Float outputs match to atol = rtol = 1e-5 (f32, other
summation order) unless a test says otherwise; masks, labels and NMS keep
sets match exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d.core import iou as jiou
from df3d.core import nms as jnms
from df3d.models import layers as jlayers
from df3d.models.heads import center_head as jhead
from df3d.models.necks import BEVBackbone as JBEVBackbone
from df3d.ops import dense3d as jdense
from df3d.ops import sparse as jsp
from df3d_torch.core import iou as tiou
from df3d_torch.core import nms as tnms
from df3d_torch.models import layers as tlayers
from df3d_torch.models.heads import center_head as thead
from df3d_torch.models.necks import BEVBackbone
from df3d_torch.ops import dense3d as tdense
from df3d_torch.ops import sparse as tsp
from torch_port_helpers import load_flax, seeded_variables, sparse_inputs
from torch_port_helpers import one_torch_thread  # noqa: F401

TOL = dict(atol=1e-5, rtol=1e-5)
KEY = jax.random.PRNGKey(0)


def _vars(module, *args):
    shapes = jax.eval_shape(lambda: module.init(KEY, *args))
    return seeded_variables(shapes, np.random.RandomState(3))


def test_masked_batchnorm():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 20, 6).astype(np.float32)
    mask = rng.rand(2, 20) > 0.3
    jm = jlayers.MaskedBatchNorm()
    v = _vars(jm, jnp.asarray(x), jnp.asarray(mask), False)
    want = jax.jit(lambda v, x, m: jm.apply(v, x, m, False))(
        v, jnp.asarray(x), jnp.asarray(mask))
    tm = load_flax(tlayers.MaskedBatchNorm(6), v)
    got = tm(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_sparse_basic_block():
    rng = np.random.RandomState(1)
    feats, coords = sparse_inputs(rng, batch=2, n=60, cin=8, pad_to=80)
    shape = (8, 12, 12)
    jst = jsp.SparseTensor(jnp.asarray(feats), jnp.asarray(coords), shape,
                           rows_sorted=True)
    tst = tsp.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords),
                           shape)
    jm = jlayers.SparseBasicBlock(8)
    jplan = jax.jit(jsp.build_subm_plan, static_argnums=1)(jst, 3)
    v = _vars(jm, jst, jplan, False)
    want = jax.jit(lambda v, st, pl: jm.apply(v, st, pl, False).features)(
        v, jst, jplan)
    tm = load_flax(tlayers.SparseBasicBlock(8), v)
    with torch.no_grad():
        got = tm(tst, tsp.build_subm_plan(tst, 3)).features
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


DENSE_CASES = [
    ("subm_k3", (3, 3, 3), (1, 1, 1), (1, 1, 1), True),
    ("down4_k3_s2_p011", (3, 3, 3), (2, 2, 2), (0, 1, 1), False),
    ("extra_k311_s211_p0", (3, 1, 1), (2, 1, 1), (0, 0, 0), False),
]


@pytest.mark.parametrize("case", DENSE_CASES, ids=[c[0] for c in DENSE_CASES])
def test_dense_conv(case):
    _, ksize, stride, padding, subm = case
    rng = np.random.RandomState(2)
    mask = rng.rand(2, 7, 10, 10) > 0.7
    feats = (rng.randn(2, 7, 10, 10, 6) * mask[..., None]).astype(np.float32)
    k = int(np.prod(ksize))
    w = (rng.randn(k, 6, 5) * 0.2).astype(np.float32)
    want = jax.jit(lambda f, m, w: jdense.dense_conv(
        jdense.DenseTensor(f, m), w, ksize, stride, padding, subm))(
            jnp.asarray(feats), jnp.asarray(mask), jnp.asarray(w))
    got = tdense.dense_conv(
        tdense.DenseTensor(torch.from_numpy(feats), torch.from_numpy(mask)),
        torch.from_numpy(w), ksize, stride, padding, subm)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.features.numpy(),
                               np.asarray(want.features), **TOL)


def test_densify_and_bev_from_dense():
    rng = np.random.RandomState(4)
    feats, coords = sparse_inputs(rng, batch=2, shape=(4, 6, 6), n=30, cin=3,
                                  pad_to=40)
    jd = jdense.densify(jsp.SparseTensor(jnp.asarray(feats),
                                         jnp.asarray(coords), (4, 6, 6)))
    td = tdense.densify(tsp.SparseTensor(torch.from_numpy(feats),
                                         torch.from_numpy(coords), (4, 6, 6)))
    np.testing.assert_array_equal(td.mask.numpy(), np.asarray(jd.mask))
    np.testing.assert_array_equal(td.features.numpy(), np.asarray(jd.features))
    np.testing.assert_array_equal(tdense.bev_from_dense(td).numpy(),
                                  np.asarray(jdense.bev_from_dense(jd)))


def test_bev_backbone_even_map():
    """Even input + stride-2 conv: flax "SAME" pads (0, 1), not (1, 1)."""
    rng = np.random.RandomState(5)
    x = rng.randn(1, 12, 12, 6).astype(np.float32)
    cfg = dict(layer_nums=(1, 1), layer_strides=(1, 2), num_filters=(8, 16),
               upsample_strides=(1, 2), num_upsample_filters=(8, 8))
    jm = JBEVBackbone(**cfg)
    v = _vars(jm, jnp.asarray(x), False)
    want = jax.jit(lambda v, x: jm.apply(v, x, False))(v, jnp.asarray(x))
    tm = load_flax(BEVBackbone(6, **cfg), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    assert got.shape == (1, 12, 12, 16)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_center_head():
    rng = np.random.RandomState(6)
    x = rng.randn(2, 8, 8, 16).astype(np.float32)
    jm = jhead.CenterHead((1, 2))
    v = _vars(jm, jnp.asarray(x), False)
    want = jax.jit(lambda v, x: jm.apply(v, x, False))(v, jnp.asarray(x))
    tm = load_flax(thead.CenterHead(16, (1, 2)), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
    for gt, wt in zip(got, want):
        assert set(gt) == set(wt)
        for name in wt:
            np.testing.assert_allclose(gt[name].numpy(), np.asarray(wt[name]),
                                       atol=1e-4, rtol=1e-4, err_msg=name)


def _boxes(rng, n):
    """Random 7-dof boxes with clusters, exact duplicates and shared edges,
    so NMS has overlaps to decide."""
    ctr = rng.uniform(-30, 30, (n // 4, 2))
    xy = ctr[rng.randint(0, len(ctr), n)] + rng.randn(n, 2) * 0.8
    b = np.concatenate([xy, rng.uniform(-1, 1, (n, 1)),
                        rng.uniform(1, 5, (n, 3)),
                        rng.uniform(-np.pi, np.pi, (n, 1))], -1)
    b[1] = b[0]  # coincident
    b[3] = b[2]
    b[3, 0] += b[2, 3]  # edge to edge at heading h
    return b.astype(np.float32)


def test_iou_bev():
    rng = np.random.RandomState(7)
    a, b = _boxes(rng, 40), _boxes(rng, 24)
    want = np.asarray(jax.jit(jiou.iou_bev)(jnp.asarray(a), jnp.asarray(b)))
    got = tiou.iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)
    np.testing.assert_allclose(
        tiou.iou_bev_chunked(torch.from_numpy(a[:32]), torch.from_numpy(b),
                             chunk=16).numpy(), want[:32], atol=1e-5)


@pytest.mark.parametrize("pre,chunk", [(48, 256), (256, 128)],
                         ids=["single", "chunked"])
def test_nms_bev_keep_sets(pre, chunk):
    rng = np.random.RandomState(8)
    p, n = 3, 300
    boxes = np.stack([_boxes(rng, n) for _ in range(p)])
    scores = rng.rand(p, n).astype(np.float32)
    valid = rng.rand(p, n) > 0.1
    got_idx, got_mask = tnms.nms_bev(
        torch.from_numpy(boxes), torch.from_numpy(scores), 0.2, pre, 20,
        valid=torch.from_numpy(valid), chunk=chunk)
    # one jitted program for the three problems (op by op, each op of the
    # NMS loop compiled alone, cost ~10 s)
    jnms_bev = jax.jit(lambda b, s, v: jnms.nms_bev(b, s, 0.2, pre, 20,
                                                    valid=v, chunk=chunk))
    for i in range(p):
        idx, mask = jnms_bev(jnp.asarray(boxes[i]), jnp.asarray(scores[i]),
                             jnp.asarray(valid[i]))
        np.testing.assert_array_equal(got_mask[i].numpy(), np.asarray(mask))
        np.testing.assert_array_equal(got_idx[i].numpy(), np.asarray(idx))
        assert 0 < int(np.asarray(mask).sum())


def test_center_head_predict():
    rng = np.random.RandomState(9)
    b, h, w = 2, 8, 8
    preds = []
    for ncls in (1, 2):
        p = {"hm": rng.randn(b, h, w, ncls) * 1.5, "reg": rng.rand(b, h, w, 2),
             "height": rng.randn(b, h, w, 1), "dim": rng.randn(b, h, w, 3) * .3,
             "rot": rng.randn(b, h, w, 2), "vel": rng.randn(b, h, w, 2)}
        preds.append({k: v.astype(np.float32) for k, v in p.items()})
    args = ((0.5, 0.5), (-16.0, -16.0), 8, (-20.0, -20.0, -4.0, 20.0, 20.0,
                                           4.0), 0.1, 0.2, 32, 8)
    want = jax.jit(lambda p: jhead.center_head_predict(p, *args))(
        [{k: jnp.asarray(v) for k, v in p.items()} for p in preds])
    got = thead.center_head_predict(
        [{k: torch.from_numpy(v) for k, v in p.items()} for p in preds], *args)
    np.testing.assert_array_equal(got["valid"].numpy(),
                                  np.asarray(want["valid"]))
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-6)
    assert got["valid"].any()
