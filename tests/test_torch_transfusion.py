"""df3d_torch's TransFusion modules against df3d's, one module at a time,
with the same seeded inputs and flax weights carried across by
df3d_torch.weights: the box coder, the SparseEncoder (hybrid tail), flax
attention with separate query and key inputs, the decoder layer, the
learned position embedding, the head, its decode, and ResNet + FPN.

Tolerances (f32, other summation order): the coder 1e-6; the encoder's
BEV map 1e-4 relative to its scale; the attention, decoder and position
embedding 1e-5; the head's dense heatmap and every branch 1e-4; FPN levels
1e-4 relative to their scale (a ResNet stack). Cap overflows, query labels
and query positions match exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F
from flax import linen as fnn

from df3d.core.box_coders import TransFusionBBoxCoder as JCoder
from df3d.models.backbones_3d import SparseEncoder as JSparseEncoder
from df3d.models.heads import transfusion_head as jhead
from df3d.models.image.resnet import ResNetFPN as JResNetFPN
from df3d.ops import sparse as jsp
from df3d_torch.core.box_coders import TransFusionBBoxCoder
from df3d_torch.models.attention import FlaxMultiHeadAttention
from df3d_torch.models.backbones_3d import SparseEncoder
from df3d_torch.models.heads import transfusion_head as thead
from df3d_torch.models.image.resnet import ResNetFPN
from df3d_torch.ops import sparse as tsp
from torch_port_helpers import load_flax, seeded_variables, sparse_inputs
from torch_port_helpers import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
TOL = dict(atol=1e-5, rtol=1e-5)
# tests/test_transfusion_e2e.py's tiny head
HEAD = dict(num_classes=3, num_proposals=16, hidden_channel=32, num_heads=4,
            ffn_channel=64, small_classes=(2,), bev_size=(8, 8),
            out_size_factor=8, voxel_size=(0.5, 0.5), pc_range=(-16.0, -16.0))


def _vars(module, *args, seed=3):
    shapes = jax.eval_shape(lambda: module.init(KEY, *args))
    return seeded_variables(shapes, np.random.RandomState(seed))


def _close(got, want, rel, err_msg=""):
    """max |got - want| <= rel * max |want| (+ rel)."""
    want = np.asarray(want)
    scale = np.abs(want).max() if want.size else 0.0
    np.testing.assert_allclose(np.asarray(got), want, atol=rel * (scale + 1),
                               rtol=0, err_msg=err_msg)


@pytest.mark.parametrize("with_vel", [True, False])
def test_bbox_coder(with_vel):
    """encode to the 10-wide code; decode to 9-dof boxes, or to 7-dof ones
    without velocities."""
    rng = np.random.RandomState(0)
    boxes = np.concatenate([rng.uniform(-50, 50, (2, 30, 2)),
                            rng.uniform(-3, 1, (2, 30, 1)),
                            rng.uniform(0.3, 6, (2, 30, 3)),
                            rng.uniform(-np.pi, np.pi, (2, 30, 1)),
                            rng.randn(2, 30, 2)], -1).astype(np.float32)
    args = ((-54.0, -54.0), (0.075, 0.075), 8)
    jc, tc = JCoder(*args, code_size=10), TransFusionBBoxCoder(*args)
    got = tc.encode(torch.from_numpy(boxes))
    want = jc.encode(jnp.asarray(boxes))
    assert got.shape[-1] == 10
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6,
                               rtol=1e-6)
    enc = rng.randn(2, 30, 10).astype(np.float32)
    parts = lambda e: (e[..., :2], e[..., 2], e[..., 3:6], e[..., 6],
                       e[..., 7], e[..., 8:10] if with_vel else None)
    got = tc.decode(*parts(torch.from_numpy(enc)))
    want = jc.decode(*parts(jnp.asarray(enc)))
    assert got.shape[-1] == (9 if with_vel else 7)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-6)


def test_sparse_encoder():
    """Three strided stages (pads 1, 1, (0, 1, 1)), the last one then
    densified, the dense last stage and conv_out, on a 25-deep grid (the
    least depth that leaves conv_out a row). The caps cut the first two
    strided stages and leave the third whole (the slice tests run the
    encoder uncapped)."""
    caps = (120, 200, 60, 12)
    rng = np.random.RandomState(1)
    shape = (25, 16, 16)
    feats, coords = sparse_inputs(rng, batch=2, shape=shape, n=90, cin=4,
                                  pad_to=120)
    jst = jsp.SparseTensor(jnp.asarray(feats), jnp.asarray(coords), shape,
                           rows_sorted=True)
    jm = JSparseEncoder(4, caps, dense_tail=True)
    v = _vars(jm, jst, False)
    (jbev, _), inter = jax.jit(lambda v, st: jm.apply(
        v, st, False, mutable=["intermediates"]))(v, jst)
    jover = {k: np.asarray(t[0]) for k, t in inter["intermediates"].items()}

    tm = load_flax(SparseEncoder(4), v)
    with torch.no_grad():
        tbev, _, tover = tm(tsp.SparseTensor(torch.from_numpy(feats),
                                             torch.from_numpy(coords), shape),
                            caps)
    assert set(tover) == set(jover) == {"cap_overflow_down2",
                                        "cap_overflow_down3",
                                        "cap_overflow_down4"}
    for k in jover:
        np.testing.assert_array_equal(tover[k].numpy(), jover[k], err_msg=k)
    assert [bool(jover[f"cap_overflow_down{i}"].all()) for i in (2, 3, 4)
            ] == [True, True, False]
    assert tbev.shape == jbev.shape == (2, 2, 2, 128)
    assert np.abs(np.asarray(jbev)).max() > 0
    _close(tbev.numpy(), jbev, 1e-4)


def test_attention_values_from_key_input():
    """flax takes the values from the key input: attn(q, kv + pos) projects
    kv + pos for both keys and values, which differs from values taken
    from kv alone (the DETR-style reading)."""
    rng = np.random.RandomState(2)
    q = rng.randn(2, 5, 16).astype(np.float32)
    kv, pos = (rng.randn(2, 9, 16).astype(np.float32) for _ in range(2))
    jm = fnn.MultiHeadDotProductAttention(4)
    v = _vars(jm, jnp.asarray(q), jnp.asarray(kv))
    want = np.asarray(jm.apply(v, jnp.asarray(q), jnp.asarray(kv + pos)))
    detr = np.asarray(jm.apply(v, jnp.asarray(q), jnp.asarray(kv + pos),
                               jnp.asarray(kv)))
    tm = load_flax(FlaxMultiHeadAttention(16, 4), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(q), torch.from_numpy(kv + pos))
        own = tm(torch.from_numpy(q))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(detr - want).max() > 1e-2
    np.testing.assert_allclose(own.numpy(),
                               np.asarray(jm.apply(v, jnp.asarray(q))), **TOL)


def test_position_embedding_learned():
    rng = np.random.RandomState(3)
    xy = (rng.rand(2, 11, 2) * 20).astype(np.float32)
    jm = jhead.PositionEmbeddingLearned(16)
    v = _vars(jm, jnp.asarray(xy), False)
    want = np.asarray(jm.apply(v, jnp.asarray(xy), False))
    tm = load_flax(thead.PositionEmbeddingLearned(2, 16), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(xy))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-5)


def test_decoder_layer():
    rng = np.random.RandomState(4)
    q, q_pos = (rng.randn(2, 7, 32).astype(np.float32) for _ in range(2))
    kv, kv_pos = (rng.randn(2, 20, 32).astype(np.float32) for _ in range(2))
    args = [jnp.asarray(a) for a in (q, q_pos, kv, kv_pos)]
    jm = jhead.DecoderLayer(32, 4, 64)
    v = _vars(jm, *args)
    want = np.asarray(jax.jit(jm.apply)(v, *args))
    tm = load_flax(thead.DecoderLayer(32, 4, 64), v)
    with torch.no_grad():
        got = tm(*(torch.from_numpy(a) for a in (q, q_pos, kv, kv_pos)))
    np.testing.assert_allclose(got.numpy(), want, **TOL)


# (head config overrides, BEV size): the tiny head, and one whose few peaks
# leave most of the proposals tied at exactly 0
HEAD_CASES = {
    "random": ({}, (8, 8)),
    "zero_ties": (dict(small_classes=(), num_proposals=30,
                       bev_size=(6, 6)), (6, 6)),
}


@pytest.mark.parametrize("case", list(HEAD_CASES))
def test_transfusion_head(case):
    over, (hh, ww) = HEAD_CASES[case]
    kw = dict(HEAD, **over)
    rng = np.random.RandomState(5)
    bev = rng.randn(2, hh, ww, 24).astype(np.float32)
    jcfg = jhead.TransFusionHeadCfg(**kw)
    jm = jhead.TransFusionHead(jcfg)
    v = _vars(jm, jnp.asarray(bev), False)
    want = jax.jit(lambda v, x: jm.apply(v, x, False))(v, jnp.asarray(bev))
    tm = load_flax(thead.TransFusionHead(thead.TransFusionHeadCfg(**kw), 24),
                   v)
    with torch.no_grad():
        got = tm(torch.from_numpy(bev))
    assert set(got) == set(want)
    np.testing.assert_allclose(got["dense_heatmap"].numpy(),
                               np.asarray(want["dense_heatmap"]), atol=1e-4,
                               rtol=1e-4)
    np.testing.assert_array_equal(got["query_labels"].numpy(),
                                  np.asarray(want["query_labels"]))
    np.testing.assert_array_equal(got["query_pos_xy"].numpy(),
                                  np.asarray(want["query_pos_xy"]))
    for name in ("query_feat", "center", "height", "dim", "rot", "vel",
                 "cls", "query_score"):
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
    if case == "zero_ties":
        # fewer peaks than proposals: the rest are non-peaks, all tied at
        # exactly 0, so the tie order decides those queries
        heat = jax.nn.sigmoid(want["dense_heatmap"])
        pooled = fnn.max_pool(heat, (3, 3), strides=(1, 1),
                              padding=((1, 1), (1, 1)))
        n_peaks = np.asarray(heat == pooled).reshape(2, -1).sum(-1)
        assert (n_peaks < kw["num_proposals"]).all()


def test_transfusion_get_bboxes():
    rng = np.random.RandomState(6)
    b, p, ncls = 2, 16, 3
    preds = {"center": rng.rand(b, p, 2) * 8, "height": rng.randn(b, p),
             "dim": rng.randn(b, p, 3) * 0.3, "rot": rng.randn(b, p, 2),
             "vel": rng.randn(b, p, 2), "cls": rng.randn(b, p, ncls),
             "query_score": rng.rand(b, p, ncls),
             "query_labels": rng.randint(0, ncls, (b, p))}
    preds = {k: v.astype(np.int64 if k == "query_labels" else np.float32)
             for k, v in preds.items()}
    preds["cls"][0, 0, :2] = 1.5  # tied best classes: the first wins
    jcfg = jhead.TransFusionHeadCfg(**HEAD)
    want = jhead.transfusion_get_bboxes(
        jcfg, {k: jnp.asarray(v) for k, v in preds.items()})
    got = thead.transfusion_get_bboxes(
        thead.TransFusionHeadCfg(**HEAD),
        {k: torch.from_numpy(v) for k, v in preds.items()})
    np.testing.assert_array_equal(got["labels"].numpy(),
                                  np.asarray(want["labels"]))
    assert got["labels"][0, 0] == 0
    np.testing.assert_allclose(got["boxes"].numpy(), np.asarray(want["boxes"]),
                               atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(got["scores"].numpy(),
                               np.asarray(want["scores"]), atol=1e-6)


@pytest.mark.parametrize("size,src,dst", [((4,), 4, 7), ((3,), 3, 5),
                                          ((2,), 2, 4)])
def test_nearest_upsample_is_half_pixel(size, src, dst):
    """jax.image.resize "nearest" picks floor((i + 0.5) * src / dst):
    torch's "nearest-exact", which FPN uses; "nearest" differs at 4 -> 7."""
    x = np.arange(src, dtype=np.float32).reshape(1, 1, 1, src)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 1, 1, dst),
                                       "nearest"))[0, 0, 0]
    got = F.interpolate(torch.from_numpy(x), size=(1, dst),
                        mode="nearest-exact")[0, 0, 0].numpy()
    np.testing.assert_array_equal(got, want)
    if (src, dst) == (4, 7):
        np.testing.assert_array_equal(want, [0, 0, 1, 2, 2, 3, 3])
        legacy = F.interpolate(torch.from_numpy(x), size=(1, dst),
                               mode="nearest")[0, 0, 0].numpy()
        assert not np.array_equal(legacy, want)


@pytest.mark.parametrize("hw", [(64, 112), (48, 72)])
def test_resnet_fpn(hw):
    """All five FPN levels at image sizes whose levels do not halve exactly
    (64x112: C5 2x4 under C4 4x7; 48x72: C5 2x3 under C4 3x5)."""
    rng = np.random.RandomState(7)
    images = rng.randn(2, *hw, 3).astype(np.float32)
    jm = JResNetFPN(layers=(1, 1, 1, 1))
    v = _vars(jm, jnp.asarray(images), False)
    want = jax.jit(lambda v, x: jm.apply(v, x, False))(v, jnp.asarray(images))
    tm = load_flax(ResNetFPN(layers=(1, 1, 1, 1)), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(images))
        first = tm(torch.from_numpy(images), levels=1)
    assert len(got) == len(want) == 5
    for lvl, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, lvl
        _close(g.numpy(), w, 1e-4, err_msg=f"level {lvl}")
    assert len(first) == 1
    np.testing.assert_array_equal(first[0].numpy(), got[0].numpy())
