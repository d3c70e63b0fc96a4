"""df3d_torch's TransFusion LC image decoder against df3d's: the decoder
in eval mode with and without the gaussian term, queries that see no
camera, one or two (the last of them chosen), and in training mode (its
branch norms at momentum 0.9, their statistics' update); the attention
with an additive bias against flax's `MultiHeadDotProductAttention` with
`dot_product_attention(..., bias=)`; `collapse_image_init`. tests/
test_transfusion_lc.py's tiny head (16 channels, 2 heads, 3 classes) on 3
cameras of 6x8 feature pixels, batch 2. Flax variables are seeded numpy
on `jax.eval_shape` trees, carried across by df3d_torch.weights
(strictly), and at `transfusion_3ddf_nusc`'s head width (200 queries,
hidden 128, six cameras of 256 channels) the tree carries with every leaf
landing once.

Every JAX function runs inside one jitted program (`_jax_program`).
Exact: the chosen camera of each query. Float outputs to 1e-4 * max|ref|
+ 1e-5 (f32, another summation order)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn

from df3d.models.heads import transfusion_head as jth
from df3d.models.heads.transfusion_lc import TransFusionLCDecoder as JLC
from df3d.models.heads.transfusion_lc import collapse_image_init as jcollapse
from df3d_torch.models.attention import FlaxMultiHeadAttention
from df3d_torch.models.heads import transfusion_head as tth
from df3d_torch.models.heads.transfusion_lc import (
    TransFusionLCDecoder, collapse_image_init,
)
from df3d_torch.weights import state_dict_from_flax
from torch_port_helpers import load_flax, seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)
HEAD = dict(num_classes=3, num_proposals=8, hidden_channel=16, num_heads=2,
            ffn_channel=32, bev_size=(8, 8), head_conv=16)
JCFG, TCFG = jth.TransFusionHeadCfg(**HEAD), tth.TransFusionHeadCfg(**HEAD)
B, P, NC, HC, WC, CI = 2, 8, 3, 6, 8, 12
KEYS = ("center", "height", "dim", "rot", "vel", "cls")


def _tol(got, want, err_msg=""):
    """max |got - want| <= 1e-4 * max |want| + 1e-5."""
    want = np.asarray(want)
    atol = 1e-4 * (np.abs(want).max() if want.size else 0.0) + 1e-5
    np.testing.assert_allclose(np.asarray(got), want, atol=atol, rtol=0,
                               err_msg=err_msg)


def _inputs():
    rng = np.random.RandomState(0)
    first = {"center": rng.uniform(0, 8, (B, P, 2)),
             "height": rng.randn(B, P), "dim": rng.randn(B, P, 3),
             "rot": rng.randn(B, P, 2), "vel": rng.randn(B, P, 2),
             "cls": rng.randn(B, P, 3)}
    # each query sees 0, 1 or 2 cameras
    vis = np.zeros((B, NC, P), bool)
    for b in range(B):
        for p in range(P):
            cams = rng.choice(NC, p % 3, replace=False)
            vis[b, cams, p] = True
    return dict(
        query=rng.randn(B, P, 16).astype(np.float32),
        pos=rng.uniform(0, 8, (B, P, 2)).astype(np.float32),
        first={k: v.astype(np.float32) for k, v in first.items()},
        img=rng.randn(B, NC, HC, WC, CI).astype(np.float32),
        uv=(rng.rand(B, NC, P, 2) * [WC, HC]).astype(np.float32),
        vis=vis,
        radius=rng.uniform(0.5, 3.0, (B, NC, P)).astype(np.float32),
        bev=rng.randn(B, 64, 16).astype(np.float32),
        img16=rng.randn(B, NC, HC, WC, 16).astype(np.float32),
        attn_bias=rng.randn(B, 1, P, 20).astype(np.float32) * 3,
        kv=rng.randn(B, 20, 16).astype(np.float32))


class _CollapseInit(fnn.Module):
    """The JAX package's `collapse_image_init` with one `DecoderLayer` per
    camera, `layer<v>`."""

    @fnn.compact
    def __call__(self, bev, img):
        return jcollapse(JCFG, bev, img, lambda v: jth.DecoderLayer(
            16, 2, 32, name=f"layer{v}"))


class _TorchCollapseInit(torch.nn.Module):
    def __init__(self):
        super().__init__()
        for v in range(NC):
            setattr(self, f"layer{v}", tth.DecoderLayer(16, 2, 32))

    def forward(self, bev, img):
        return collapse_image_init(
            bev, img, [getattr(self, f"layer{v}") for v in range(NC)])


def _attention():
    """flax's attention with an additive bias, as the LC decoder calls it."""
    return lambda bias: fnn.MultiHeadDotProductAttention(
        2, attention_fn=functools.partial(fnn.dot_product_attention,
                                          bias=bias))


def _variables(b):
    lc = jax.eval_shape(lambda *a: JLC(JCFG, num_cams=NC).init(KEY, *a),
                        b["query"], b["pos"], b["first"], b["img"], b["uv"],
                        b["vis"], b["radius"])
    init = jax.eval_shape(lambda *a: _CollapseInit().init(KEY, *a),
                          b["bev"], b["img16"])
    attn = jax.eval_shape(lambda q, kv, bias: _attention()(bias).init(
        KEY, q, kv), b["query"], b["kv"], b["attn_bias"])
    return dict(lc=seeded_variables(lc, np.random.RandomState(1)),
                init=seeded_variables(init, np.random.RandomState(2)),
                attn=seeded_variables(attn, np.random.RandomState(3)))


def _jax_program():
    lc = JLC(JCFG, num_cams=NC)

    @jax.jit
    def run(v, b):
        args = (b["query"], b["pos"], b["first"], b["img"], b["uv"],
                b["vis"])
        out_train, updates = lc.apply(v["lc"], *args, b["radius"],
                                      train=True, mutable=["batch_stats"])
        return dict(
            eval=lc.apply(v["lc"], *args, b["radius"]),
            no_radius=lc.apply(v["lc"], *args),
            train=out_train, stats=updates["batch_stats"],
            init=_CollapseInit().apply(v["init"], b["bev"], b["img16"]),
            attn=_attention()(b["attn_bias"]).apply(v["attn"], b["query"],
                                                    b["kv"]))

    return run


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


@pytest.fixture(scope="module")
def runs():
    batch = _inputs()
    variables = _variables(batch)
    want = jax.tree_util.tree_map(np.array, _jax_program()(
        variables, jax.tree_util.tree_map(jnp.asarray, batch)))
    t = _torch(batch)
    lc = load_flax(TransFusionLCDecoder(TCFG, CI, num_cams=NC),
                   variables["lc"]).eval()
    return dict(batch=batch, t=t, want=want, variables=variables, lc=lc)


def _args(t):
    return (t["query"], t["pos"], t["first"], t["img"], t["uv"], t["vis"])


def test_inputs_cover_the_cases(runs):
    seen = runs["batch"]["vis"].sum(1)
    assert {0, 1, 2} <= set(seen.ravel().tolist())


@pytest.mark.parametrize("radius", [True, False], ids=["gaussian", "plain"])
def test_decoder_eval(runs, radius):
    """Every refined key to the tolerance; the queries no camera sees keep
    the first stage's predictions exactly."""
    t, want = runs["t"], runs["want"]["eval" if radius else "no_radius"]
    with torch.no_grad():
        got = runs["lc"](*_args(t), t["radius"] if radius else None)
    unseen = ~runs["batch"]["vis"].any(1)
    for k in KEYS:
        _tol(got[k].numpy(), want[k], k)
        np.testing.assert_array_equal(got[k].numpy()[unseen],
                                      runs["batch"]["first"][k][unseen])
        assert np.abs(want[k][~unseen]
                      - runs["batch"]["first"][k][~unseen]).max() > 0


def test_the_last_visible_camera(runs):
    """A query that two cameras see attends to the later one: moving its
    centre in the earlier camera changes nothing, in the later one it
    changes the result."""
    t, lc = runs["t"], runs["lc"]
    vis = runs["batch"]["vis"]
    b, p = map(int, np.argwhere(vis.sum(1) == 2)[0])
    first_cam, last_cam = np.flatnonzero(vis[b, :, p])
    with torch.no_grad():
        base = lc(*_args(t), t["radius"])["cls"][b, p]
        for cam, moves in ((first_cam, False), (last_cam, True)):
            uv = t["uv"].clone()
            uv[b, cam, p] += 2.0
            got = lc(t["query"], t["pos"], t["first"], t["img"], uv,
                     t["vis"], t["radius"])["cls"][b, p]
            assert (not torch.equal(got, base)) == moves


def test_decoder_training(runs):
    """Training mode: the branch norms on the batch statistics, and the
    running statistics moved as flax's (momentum 0.9)."""
    t, want = runs["t"], runs["want"]
    lc = runs["lc"]
    lc.train()
    try:
        with torch.no_grad():
            got = lc(*_args(t), t["radius"])
    finally:
        lc.eval()
    for k in KEYS:
        _tol(got[k].numpy(), want["train"][k], k)
    for name, stats in want["stats"].items():
        if name.endswith("_bn0"):
            bn = getattr(lc, name)
            _tol(bn.running_mean.numpy(), stats["mean"], f"{name} mean")
            _tol(bn.running_var.numpy(), stats["var"], f"{name} var")
    load_flax(lc, runs["variables"]["lc"])


def test_attention_bias(runs):
    """`FlaxMultiHeadAttention(..., bias=)` against flax's attention with
    the bias added after the 1/sqrt(head_dim) scale; with no bias, and
    with a zero one, the same bits as before."""
    t = runs["t"]
    attn = load_flax(FlaxMultiHeadAttention(16, 2), runs["variables"]["attn"])
    with torch.no_grad():
        got = attn(t["query"], t["kv"], bias=t["attn_bias"])
        plain = attn(t["query"], t["kv"])
        zero = attn(t["query"], t["kv"], bias=torch.zeros(B, 1, P, 20))
    _tol(got.numpy(), runs["want"]["attn"], "attention")
    assert torch.equal(plain, zero)


def test_collapse_image_init(runs):
    t = runs["t"]
    module = load_flax(_TorchCollapseInit(), runs["variables"]["init"])
    with torch.no_grad():
        got = module(t["bev"], t["img16"])
    _tol(got.numpy(), runs["want"]["init"], "init")


def test_weights_carry_at_full_width():
    """`transfusion_3ddf_nusc`'s head (200 queries, hidden 128, 8 heads,
    ten classes) on six cameras of 256-channel features: the JAX package's
    flax tree (shapes from `jax.eval_shape`) carries into the port's
    decoder with every leaf landing in one entry and every entry
    filled."""
    jcfg, tcfg = jth.TransFusionHeadCfg(), tth.TransFusionHeadCfg()
    p, nc = jcfg.num_proposals, 6
    first = {k: jnp.zeros((1, p) + s) for k, s in (
        ("center", (2,)), ("height", ()), ("dim", (3,)), ("rot", (2,)),
        ("vel", (2,)), ("cls", (10,)))}
    shapes = jax.eval_shape(lambda *a: JLC(jcfg, num_cams=nc).init(KEY, *a),
                            jnp.zeros((1, p, 128)), jnp.zeros((1, p, 2)),
                            first, jnp.zeros((1, nc, 4, 5, 256)),
                            jnp.zeros((1, nc, p, 2)),
                            jnp.ones((1, nc, p), bool))
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, np.float32),
                                   shapes)
    module = TransFusionLCDecoder(tcfg, 256, num_cams=nc)
    sd = state_dict_from_flax(module, zeros)
    assert set(sd) == set(module.state_dict())
    assert len(jax.tree_util.tree_leaves(zeros)) == len(
        [k for k in sd if not k.endswith("num_batches_tracked")])
