"""df3d_torch's camera-fusion modules against df3d's, one module at a time,
with the same seeded inputs and flax weights carried across by
df3d_torch.weights.

The JAX side runs under `jit` wherever FPS is reached: the port rounds
FPS distances as XLA's fused multiply-add chain does there (eager JAX
rounds them another way, and lattice points tie on the last bit).

Tolerances (f32, other summation order): position encodings and gates
atol 1e-5; projections atol 1e-5 on uv; IFAT, LT and ACTR, which stack
several f32 matmuls and norms, atol 1e-4; the DeepLabV3 branch, a deep
conv stack, atol = rtol = 1e-4. Index outputs (FPS, ball query, visibility
masks, sparsify's coords) match exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from flax import linen as fnn

from df3d.core import calib as jcalib
from df3d.models.fusion import gates as jgates
from df3d.models.fusion import position_encoding as jpe
from df3d.models.fusion import projection as jproj
from df3d.models.fusion.actr import ACTR as JACTR
from df3d.models.fusion.actr import ACTRConfig as JACTRConfig
from df3d.models.fusion.hooks import ACTRFusionSpec as JACTRFusionSpec
from df3d.models.fusion.hooks import make_multicam_actr_fusion_hook
from df3d.models.fusion.ifat import IFATGate as JIFATGate
from df3d.models.fusion.pointformer import (
    LocalTransformer as JLocalTransformer,
)
from df3d.models.fusion.pointformer import (
    PreNormEncoderLayer as JPreNormEncoderLayer,
)
from df3d.models.image.resnet import SemDeepLabV3 as JSemDeepLabV3
from df3d.ops import dense3d as jdense
from df3d.ops import pointops as jpo
from df3d.ops import sparse as jsp
from df3d_torch.core import calib as tcalib
from df3d_torch.models.fusion import gates as tgates
from df3d_torch.models.fusion import position_encoding as tpe
from df3d_torch.models.fusion import projection as tproj
from df3d_torch.models.fusion.actr import ACTR, ACTRConfig
from df3d_torch.models.fusion.hooks import (
    ACTRFusionSpec, MultiCamACTRFusionHook,
)
from df3d_torch.models.fusion.ifat import IFATGate
from df3d_torch.models.fusion.pointformer import (
    LocalTransformer, PreNormEncoderLayer,
)
from df3d_torch.models.image.resnet import Bottleneck, SemDeepLabV3
from df3d_torch.ops import dense3d as tdense
from df3d_torch.ops import pointops as tpo
from df3d_torch.ops import sparse as tsp
from df3d_torch.utils.synth import camera_rig
from df3d_torch.weights import params_from_flax, state_dict_from_flax
from torch_port_helpers import load_flax, seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

KEY = jax.random.PRNGKey(0)


def _vars(module, *args, seed=3, **kwargs):
    shapes = jax.eval_shape(lambda: module.init(KEY, *args, **kwargs))
    return seeded_variables(shapes, np.random.RandomState(seed))


def _t(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _grid_points(rng, b, n, pitch=(0.6, 0.6, 1.6)):
    """Voxel-centre-like points on a lattice (many equal distances, so
    argmax ties are exercised) with a random validity mask."""
    coords = rng.randint(0, 8, (b, n, 3)).astype(np.float32)
    xyz = (coords * np.asarray(pitch, np.float32) - 2.0).astype(np.float32)
    return xyz, rng.rand(b, n) > 0.3


def test_position_encodings():
    rng = np.random.RandomState(0)
    depth = rng.uniform(0, 70, (3, 11)).astype(np.float32)
    coords = rng.uniform(-0.2, 1.2, (3, 11, 2)).astype(np.float32)
    td, tc = _t(depth, coords)
    cases = [
        (tpe.position_embedding_sine_depth(td, 16),
         jpe.position_embedding_sine_depth(jnp.asarray(depth), 16)),
        (tpe.position_embedding_sine_sparse(tc, 8),
         jpe.position_embedding_sine_sparse(jnp.asarray(coords), 8)),
        (tpe.position_embedding_sine_2d(7, 9, 8),
         jpe.position_embedding_sine_2d(7, 9, 8)),
        (tpe._sine_embed(td, 6), jpe._sine_embed(jnp.asarray(depth), 6)),
    ]
    for got, want in cases:
        assert got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("name", sorted(tgates.GATES))
def test_gates(name):
    rng = np.random.RandomState(1)
    a, b = (rng.randn(2, 5, 12).astype(np.float32) for _ in range(2))
    jm = jgates.GATES[name]()
    v = _vars(jm, jnp.asarray(a), jnp.asarray(b))
    want = jax.jit(jm.apply)(v, jnp.asarray(a), jnp.asarray(b))
    got = load_flax(tgates.GATES[name](12), v)(*_t(a, b))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)


@pytest.mark.parametrize("npoint,chunks", [(16, 1), (64, 2)])
def test_fps_and_ball_query(npoint, chunks):
    """Exact FPS, the chunked form (64 samples in 2 slabs of 50 rows: more
    samples than valid points, so indices repeat), then the ball query
    around the sampled centers."""
    rng = np.random.RandomState(2)
    xyz, valid = _grid_points(rng, 2, 100)
    txyz, tvalid = _t(xyz, valid)
    got = tpo.furthest_point_sample(txyz, tvalid, npoint, chunks)
    fps = jax.jit(lambda x, v: jpo.furthest_point_sample(x, v, npoint,
                                                         chunks))
    want = np.stack([np.asarray(fps(xyz[i], valid[i])) for i in range(2)])
    np.testing.assert_array_equal(got.numpy(), want)

    centers = np.take_along_axis(xyz, want[..., None].astype(np.int64), 1)
    gi, gm = tpo.ball_query(torch.from_numpy(centers), txyz, tvalid, 1.3, 8)
    for i in range(2):
        wi, wm = jax.jit(lambda c, x, v: jpo.ball_query(c, x, v, 1.3, 8))(
            centers[i], xyz[i], valid[i])
        np.testing.assert_array_equal(gm[i].numpy(), np.asarray(wm))
        np.testing.assert_array_equal(gi[i].numpy(), np.asarray(wi))
    assert gm.any() and not gm.all()


def test_ball_query_ties_at_the_radius():
    """Neighbours at exactly lt_radius (2 m) on the preset's stride-8
    lattice (0.6 m in x and y, 1.6 m in z: 1.2^2 + 1.6^2 = 4), centres from
    voxel_centers_from_coords: the index sets equal the JAX ball query's
    under jit, where XLA rounds |a|^2 + |b|^2 - 2 a.b as fused multiply-add
    chains. Written as elementwise sums, 54 pairs on this lattice fell the
    other way."""
    voxel_size, pc_range = (0.075, 0.075, 0.2), (-54.0, -54.0, -5.0)
    rng = np.random.RandomState(0)
    base = np.stack([rng.randint(0, 5, 600), rng.randint(0, 180, 600),
                     rng.randint(0, 180, 600)], -1)
    offs = [(1, 0, 2), (1, 2, 0), (-1, 0, -2), (-1, -2, 0), (1, 0, -2),
            (0, 0, 0)]
    coords = np.concatenate([base] + [
        np.clip(base[:100] + np.array(o), 0, (4, 179, 179)) for o in offs])
    coords = coords.astype(np.int32)[None]
    xyz = tcalib.voxel_centers_from_coords(torch.from_numpy(coords),
                                           voxel_size, pc_range, 8)
    want_xyz = np.asarray(jcalib.voxel_centers_from_coords(
        jnp.asarray(coords), voxel_size, pc_range, 8))
    np.testing.assert_array_equal(xyz.numpy(), want_xyz)
    centers, valid = xyz[:, :100], torch.ones(xyz.shape[:2], dtype=torch.bool)
    gi, gm = tpo.ball_query(centers, xyz, valid, 2.0, 32)
    wi, wm = jax.jit(lambda c, x, v: jpo.ball_query(c, x, v, 2.0, 32))(
        want_xyz[0, :100], want_xyz[0], np.ones(xyz.shape[1], bool))
    d2 = tpo.pairwise_dist2(centers, xyz)[0].numpy()
    assert (np.abs(d2 - 4.0) < 1e-3).sum() > 300  # pairs at the radius
    np.testing.assert_array_equal(gm[0].numpy(), np.asarray(wm))
    np.testing.assert_array_equal(gi[0].numpy(), np.asarray(wi))
    np.testing.assert_array_equal(
        d2, np.asarray(jax.jit(jpo.pairwise_dist2)(want_xyz[0, :100],
                                                   want_xyz[0])))


def test_ball_query_in_chunks_of_centres(monkeypatch):
    """The ball query computes its distances over chunks of centres (a
    ragged last one here): the same indices and masks as in one chunk."""
    xyz, valid = _grid_points(np.random.RandomState(3), 2, 300,
                              pitch=(0.5, 0.5, 0.5))
    xyz, valid = torch.from_numpy(xyz), torch.from_numpy(valid)
    centers = xyz[:, :50]
    whole = tpo.ball_query(centers, xyz, valid, 1.3, 8)
    monkeypatch.setattr(tpo, "_PAIRS_PER_CHUNK", 7 * 2 * 300)
    chunked = tpo.ball_query(centers, xyz, valid, 1.3, 8)
    for w, c in zip(whole, chunked):
        np.testing.assert_array_equal(c.numpy(), w.numpy())
    assert whole[1].any() and not whole[1].all()


def _lt_inputs(rng, b=2, n=40, c=16):
    """Sample 0: points packed so tightly that every neighborhood overlaps
    (duplicate scatter writes); sample 1: no valid point at all, so every
    neighborhood is all-masked (a camera that sees nothing)."""
    xyz, valid = _grid_points(rng, b, n, pitch=(0.4, 0.4, 0.4))
    valid[1] = False
    feats = rng.randn(b, n, c).astype(np.float32)
    return xyz, feats, valid


@pytest.mark.parametrize("agg,chunks", [("replace", None), ("replace", 2),
                                        ("sum", None)])
def test_local_transformer(agg, chunks):
    rng = np.random.RandomState(3)
    xyz, feats, valid = _lt_inputs(rng)
    args = (jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(valid))
    jm = JLocalTransformer(npoint=8, radius=1.0, nsample=6, d_model=16,
                           num_layers=2, feat_agg_method=agg,
                           fps_chunks=chunks)
    v = _vars(jm, *args)
    want = np.asarray(jax.jit(jm.apply)(v, *args))
    tm = load_flax(LocalTransformer(8, 1.0, 6, 16, 2, feat_agg_method=agg,
                                    fps_chunks=chunks), v)
    with torch.no_grad():
        got = tm(*_t(xyz, feats, valid))
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    # the overlapping neighborhoods did rewrite some rows
    assert not np.allclose(want[0][valid[0]], feats[0][valid[0]])


def test_encoder_layer_all_masked_group():
    """flax fills masked logits with finfo(f32).min, so a neighborhood
    whose mask is all False attends uniformly (a -inf fill, as in
    scaled_dot_product_attention, gives NaN). Inputs of variance ~1e-6
    also pin LayerNorm's eps to flax's 1e-6."""
    rng = np.random.RandomState(9)
    x = (1e-3 * rng.randn(3, 5, 16)).astype(np.float32)
    mask = rng.rand(3, 5) > 0.4
    mask[1] = False
    jm = JPreNormEncoderLayer(16, 4)
    v = _vars(jm, jnp.asarray(x), jnp.asarray(mask))
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x), jnp.asarray(mask)))
    tm = load_flax(PreNormEncoderLayer(16, 4), v)
    with torch.no_grad():
        got = tm(*_t(x, mask)).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4)


def _norm_cases():
    """(flax norm, the port's norm as its module builds it, input): every
    norm kind on the fused path, fed variance ~1e-6 so that eps decides
    the output."""
    cfg = ACTRConfig(**TINY_ACTR)
    return {
        "layernorm": (fnn.LayerNorm(), PreNormEncoderLayer(16).norm1,
                      (5, 16)),
        "groupnorm": (fnn.GroupNorm(num_groups=16),
                      ACTR(cfg, 12, 10, (5, 7)).input_gn0, (2, 3, 4, 16)),
        "ifat_bn": (fnn.BatchNorm(use_running_average=True, epsilon=1e-3),
                    IFATGate([6]).s0_bn0, (2, 3, 4, 6)),
        "resnet_bn": (fnn.BatchNorm(use_running_average=True),
                      Bottleneck(8, 2).bn1, (2, 3, 4, 2)),
    }


@pytest.mark.parametrize("name", ["layernorm", "groupnorm", "ifat_bn",
                                  "resnet_bn"])
def test_norm_epsilons(name):
    jm, tm, shape = _norm_cases()[name]
    rng = np.random.RandomState(10)
    x = (1e-3 * rng.randn(*shape)).astype(np.float32)
    v = _vars(jm, jnp.asarray(x))
    if "batch_stats" in v:  # running variance ~1e-6 as well
        v["batch_stats"]["var"] = np.full_like(v["batch_stats"]["var"], 1e-6)
    want = np.asarray(jax.jit(jm.apply)(v, jnp.asarray(x)))
    tm.load_state_dict({k: t for k, t in zip(
        ("weight", "bias"), _t(v["params"]["scale"], v["params"]["bias"]))}
        | ({"running_mean": torch.from_numpy(v["batch_stats"]["mean"]),
            "running_var": torch.from_numpy(v["batch_stats"]["var"])}
           if "batch_stats" in v else {}), strict=False)
    tm.eval()
    xt = torch.from_numpy(x)
    with torch.no_grad():
        if x.ndim == 4:  # the port's 2D norms run on NCHW
            got = tm(xt.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
        else:
            got = tm(xt)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_splat_duplicates_and_ifat():
    rng = np.random.RandomState(4)
    b, n, c = 2, 30, 6
    # 30 voxels onto a 4x5 map: many share a pixel (last write wins)
    uv = rng.uniform(-0.1, 1.1, (b, n, 2)).astype(np.float32)
    feats = rng.randn(b, n, c).astype(np.float32)
    mask = rng.rand(b, n) > 0.2
    got = tproj.splat_to_image(*_t(uv, feats, mask), (4, 5))
    want = jproj.splat_to_image(jnp.asarray(uv), jnp.asarray(feats),
                                jnp.asarray(mask), (4, 5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    imgs = [rng.randn(b, 8, 10, 5).astype(np.float32),
            rng.randn(b, 4, 5, 7).astype(np.float32)]
    jargs = ([jnp.asarray(i) for i in imgs], [jnp.asarray(feats)] * 2,
             [jnp.asarray(uv)] * 2, [jnp.asarray(mask)] * 2)
    jm = JIFATGate(2)
    v = _vars(jm, *jargs)
    want = jax.jit(jm.apply)(v, *jargs)
    tm = load_flax(IFATGate([c, c]), v)
    with torch.no_grad():
        got = tm(_t(*imgs), _t(feats) * 2, _t(uv) * 2, _t(mask) * 2)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-4)


def _grad_tol(ref):
    """Gradients through a few f32 layers: 1e-4 of the largest entry, and
    1e-5 for the leaves whose gradient is 0 in exact arithmetic but
    rounding noise of ~1e-6 in both packages (a conv bias ahead of a
    training-mode BatchNorm, an attention key bias under the softmax)."""
    return 1e-4 * np.abs(ref).max() + 1e-5


def test_splat_gradient_to_the_winner():
    """splat_to_image's gradient against jax.vjp: a pixel's cotangent goes
    to the voxel whose write won (the last in row order), none to the
    voxels it overwrote, none to masked or off-image ones."""
    rng = np.random.RandomState(11)
    b, n, c = 2, 30, 6
    uv = rng.uniform(-0.1, 1.1, (b, n, 2)).astype(np.float32)
    feats = rng.randn(b, n, c).astype(np.float32)
    mask = rng.rand(b, n) > 0.2
    cot = rng.randn(b, 4, 5, c).astype(np.float32)
    _, vjp = jax.vjp(lambda f: jproj.splat_to_image(
        jnp.asarray(uv), f, jnp.asarray(mask), (4, 5)), jnp.asarray(feats))
    want = np.asarray(vjp(jnp.asarray(cot))[0])
    ft = torch.from_numpy(feats).requires_grad_(True)
    out = tproj.splat_to_image(*_t(uv), ft, *_t(mask), (4, 5))
    (got,) = torch.autograd.grad(out, ft, torch.from_numpy(cot))
    np.testing.assert_array_equal(got.numpy(), want)
    xi = (uv[..., 0] * 5).astype(np.int32)  # truncation, as both cast
    yi = (uv[..., 1] * 4).astype(np.int32)
    ok = mask & (xi >= 0) & (xi < 5) & (yi >= 0) & (yi < 4)
    pix = np.where(ok, yi * 5 + xi, -1)
    losers = [(i, t) for i in range(b) for t in range(n)
              if pix[i, t] >= 0 and (pix[i, t + 1:] == pix[i, t]).any()]
    assert losers  # duplicates: every overwritten voxel gets 0
    for i, t in losers:
        assert not got[i, t].any()
    assert not got.numpy()[~ok].any()


def test_local_transformer_replace_gradient():
    """LT 'replace' (overlapping neighborhoods, so rows are written more
    than once) under jax.vjp: the gradients of the features, of the xyz
    (through the relative positions only: FPS and ball-query indices carry
    none) and of every parameter."""
    rng = np.random.RandomState(12)
    xyz, feats, valid = _lt_inputs(rng)
    cot = rng.randn(*feats.shape).astype(np.float32)
    args = (jnp.asarray(xyz), jnp.asarray(feats), jnp.asarray(valid))
    jm = JLocalTransformer(npoint=8, radius=1.0, nsample=6, d_model=16,
                           num_layers=2, feat_agg_method="replace")
    v = _vars(jm, *args)

    @jax.jit
    def jvjp(params, x, f):
        _, vjp = jax.vjp(lambda p, xx, ff: jm.apply({"params": p}, xx, ff,
                                                    args[2]), params, x, f)
        return vjp(jnp.asarray(cot))

    want_params, want_x, want_f = jvjp(v["params"], *args[:2])
    tm = load_flax(LocalTransformer(8, 1.0, 6, 16, 2,
                                    feat_agg_method="replace"), v)
    tm.requires_grad_(True)
    xt, ft = [t.requires_grad_(True) for t in _t(xyz, feats)]
    out = tm(xt, ft, *_t(valid))
    names = [n for n, _ in tm.named_parameters()]
    got = torch.autograd.grad(out, [*tm.parameters(), xt, ft],
                              torch.from_numpy(cot), allow_unused=True,
                              materialize_grads=True)
    want = params_from_flax(tm, jax.tree_util.tree_map(np.asarray,
                                                       want_params))
    for name, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=_grad_tol(want[name].numpy()),
                                   err_msg=name)
    for g, w in zip(got[-2:], (want_x, want_f)):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=_grad_tol(w))


def test_ifat_gate_training():
    """IFATGate in training mode against flax (its BatchNorms at momentum
    0.99, eps 1e-3, the biased fast variance): gated features, the
    gradients of every parameter and of the voxel features (through the
    splat; the image features get theirs through the gate), and the batch
    statistics after the update."""
    rng = np.random.RandomState(13)
    b, n, c = 2, 30, 6
    uv = rng.uniform(-0.1, 1.1, (b, n, 2)).astype(np.float32)
    feats = rng.randn(b, n, c).astype(np.float32)
    mask = rng.rand(b, n) > 0.2
    imgs = [rng.randn(b, 8, 10, 5).astype(np.float32),
            rng.randn(b, 4, 5, 7).astype(np.float32)]
    cots = [rng.randn(*i.shape).astype(np.float32) for i in imgs]
    jm = JIFATGate(2)
    jargs = ([jnp.asarray(i) for i in imgs], [jnp.asarray(feats)] * 2,
             [jnp.asarray(uv)] * 2, [jnp.asarray(mask)] * 2)
    v = _vars(jm, *jargs)

    @jax.jit
    def jstep(params, stats, im, fe):
        def f(p, ii, ff):
            out, upd = jm.apply({"params": p, "batch_stats": stats}, ii,
                                [ff] * 2, *jargs[2:], train=True,
                                mutable=["batch_stats"])
            return out, upd["batch_stats"]
        out, vjp, upd = jax.vjp(f, params, im, fe, has_aux=True)
        return out, vjp([jnp.asarray(t) for t in cots]), upd

    want_out, (gp, gi, gf), upd = jstep(v["params"], v["batch_stats"],
                                        jargs[0], jnp.asarray(feats))
    tm = IFATGate([c, c])
    tm.load_state_dict(state_dict_from_flax(tm, v))
    tm.train()
    it = [t.requires_grad_(True) for t in _t(*imgs)]
    ft = torch.from_numpy(feats).requires_grad_(True)
    out = tm(it, [ft] * 2, _t(uv) * 2, _t(mask) * 2)
    names = [n for n, _ in tm.named_parameters()]
    got = torch.autograd.grad(out, [*tm.parameters(), *it, ft],
                              [torch.from_numpy(t) for t in cots])
    for o, w in zip(out, want_out):
        np.testing.assert_allclose(o.detach().numpy(), np.asarray(w),
                                   atol=1e-4)
    want = params_from_flax(tm, jax.tree_util.tree_map(np.asarray, gp))
    for name, g in zip(names, got):
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=0,
                                   atol=_grad_tol(want[name].numpy()),
                                   err_msg=name)
    for g, w in zip(got[len(names):], [*gi, gf]):
        w = np.asarray(w)
        assert np.abs(w).max() > 0
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=_grad_tol(w))
    stats = state_dict_from_flax(tm, {"params": v["params"],
                                      "batch_stats": jax.tree_util.tree_map(
                                          np.asarray, upd)})
    for k, t in tm.state_dict().items():
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(t, torch.from_numpy(np.asarray(
                v["batch_stats"][k.split(".")[0]][
                    "mean" if "mean" in k else "var"]))), k
            np.testing.assert_allclose(t.numpy(), stats[k].numpy(),
                                       rtol=0, atol=1e-6, err_msg=k)


def test_projection_and_sparsify():
    rng = np.random.RandomState(5)
    b, n = 2, 50
    voxel_size, pc_range = (0.5, 0.5, 0.2), (-16.0, -16.0, -2.4, 16, 16, 2.4)
    coords = np.stack([rng.randint(0, 3, (b, n)), rng.randint(0, 8, (b, n)),
                       rng.randint(0, 8, (b, n))], -1).astype(np.int32)
    coords[:, -5:] = -1
    valid = coords[..., 0] >= 0
    rig = camera_rig(3, (32, 48))
    proj = np.stack([rig, rig + 0.01 * rng.randn(*rig.shape)]).astype(
        np.float32)
    got = tproj.project_voxels_to_image(*_t(coords, valid, proj), (32, 48),
                                        voxel_size, pc_range, 8)
    want = jproj.project_voxels_to_image(
        jnp.asarray(coords), jnp.asarray(valid), jnp.asarray(proj), (32, 48),
        voxel_size, pc_range, 8)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               atol=1e-5)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]),
                               atol=1e-4)
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    assert got[2].any() and not got[2].all()

    # the augmentation inverse, single camera; batch 1, where the JAX
    # package's per-sample scale broadcasts
    for fx, fy in ((True, False), (False, True)):
        aug = [np.array([0.3], np.float32), np.array([1.05], np.float32),
               np.array([fx]), np.array([fy])]
        got = tproj.project_voxels_to_image(
            *_t(coords[:1], valid[:1], proj[:1, 0]), (32, 48), voxel_size,
            pc_range, 8, *_t(*aug))
        want = jproj.project_voxels_to_image(
            jnp.asarray(coords[:1]), jnp.asarray(valid[:1]),
            jnp.asarray(proj[:1, 0]), (32, 48), voxel_size, pc_range, 8,
            *map(jnp.asarray, aug))
        np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                                   atol=1e-5)
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_allclose(
        tcalib.voxel_centers_from_coords(torch.from_numpy(coords), voxel_size,
                                         pc_range, 8).numpy(),
        np.asarray(jcalib.voxel_centers_from_coords(
            jnp.asarray(coords), voxel_size, pc_range, 8)), atol=1e-6)

    # sparsify: a cap below and above the active count
    mask = rng.rand(b, 3, 5, 6) > 0.6
    feats = (rng.randn(b, 3, 5, 6, 4) * mask[..., None]).astype(np.float32)
    for cap in (20, 60):
        got = tdense.sparsify(tdense.DenseTensor(*_t(feats, mask)), cap)
        want = jdense.sparsify(jdense.DenseTensor(jnp.asarray(feats),
                                                  jnp.asarray(mask)), cap)
        np.testing.assert_array_equal(got.coords.numpy(),
                                      np.asarray(want.coords))
        np.testing.assert_array_equal(got.features.numpy(),
                                      np.asarray(want.features))


TINY_ACTR = dict(d_model=16, n_heads=2, n_points=2, n_levels=2,
                 num_layers=1, dim_feedforward=32, lt_npoint=8,
                 lt_nsample=4, model_name="ACTRv2")


def test_actr():
    rng = np.random.RandomState(6)
    b, q = 2, 24
    xyz, valid = _grid_points(rng, b, q, pitch=(0.6, 0.6, 1.6))
    q_feat = rng.randn(b, q, 12).astype(np.float32)
    q_i_feat = rng.randn(b, q, 10).astype(np.float32)
    ref = rng.uniform(-0.1, 1.1, (b, q, 2)).astype(np.float32)
    i_feats = [rng.randn(b, 6, 8, 5).astype(np.float32),
               rng.randn(b, 3, 4, 7).astype(np.float32)]
    jm = JACTR(JACTRConfig(**TINY_ACTR))
    jargs = (jnp.asarray(q_feat), jnp.asarray(q_i_feat), jnp.asarray(ref),
             jnp.asarray(xyz), jnp.asarray(valid),
             [jnp.asarray(f) for f in i_feats])
    v = _vars(jm, *jargs)
    want = np.asarray(jax.jit(jm.apply)(v, *jargs))
    tm = load_flax(ACTR(ACTRConfig(**TINY_ACTR), 12, 10, (5, 7)), v)
    with torch.no_grad():
        got = tm(*_t(q_feat, q_i_feat, ref, xyz, valid), _t(*i_feats))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


HOOK_GEOMETRY = ((0.5, 0.5, 0.2), (-16.0, -16.0, -2.4, 16.0, 16.0, 2.4))


class _JHookHost(fnn.Module):
    """Hosts the JAX multi-camera hook as the backbone does: its modules
    (ifat, actr, actr_out_proj) are created in this module's scope."""

    spec: object
    image_shape: tuple
    num_cams: int

    @fnn.compact
    def __call__(self, feats, coords, image_feats, proj):
        st = jsp.SparseTensor(feats, coords, (3, 8, 8), rows_sorted=True)
        hook = make_multicam_actr_fusion_hook(
            self.spec, HOOK_GEOMETRY[0], HOOK_GEOMETRY[1], self.image_shape,
            self.num_cams)
        return hook(self, [st], False, image_feats=image_feats,
                    proj=proj).features


def test_multicam_fusion_hook_batch2():
    """The hook at batch 2 with 2 cameras: the (batch, camera) folding of
    queries, image features and the per-camera sum."""
    rng = np.random.RandomState(8)
    b, nc, n, c = 2, 2, 40, 8
    keys = np.stack([np.sort(rng.choice(3 * 64, 34, replace=False))
                     for _ in range(b)])
    coords = np.stack([keys // 64, keys // 8 % 8, keys % 8], -1)
    coords = np.concatenate([coords, -np.ones((b, n - 34, 3), int)], 1)
    coords = coords.astype(np.int32)
    feats = (rng.randn(b, n, c) * (coords[..., :1] >= 0)).astype(np.float32)
    image_feats = [rng.randn(b, nc, 8, 12, 5).astype(np.float32),
                   rng.randn(b, nc, 4, 6, 7).astype(np.float32)]
    proj = np.broadcast_to(camera_rig(nc, (32, 48)), (b, nc, 3, 4)).copy()

    jm = _JHookHost(JACTRFusionSpec(JACTRConfig(**TINY_ACTR), 8), (32, 48),
                    nc)
    jargs = (jnp.asarray(feats), jnp.asarray(coords),
             [jnp.asarray(f) for f in image_feats], jnp.asarray(proj))
    v = _vars(jm, *jargs)
    want = np.asarray(jax.jit(jm.apply)(v, *jargs))
    tm = load_flax(MultiCamACTRFusionHook(
        ACTRFusionSpec(ACTRConfig(**TINY_ACTR), 8), *HOOK_GEOMETRY, (32, 48),
        nc, voxel_channels=c, image_channels=(5, 7)), v)
    st = tsp.SparseTensor(*_t(feats, coords), (3, 8, 8))
    with torch.no_grad():
        got = tm(st, _t(*image_feats), torch.from_numpy(proj)).features
    assert not np.allclose(want, feats)  # the cameras did see voxels
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)


def test_sem_deeplabv3_taps_and_logits():
    rng = np.random.RandomState(7)
    images = rng.randn(1, 32, 48, 3).astype(np.float32)
    jm = JSemDeepLabV3(backbone_layers=(1, 1, 1, 1))
    v = _vars(jm, jnp.asarray(images))
    want = jax.jit(jm.apply)(v, jnp.asarray(images))
    tm = load_flax(SemDeepLabV3(backbone_layers=(1, 1, 1, 1)), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(images), with_logits=True)
        taps = tm(torch.from_numpy(images))
    assert set(got) == set(want) and "logits" not in taps
    for name in want:
        np.testing.assert_allclose(got[name].numpy(), np.asarray(want[name]),
                                   atol=1e-4, rtol=1e-4, err_msg=name)
        if name != "logits":
            np.testing.assert_array_equal(taps[name].numpy(),
                                          got[name].numpy())
