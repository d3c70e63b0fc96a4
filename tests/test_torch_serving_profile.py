"""The serving profiles, df3d_torch against df3d: `PROFILES` field for
field; under "tpu_v5e" the bf16 conv body (the plain version of K1's bf16
kernel) against the JAX package's XLA conv under `set_compute_dtype(bf16,
32)` and against its Pallas kernel with `table_dtype=bf16` (interpret
mode), the dense tail's conv and `MaskedBatchNorm` in eval on bf16 input.

Tolerances are in bf16 terms. A bf16 value has 8 significant bits, so one
unit in the last place (ulp) is at most 2^-7 of the value; the port and
XLA sum the same exact bf16 x bf16 products in f32 in other orders and
round once, so an output may land one ulp apart where the f32 sum sits at
a rounding boundary: `_ulps` counts the distance on the bf16 bit
patterns. The JAX package's dtype globals are set only inside the
`jax_bf16` fixture, which restores "exact" on teardown."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d import serving as jserving
from df3d.models import layers as jlayers
from df3d.ops import dense3d as jdense
from df3d.ops import sparse as jsp
from df3d.ops.pallas.sparse_conv_kernel import apply_sparse_conv_pallas_v2
from df3d_torch import serving
from df3d_torch.models.layers import MaskedBatchNorm, SubMConv3d
from df3d_torch.ops import dense3d as tdense
from df3d_torch.ops import sparse as tsp
from df3d_torch.ops import sparse_conv_kernel as k1
from torch_port_helpers import sparse_inputs
from torch_port_helpers import one_torch_thread  # noqa: F401


@pytest.fixture
def jax_bf16():
    """The JAX package in its "tpu_v5e" profile for one test, "exact"
    again (its defaults) after it, whatever the test did."""
    jserving.apply_profile("tpu_v5e")
    try:
        yield
    finally:
        jserving.apply_profile("exact")


def _bits(x) -> np.ndarray:
    """bf16 values (a torch or JAX array) as int32 sign-magnitude codes,
    ordered as the values are."""
    if isinstance(x, torch.Tensor):
        u = x.contiguous().view(torch.int16).numpy().astype(np.int32)
    else:
        u = np.asarray(x).view(np.int16).astype(np.int32)
    u &= 0xFFFF
    return np.where(u & 0x8000, -(u & 0x7FFF), u)


def _ulps(a, b) -> np.ndarray:
    """Distance in bf16 ulps between two bf16 arrays, element by element."""
    return np.abs(_bits(a) - _bits(b))


def _bf16(x: torch.Tensor) -> jnp.ndarray:
    return jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)


def test_profiles_match_jax():
    assert set(serving.PROFILES) == set(jserving.PROFILES)
    for name, p in serving.PROFILES.items():
        assert dataclasses.asdict(p) == dataclasses.asdict(
            jserving.PROFILES[name]), name


def test_apply_profile_sets_modules_only():
    """The profile lives on the model's conv modules; "exact" after
    "tpu_v5e" restores them. Any module that holds sparse convs takes it,
    as every detector does."""
    from df3d_torch.entry import small_cfg
    from df3d_torch.models.detectors.centerpoint import CenterPoint

    model = CenterPoint(small_cfg())
    convs = [m for m in model.modules() if isinstance(m, SubMConv3d)]
    assert serving.apply_profile(model, "tpu_v5e").conv_min_channels == 32
    assert all(m.compute_dtype == torch.bfloat16 and m.min_channels == 32
               for m in convs)
    other = CenterPoint(small_cfg())
    assert all(m.compute_dtype is None for m in other.modules()
               if isinstance(m, SubMConv3d))
    serving.apply_profile(model, "exact")
    assert all(m.compute_dtype is None and m.min_channels == 0
               for m in convs)
    stack = torch.nn.Sequential(SubMConv3d(32, 32))
    assert serving.apply_profile(stack, "tpu_v5e").name == "tpu_v5e"
    assert stack[0].compute_dtype == torch.bfloat16
    assert serving.apply_profile(stack, "exact").name == "exact"
    assert stack[0].compute_dtype is None


# (name, plan kind and geometry, input channels, output channels); Cin 16
# stays below the profile's gate of 32 and runs f32. The Pallas kernel
# takes at most N_in + 1 = 97 output rows (the JAX package's condition for
# routing to it), hence the strided caps.
CONV_CASES = [
    ("subm_cin32", ("subm", 3), 32, 32),
    ("subm_cin64", ("subm", 3), 64, 48),
    ("subm_cin16_f32", ("subm", 3), 16, 16),
    ("strided_cin32", ("conv", 3, 2, 1, 96), 32, 64),
    ("strided_cin64_cap", ("conv", 3, 2, (0, 1, 1), 24), 64, 128),
]


# the plans as jitted programs (op by op each compiled ~90 small ones); the
# conv bodies stay eager, since the JAX package reads its profile while a
# program is traced
_jsubm_plan = jax.jit(jsp.build_subm_plan, static_argnums=1)
_jconv_plan = jax.jit(jsp.build_conv_plan, static_argnums=(1, 2, 3, 4))


def _conv_inputs(case, rng):
    _, geom, cin, cout = case
    feats, coords = sparse_inputs(rng, batch=2, shape=(8, 12, 12), n=80,
                                  cin=cin, pad_to=96)
    feats *= 3.0  # values over several binades
    jst = jsp.SparseTensor(jnp.asarray(feats), jnp.asarray(coords),
                           (8, 12, 12), rows_sorted=True)
    tst = tsp.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords),
                           (8, 12, 12))
    if geom[0] == "subm":
        jplan, tplan = _jsubm_plan(jst, 3), tsp.build_subm_plan(tst, 3)
    else:
        _, k, s, p, max_out = geom
        jplan = _jconv_plan(jst, k, s, p, max_out)
        tplan = tsp.build_conv_plan(tst, k, s, p, max_out)
    w = (rng.randn(27, cin, cout) / np.sqrt(27 * cin)).astype(np.float32)
    return jst, tst, jplan, tplan, w


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_bf16_conv_body_against_jax(case, jax_bf16):
    """The port's conv body under the profile's gate against the JAX
    package's, which takes the center-identity form on submanifold plans
    (the other taps' sum, then the center tap's, in f32) and the one
    gather + product on strided ones; and the bf16 plain version against
    the Pallas kernel with a bf16 table. Same output dtype; at most one
    ulp apart on under 1% of the elements (f32 summation order; measured:
    equal but for one element of 6144 in the Cin-64 strided case)."""
    jst, tst, jplan, tplan, w = _conv_inputs(case, np.random.RandomState(3))
    _, _, cin, _ = case
    np.testing.assert_array_equal(tplan.gather_idx.numpy(),
                                  np.asarray(jplan.gather_idx))
    assert (tplan.gather_idx.numpy() == tst.num_rows).any()  # miss rows
    jout = jsp.apply_sparse_conv(jst.features, jplan, jnp.asarray(w))
    with torch.no_grad():
        tout = tsp.apply_sparse_conv(tst.features, tplan,
                                     torch.from_numpy(w), torch.bfloat16, 32)
    assert str(jout.dtype) == str(tout.dtype).removeprefix("torch.")
    if cin < 32:
        assert tout.dtype == torch.float32
        np.testing.assert_allclose(tout.numpy(), np.asarray(jout),
                                   atol=1e-5, rtol=1e-5)
        return
    d = _ulps(tout, jout)
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
    # the plain version itself, against the Pallas kernel's f32 result
    # rounded once
    plain = k1.sparse_conv_bf16_plain(tst.features, tplan.gather_idx,
                                      torch.from_numpy(w))
    assert torch.equal(plain, tout)
    idx = jnp.asarray(tplan.gather_idx.numpy()).reshape(2, 27, -1)
    jpal = apply_sparse_conv_pallas_v2(
        jst.features, idx, jnp.asarray(w), jnp.bfloat16, True)
    assert jpal.dtype == jnp.float32
    d = _ulps(plain, jpal.astype(jnp.bfloat16))
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())


def test_bf16_conv_body_serves_only():
    """The bf16 body has no gradient: it refuses weights that need one
    while autograd records, and runs under no_grad."""
    _, tst, _, tplan, w = _conv_inputs(CONV_CASES[0],
                                       np.random.RandomState(4))
    wt = torch.from_numpy(w).requires_grad_(True)
    with pytest.raises(RuntimeError, match="no_grad"):
        tsp.apply_sparse_conv(tst.features, tplan, wt, torch.bfloat16, 32)
    with torch.no_grad():
        out = tsp.apply_sparse_conv(tst.features, tplan, wt, torch.bfloat16,
                                    32)
    assert out.dtype == torch.bfloat16


# (input dtype, subm) of the dense tail's convs: the profile rounds every
# one's operands, whatever the channel count
DENSE_CASES = [("float32", True), ("bfloat16", True), ("bfloat16", False)]


@pytest.mark.parametrize("dtype, subm", DENSE_CASES)
def test_dense_conv_bf16_against_jax(dtype, subm, jax_bf16):
    rng = np.random.RandomState(5)
    feats = (3 * rng.randn(2, 5, 6, 6, 16)).astype(np.float32)
    mask = rng.rand(2, 5, 6, 6) < 0.4
    feats *= mask[..., None]
    w = (rng.randn(27, 16, 24) / np.sqrt(27 * 16)).astype(np.float32)
    tdt = getattr(torch, dtype)
    tx = torch.from_numpy(feats).to(tdt)
    jx = _bf16(tx) if dtype == "bfloat16" else jnp.asarray(feats)
    stride, pad = ((1, 1, 1), (1, 1, 1)) if subm else ((2, 1, 1), (0, 1, 1))
    jout = jdense.dense_conv(jdense.DenseTensor(jx, jnp.asarray(mask)),
                             jnp.asarray(w), (3, 3, 3), stride, pad, subm)
    tout = tdense.dense_conv(
        tdense.DenseTensor(tx, torch.from_numpy(mask)), torch.from_numpy(w),
        (3, 3, 3), stride, pad, subm, compute_dtype=torch.bfloat16)
    np.testing.assert_array_equal(tout.mask.numpy(), np.asarray(jout.mask))
    assert tout.features.dtype == tdt
    assert str(jout.features.dtype) == dtype
    if dtype == "bfloat16":
        d = _ulps(tout.features, jout.features)
        assert d.max() <= 1 and (d > 0).mean() < 0.01
    else:  # f32 output of the same bf16 products: f32 summation order
        np.testing.assert_allclose(tout.features.numpy(),
                                   np.asarray(jout.features),
                                   atol=1e-5, rtol=1e-5)
    # the "exact" conv on the same input differs: the rounding is real
    exact = tdense.dense_conv(
        tdense.DenseTensor(tx.float(), torch.from_numpy(mask)),
        torch.from_numpy(w), (3, 3, 3), stride, pad, subm)
    assert not torch.equal(exact.features, tout.features.float())


def test_masked_batchnorm_eval_bf16():
    """In eval on a bf16 input the norm stays bf16, as flax's casts of its
    statistics to x's dtype keep it; torch would promote to f32."""
    rng = np.random.RandomState(6)
    c = 32
    x = (3 * rng.randn(2, 40, c)).astype(np.float32)
    mask = rng.rand(2, 40) < 0.7
    stats = dict(mean=0.1 * rng.randn(c), var=0.5 + rng.rand(c))
    params = dict(scale=1 + 0.1 * rng.randn(c), bias=0.1 * rng.randn(c))
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    params = {k: v.astype(np.float32) for k, v in params.items()}
    tx = torch.from_numpy(x).bfloat16()
    jy = jlayers.MaskedBatchNorm().apply(
        {"params": params, "batch_stats": stats}, _bf16(tx),
        jnp.asarray(mask), False)
    bn = MaskedBatchNorm(c).eval()
    with torch.no_grad():
        bn.weight.copy_(torch.from_numpy(params["scale"]))
        bn.bias.copy_(torch.from_numpy(params["bias"]))
        bn.running_mean.copy_(torch.from_numpy(stats["mean"]))
        bn.running_var.copy_(torch.from_numpy(stats["var"]))
        ty = bn(tx, torch.from_numpy(mask))
    assert ty.dtype == torch.bfloat16 and str(jy.dtype) == "bfloat16"
    # both round after each of the three ops here (eager JAX; measured:
    # equal bit for bit); a fused XLA chain may round once instead
    d = _ulps(ty, jy)
    assert d.max() <= 1 and (d > 0).mean() < 0.01, (d.max(), (d > 0).mean())
    assert (ty[~torch.from_numpy(mask)] == 0).all()
