"""df3d_torch.ops.sparse against df3d.ops.sparse: conv plans bit for bit,
the plain version of the K1 conv body against the XLA conv and the Pallas
kernel (interpret mode) on the same inputs, and the K1 kernel's schedule
(hit rows compacted per tile and tap, emulated in torch) against all
three."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d.ops import sparse as jsp
from df3d.ops.pallas.sparse_conv_kernel import apply_sparse_conv_pallas_v2
from df3d_torch.ops import sparse as tsp
from df3d_torch.ops import sparse_conv_kernel as k1
from torch_port_helpers import k1_emulate, sparse_inputs
from torch_port_helpers import one_torch_thread  # noqa: F401

# (name, spatial shape, valid rows, padded rows, plan kind and geometry)
PLAN_CASES = [
    ("subm_k3", (8, 12, 12), 64, 96, ("subm", 3)),
    ("subm_unsorted_rows", (8, 12, 12), 64, 96, ("subm", 3)),
    ("k3_s2_p1", (8, 12, 12), 80, 96, ("conv", 3, 2, 1, 160)),
    ("k3_s2_p011", (11, 12, 12), 80, 96, ("conv", 3, 2, (0, 1, 1), 160)),
    ("k311_s211_p0", (7, 8, 8), 48, 64,
     ("conv", (3, 1, 1), (2, 1, 1), (0, 0, 0), 64)),
    ("cap_truncation", (8, 12, 12), 80, 96, ("conv", 3, 2, 1, 16)),
]


def _pair(feats, coords, shape, rows_sorted=True):
    jst = jsp.SparseTensor(jnp.asarray(feats), jnp.asarray(coords), shape,
                           rows_sorted=rows_sorted)
    tst = tsp.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords),
                           shape)
    return jst, tst


# the JAX sides as jitted programs, shared by the cases that reuse their
# static arguments and shapes (op by op each plan compiled ~90 small ones)
_jsubm_plan = jax.jit(jsp.build_subm_plan, static_argnums=1)
_jconv_plan = jax.jit(jsp.build_conv_plan, static_argnums=(1, 2, 3, 4))
_jconv = jax.jit(jsp.apply_sparse_conv)
_jpallas = jax.jit(lambda f, idx, w: apply_sparse_conv_pallas_v2(
    f, idx, w, interpret=True))


def _plans(case, rng):
    name, shape, n, pad_to, geom = case
    feats, coords = sparse_inputs(rng, batch=2, shape=shape, n=n, cin=5,
                                  pad_to=pad_to)
    rows_sorted = name != "subm_unsorted_rows"
    if not rows_sorted:  # valid and padding rows interleaved at random
        for b in range(feats.shape[0]):
            perm = rng.permutation(pad_to)
            feats[b], coords[b] = feats[b][perm], coords[b][perm]
    jst, tst = _pair(feats, coords, shape, rows_sorted)
    if geom[0] == "subm":
        return jst, tst, _jsubm_plan(jst, geom[1]), \
            tsp.build_subm_plan(tst, geom[1])
    _, k, s, p, max_out = geom
    return jst, tst, _jconv_plan(jst, k, s, p, max_out), \
        tsp.build_conv_plan(tst, k, s, p, max_out)


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_plan_matches_jax_bit_for_bit(case):
    _, _, jplan, tplan = _plans(case, np.random.RandomState(7))
    np.testing.assert_array_equal(tplan.gather_idx.numpy(),
                                  np.asarray(jplan.gather_idx))
    np.testing.assert_array_equal(tplan.out_coords.numpy(),
                                  np.asarray(jplan.out_coords))
    assert tplan.gather_idx.dtype == torch.int32
    assert tplan.out_coords.dtype == torch.int32
    assert tplan.out_spatial_shape == tuple(jplan.out_spatial_shape)
    assert tplan.kernel_size == tuple(jplan.kernel_size)
    if jplan.true_occ is None:
        assert tplan.true_occ is None
    else:
        np.testing.assert_array_equal(tplan.true_occ.numpy(),
                                      np.asarray(jplan.true_occ))
    if case[0] == "cap_truncation":
        assert (tplan.true_occ.numpy() > tplan.num_out_rows).all()


# (name, plan case, Cin, Cout); the Pallas kernel needs N_out <= N_in + 1
CONV_CASES = [
    ("subm_cin5", PLAN_CASES[0], 5, 16),
    ("strided_cin5", ("", (8, 12, 12), 80, 96, ("conv", 3, 2, 1, 64)), 5, 12),
    ("strided_p011",
     ("", (11, 12, 12), 80, 96, ("conv", 3, 2, (0, 1, 1), 48)), 5, 8),
]


@pytest.mark.parametrize("case", CONV_CASES, ids=[c[0] for c in CONV_CASES])
def test_plain_conv_matches_xla_and_pallas(case):
    """sparse_conv_plain (the CPU branch of apply_sparse_conv) against the
    JAX XLA conv body and the Pallas kernel in interpret mode; atol = rtol =
    1e-5 (f32, different summation order)."""
    _, plan_case, cin, cout = case
    rng = np.random.RandomState(11)
    jst, tst, jplan, tplan = _plans(plan_case, rng)
    assert jst.features.shape[-1] == cin
    w = (rng.randn(tplan.num_taps, cin, cout) * 0.3).astype(np.float32)
    got = tsp.apply_sparse_conv(tst.features, tplan, torch.from_numpy(w))
    want_xla = np.asarray(_jconv(jst.features, jplan, jnp.asarray(w)))
    want_pallas = np.asarray(_jpallas(jst.features, jplan.gather_idx,
                                      jnp.asarray(w)))
    assert got.shape == want_xla.shape
    np.testing.assert_allclose(got.numpy(), want_xla, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_pallas, atol=1e-5,
                               rtol=1e-5)


# output rows per block of the K1 kernel: 128 for 16-channel launches,
# else 64
K1_TILE_ROWS = (64, 128)


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_k1_schedule_covers_each_hit_once(case):
    """The kernel's compaction adds every hit (row, tap) of the plan in
    exactly once and nothing else, for both tile heights, on every plan
    kind: subm, strided, (3, 1, 1), cap truncation, B = 2, padding rows
    interleaved."""
    _, tst, _, tplan = _plans(case, np.random.RandomState(7))
    k, n_in = tplan.num_taps, tst.num_rows
    hits = ((tplan.gather_idx >= 0) & (tplan.gather_idx < n_in)).view(
        tst.batch_size, k, -1).long()
    assert hits.sum() > 0
    w = torch.zeros(k, tst.features.shape[-1], 1)
    for rows in K1_TILE_ROWS:
        _, executed = k1_emulate(tst.features, tplan.gather_idx, w, rows)
        assert torch.equal(executed, hits)


@pytest.mark.parametrize("case", PLAN_CASES, ids=[c[0] for c in PLAN_CASES])
def test_k1_schedule_matches_plain_xla_and_pallas(case):
    """The kernel's order of work (compacted chunks of 8 hit rows, taps in
    order, a per-tile accumulator), emulated in torch, against
    sparse_conv_plain to atol = rtol = 1e-6 (f32, other summation order),
    and against the JAX XLA conv body and the Pallas kernel (interpret
    mode) to atol = rtol = 1e-5. The Pallas kernel needs N_out <= N_in + 1,
    so its table is padded with zero rows, which the plan never reads."""
    rng = np.random.RandomState(13)
    jst, tst, jplan, tplan = _plans(case, rng)
    cin, cout = tst.features.shape[-1], 12
    w = (rng.randn(tplan.num_taps, cin, cout) * 0.3).astype(np.float32)
    wt = torch.from_numpy(w)
    plain = k1.sparse_conv_plain(tst.features, tplan.gather_idx, wt)
    want_xla = np.asarray(_jconv(jst.features, jplan, jnp.asarray(w)))
    short = tplan.num_out_rows - 1 - tst.num_rows
    table = jnp.pad(jst.features, ((0, 0), (0, max(short, 0)), (0, 0)))
    want_pallas = np.asarray(_jpallas(table, jplan.gather_idx,
                                      jnp.asarray(w)))
    for rows in K1_TILE_ROWS:
        got, _ = k1_emulate(tst.features, tplan.gather_idx, wt, rows)
        np.testing.assert_allclose(got.numpy(), plain.numpy(), atol=1e-6,
                                   rtol=1e-6)
        np.testing.assert_allclose(got.numpy(), want_xla, atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(got.numpy(), want_pallas, atol=1e-5,
                                   rtol=1e-5)


# (Cin, Cout) -> (KP, N, column blocks): the main path's four bf16 shapes,
# phase 37's edge cases' odd widths, and Cout past one column block
BF16_WIDTH_CASES = [((32, 32), (32, 32, 1)), ((32, 64), (32, 64, 1)),
                    ((64, 64), (64, 64, 1)), ((64, 128), (64, 128, 1)),
                    ((5, 6), (16, 16, 1)), ((12, 8), (16, 16, 1)),
                    ((72, 128), (128, 128, 1)), ((128, 16), (128, 16, 1)),
                    ((96, 300), (128, 128, 3))]


@pytest.mark.parametrize("case", BF16_WIDTH_CASES, ids=str)
def test_k1_bf16_widths(case):
    """Which instantiation of the bf16 kernel a conv takes, and the size
    of W's images the wrapper allocates for it."""
    (cin, cout), want = case
    assert k1.bf16_widths(cin, cout) == want
    kp, n, blocks = want
    assert k1.bf16_image_elems(27, cin, cout) == 27 * blocks * kp * n


def test_k1_bf16_widths_refuse():
    for cin, cout in ((0, 16), (129, 16), (32, 0)):
        with pytest.raises(ValueError):
            k1.bf16_widths(cin, cout)


def test_k1_bf16_w_images_layout():
    """W's images as the kernel's `w_images` writes them (image index
    ((n8 * KP/8 + kc) * 8 + nr) * 8 + kr for each tap and column block),
    read back as wgmma reads its B operand without swizzle: core matrices
    of 8 output channels x 8 input channels (16 bytes a channel), the next
    one along K 128 bytes on, the next 8 channels KP/8 x 128 bytes on. It
    must give W[t][:, block] transposed, zero past Cin and Cout."""
    rng = np.random.RandomState(3)
    k, cin, cout = 3, 12, 150
    w = torch.from_numpy(rng.randn(k, cin, cout).astype(np.float32))
    kp, n, blocks = k1.bf16_widths(cin, cout)
    e = torch.arange(k1.bf16_image_elems(k, cin, cout))
    per, kc_n = kp * n, kp // 8
    t, nb, i = e // (blocks * per), e // per % blocks, e % per
    kr, nr, kc, n8 = i % 8, i // 8 % 8, i // 64 % kc_n, i // 64 // kc_n
    kk, col = kc * 8 + kr, nb * n + n8 * 8 + nr
    ok = (kk < cin) & (col < cout)
    images = torch.where(ok, w[t, kk.clamp(max=cin - 1),
                               col.clamp(max=cout - 1)], 0.0)
    for tap in range(k):
        for blk in range(blocks):
            img = images[(tap * blocks + blk) * per:][:per]
            # byte offset (n8 * kc_n + kc) * 128 + nr * 16 + kr * 2
            got = img.view(n // 8, kc_n, 8, 8).permute(0, 2, 1, 3).reshape(
                n, kp)
            want = torch.zeros(n, kp)
            cols = w[tap, :, blk * n:(blk + 1) * n].t()
            want[:cols.shape[0], :cin] = cols
            assert torch.equal(got, want)
