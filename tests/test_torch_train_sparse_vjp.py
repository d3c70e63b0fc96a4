"""The gradients of df3d_torch.ops.sparse.apply_sparse_conv against jax.vjp
of df3d.ops.sparse.apply_sparse_conv (the symmetric-plan custom VJP for
submanifold plans, XLA autodiff for strided ones), on the CPU, where the
autograd Function takes the card's routes with the plain version in place
of K1: flipped, transposed taps over the same plan (subm), the transposed
plan (strided), and a gather + one matrix product for dW.

Inputs: padding rows with non-zero features (the plans never gather them),
row orders with padding interleaved, a strided plan whose cap drops output
rows, and dy on every output row. Tolerance (f32, other summation order):
max|port - jax| <= 1e-5 * max|jax| + 1e-6 for dx and dW."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d.ops import sparse as jsp
from df3d_torch.ops import sparse as tsp
from df3d_torch.ops import sparse_conv_kernel as k1
from torch_port_helpers import sparse_inputs
from torch_port_helpers import one_torch_thread  # noqa: F401

# (name, spatial shape, valid rows, padded rows, plan geometry, Cin, Cout)
CASES = [
    ("subm", (8, 12, 12), 64, 96, ("subm", 3), 16, 16),
    ("subm_unsorted_rows", (8, 12, 12), 64, 96, ("subm", 3), 5, 16),
    ("k3_s2_p1", (8, 12, 12), 80, 96, ("conv", 3, 2, 1, 160), 16, 32),
    ("k3_s2_p011", (11, 12, 12), 80, 96, ("conv", 3, 2, (0, 1, 1), 160),
     32, 12),
    ("k311_s211", (7, 8, 8), 48, 64,
     ("conv", (3, 1, 1), (2, 1, 1), (0, 0, 0), 64), 8, 8),
    ("cap_drops_rows", (8, 12, 12), 80, 96, ("conv", 3, 2, 1, 16), 16, 24),
]


def _case(case, seed=5):
    name, shape, n, pad_to, geom, cin, cout = case
    rng = np.random.RandomState(seed)
    feats, coords = sparse_inputs(rng, batch=2, shape=shape, n=n, cin=cin,
                                  pad_to=pad_to)
    feats[coords[..., 0] < 0] = rng.randn(2 * (pad_to - n), cin)  # unused
    rows_sorted = name != "subm_unsorted_rows"
    if not rows_sorted:
        for b in range(2):
            perm = rng.permutation(pad_to)
            feats[b], coords[b] = feats[b][perm], coords[b][perm]
    tst = tsp.SparseTensor(torch.from_numpy(feats), torch.from_numpy(coords),
                           shape)
    if geom[0] == "subm":
        tplan = tsp.build_subm_plan(tst, 3)
    else:
        tplan = tsp.build_conv_plan(tst, *geom[1:])
    w = (rng.randn(tplan.num_taps, cin, cout) * 0.2).astype(np.float32)
    dy = rng.randn(2, tplan.num_out_rows, cout).astype(np.float32)
    return feats, coords, w, dy, tplan


def _jax_vjp(case, feats, coords, w, dy):
    """The JAX plan, conv and vjp under one jit -> (gather_idx, y, dx,
    dW)."""
    name, shape, *_, geom, _, _ = case

    @jax.jit
    def run(f, c, ww, g):
        st = jsp.SparseTensor(f, c, shape,
                              rows_sorted=name != "subm_unsorted_rows")
        plan = (jsp.build_subm_plan(st, 3) if geom[0] == "subm"
                else jsp.build_conv_plan(st, *geom[1:]))
        y, vjp = jax.vjp(lambda a, b: jsp.apply_sparse_conv(a, plan, b),
                         f, ww)
        return (plan.gather_idx, y, *vjp(g))

    return run(*map(jnp.asarray, (feats, coords, w, dy)))


def _close(got, want):
    want = np.asarray(want)
    tol = 1e-5 * np.abs(want).max() + 1e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_dx_dw_match_jax_vjp(case):
    feats, coords, w, dy, tplan = _case(case)
    jidx, out, jdx, jdw = _jax_vjp(case, feats, coords, w, dy)
    np.testing.assert_array_equal(tplan.gather_idx.numpy(), np.asarray(jidx))

    f = torch.from_numpy(feats).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    before = k1.launches, k1.bwd_launches
    y = tsp.apply_sparse_conv(f, tplan, tw)
    _close(y.detach().numpy(), out)
    y.backward(torch.from_numpy(dy))
    assert (k1.launches, k1.bwd_launches) == before  # the CPU takes plain
    _close(f.grad.numpy(), jdx)
    _close(tw.grad.numpy(), jdw)
    pad = tplan.out_coords[..., 0] < 0 if tplan.symmetric else None
    if pad is not None:  # padding rows get no gradient
        assert not f.grad[pad].any()
    if case[0] == "cap_drops_rows":
        assert (tplan.true_occ > tplan.num_out_rows).all()


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_backward_routes(case, monkeypatch):
    """The backward's conv body gets the same plan with W[K-1-t]^T (subm)
    or the transposed plan with W[t]^T (strided), as contiguous inputs
    (the kernel refuses others), and only when features need a gradient."""
    feats, _, w, dy, tplan = _case(case)
    calls = []
    plain = k1.sparse_conv_plain

    def recording(x, idx, ww):
        calls.append((x, idx, ww))
        return plain(x, idx, ww)

    monkeypatch.setattr(k1, "sparse_conv_plain", recording)
    f = torch.from_numpy(feats).requires_grad_(True)
    tw = torch.from_numpy(w).requires_grad_(True)
    dy_t = torch.from_numpy(dy).transpose(1, 2).contiguous().transpose(1, 2)
    tsp.apply_sparse_conv(f, tplan, tw).backward(dy_t)  # dy not contiguous
    assert len(calls) == 2
    x, idx, ww = calls[1]
    assert x.is_contiguous() and ww.is_contiguous() and idx.is_contiguous()
    torch.testing.assert_close(x, torch.from_numpy(dy), rtol=0, atol=0)
    if tplan.symmetric:
        assert idx is tplan.gather_idx
        torch.testing.assert_close(ww, tw.detach().flip(0).transpose(1, 2))
    else:
        assert idx is tplan.transposed(feats.shape[1])
        torch.testing.assert_close(ww, tw.detach().transpose(1, 2))

    calls.clear()
    f.requires_grad_(False)
    tsp.apply_sparse_conv(f, tplan, tw).backward(torch.from_numpy(dy))
    assert len(calls) == 1  # no dx launch for an input without a gradient


@pytest.mark.parametrize("case", CASES[:2], ids=[c[0] for c in CASES[:2]])
def test_subm_plan_is_symmetric(case):
    """Site i is site j's neighbour at tap t exactly when j is i's at tap
    K-1-t; padding rows gather nothing and are gathered by nobody."""
    *_, tplan = _case(case)
    b, k = tplan.gather_idx.shape[0], tplan.num_taps
    n = tplan.num_out_rows
    idx = tplan.gather_idx.view(b, k, n).long()
    hit = idx < n
    assert hit.any()
    bb, tt, ii = torch.nonzero(hit, as_tuple=True)
    back = idx[bb, k - 1 - tt, idx[bb, tt, ii]]
    assert torch.equal(back, ii)
    pad = tplan.out_coords[..., 0] < 0
    assert pad.any()
    for s in range(b):
        assert not hit[s][:, pad[s]].any()
        assert not torch.isin(idx[s][hit[s]], torch.nonzero(pad[s])[:, 0]).any()


def test_transposed_plan():
    """For each input row and tap, the output row that gathers it, or
    N_out; a plan that gathers one row twice at a tap is refused."""
    *_, tplan = _case(CASES[5])
    n_in = 96
    b, k, n_out = 2, tplan.num_taps, tplan.num_out_rows
    inv = tplan.transposed(n_in).view(b, k, n_in).long()
    idx = tplan.gather_idx.view(b, k, n_out).long()
    want = torch.full((b, k, n_in), n_out, dtype=torch.long)
    for s in range(b):
        for t in range(k):
            for r in range(n_out):
                if idx[s, t, r] < n_in:
                    want[s, t, idx[s, t, r]] = r
    assert torch.equal(inv, want)
    assert tplan.transposed(n_in) is tplan.transposed(n_in)  # cached

    bad = tsp.ConvPlan(torch.zeros(1, 27 * 2, dtype=torch.int32),
                       torch.zeros(1, 2, 3, dtype=torch.int32), (1, 2, 2),
                       (3, 3, 3), true_occ=torch.tensor([2]))
    with pytest.raises(ValueError, match="twice"):
        bad.transposed(4)


def test_dense_tail_gradients():
    """densify -> subm dense conv -> strided dense conv -> sparsify (capped
    below the active count) and bev_from_dense: the gradients of the
    features and both weights against jax.vjp, same tolerance."""
    from df3d.ops import dense3d as jdense
    from df3d_torch.ops import dense3d as tdense

    rng = np.random.RandomState(8)
    shape = (5, 6, 7)
    feats, coords = sparse_inputs(rng, batch=2, shape=shape, n=40, cin=6,
                                  pad_to=48)
    w1 = (rng.randn(27, 6, 8) * 0.2).astype(np.float32)
    w2 = (rng.randn(3, 8, 4) * 0.2).astype(np.float32)
    g_rows = rng.randn(2, 30, 4).astype(np.float32)
    g_bev = rng.randn(2, 6, 7, 2 * 4).astype(np.float32)

    def run(mod, sparse_mod, f, a, b):
        st = sparse_mod.SparseTensor(f, c, shape)
        dt = mod.dense_conv(mod.densify(st), a, 3, 1, 1, subm=True)
        dt = mod.dense_conv(dt, b, (3, 1, 1), (2, 1, 1), 0, subm=False)
        rows = mod.sparsify(dt, 30)
        return rows.features, mod.bev_from_dense(dt), dt.mask.sum()

    @jax.jit
    def jax_run(f, a, b, gr, gb):
        (rows, bev, _), vjp = jax.vjp(
            lambda *x: run(jdense, jsp, *x), f, a, b)
        return (rows, bev, *vjp((gr, gb, np.zeros((), np.int32))))

    c = jnp.asarray(coords)
    jrows, jbev, *want = jax_run(*map(jnp.asarray,
                                      (feats, w1, w2, g_rows, g_bev)))
    c = torch.from_numpy(coords)
    args = [torch.from_numpy(a).requires_grad_(True) for a in (feats, w1, w2)]
    rows, bev, active = run(tdense, tsp, *args)
    assert active > 30  # sparsify drops rows
    _close(rows.detach().numpy(), jrows)
    _close(bev.detach().numpy(), jbev)
    torch.autograd.backward((rows, bev), (torch.from_numpy(g_rows),
                                          torch.from_numpy(g_bev)))
    for got, ref in zip(args, want):
        _close(got.grad.numpy(), ref)


@pytest.mark.parametrize("pad", [1, (0, 1, 1)], ids=["p1", "p011"])
def test_sparse_encoder_tail_gradients(pad):
    """SparseEncoder's tail in training, as it runs at pad 1 (its first
    two downsamples) and (0, 1, 1) (the last): a strided sparse conv (K1's
    transposed plan in the backward) -> densify -> a dense subm conv ->
    `conv_out`, the dense (3, 1, 1) / (2, 1, 1) conv -> the BEV map. The
    gradients of the features and the three weights against jax.vjp, same
    tolerance; on the CPU no K1 launch."""
    from df3d.ops import dense3d as jdense
    from df3d_torch.ops import dense3d as tdense

    rng = np.random.RandomState(9)
    shape = (11, 10, 10)
    feats, coords = sparse_inputs(rng, batch=2, shape=shape, n=70, cin=8,
                                  pad_to=80)
    w_down = (rng.randn(27, 8, 12) * 0.2).astype(np.float32)
    w_subm = (rng.randn(27, 12, 12) * 0.2).astype(np.float32)
    w_out = (rng.randn(3, 12, 6) * 0.2).astype(np.float32)
    out_z = (11 + 2 * (pad if pad == 1 else 0) - 3) // 2 + 1
    g_bev = rng.randn(2, 5, 5, ((out_z - 3) // 2 + 1) * 6).astype(np.float32)

    def run(mod, sparse_mod, f, c, a, b, o):
        st = sparse_mod.SparseTensor(f, c, shape)
        plan = sparse_mod.build_conv_plan(st, 3, 2, pad, max_out=160)
        down = sparse_mod.SparseTensor(
            sparse_mod.apply_sparse_conv(f, plan, a), plan.out_coords,
            plan.out_spatial_shape)
        dt = mod.dense_conv(mod.densify(down), b, 3, 1, 1, subm=True)
        dt = mod.dense_conv(dt, o, (3, 1, 1), (2, 1, 1), 0, subm=False)
        return mod.bev_from_dense(dt), plan

    @jax.jit
    def jax_run(f, c, a, b, o, g):
        bev, vjp = jax.vjp(lambda *x: run(jdense, jsp, x[0], c, *x[1:])[0],
                           f, a, b, o)
        return (bev, *vjp(g))

    jbev, *want = jax_run(*map(jnp.asarray, (feats, coords, w_down, w_subm,
                                             w_out, g_bev)))
    args = [torch.from_numpy(a).requires_grad_(True)
            for a in (feats, w_down, w_subm, w_out)]
    before = k1.launches, k1.bwd_launches
    bev, plan = run(tdense, tsp, args[0], torch.from_numpy(coords), *args[1:])
    assert not plan.symmetric and (plan.true_occ <= 160).all()
    _close(bev.detach().numpy(), jbev)
    bev.backward(torch.from_numpy(g_bev))
    assert (k1.launches, k1.bwd_launches) == before
    for got, ref in zip(args, want):
        _close(got.grad.numpy(), ref)
        assert np.abs(np.asarray(ref)).max() > 0
