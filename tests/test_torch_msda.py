"""df3d_torch's deformable-attention sampling (K2's plain version) and
MSDeformAttnModule against df3d's, with the same seeded inputs and flax
weights carried across by df3d_torch.weights.

Tolerances: the sampling core matches the XLA formulation and the Pallas
kernel (interpret mode) to atol 2e-5, the bound tests/test_msda_pallas.py
holds those two to (f32, other summation order); the module, whose
projections add two f32 matmuls, to atol 1e-4. The K2 kernel's warp-path
schedule, emulated in torch (tests/torch_port_helpers.py), matches the
plain version to atol 1e-6 (the same f32 products, another summation
order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d.models.fusion.msda_module import (
    MSDeformAttnModule as JMSDeformAttnModule,
)
from df3d.models.fusion.msda_module import _offset_bias_init
from df3d.ops.msda import level_start_index as jlevel_start_index
from df3d.ops.msda import ms_deform_attn as jms_deform_attn
from df3d.ops.pallas.msda_kernel import ms_deform_attn_pallas
from df3d_torch.models.fusion.msda_module import (
    MSDeformAttnModule, offset_bias_grid,
)
from df3d_torch.ops import msda as tmsda
from df3d_torch.ops import msda_kernel as k2
from torch_port_helpers import (
    k2_bwd_dvalue_by_rows, k2_emulate, k2_schedule, load_flax,
    seeded_variables,
)
from torch_port_helpers import one_torch_thread  # noqa: F401

SHAPES = ((6, 9), (3, 5))
# the preset's head, level and point counts (8, 3, 4; D 16) on small maps
PRESET = dict(nh=8, d=16, p=4, shapes=((6, 9), (3, 5), (4, 7)))
OFF_MAP_QUERY = 9


def _inputs(seed, q=10):
    """tests/test_msda_pallas.py's inputs: Q = 10, not a multiple of the
    Pallas tile, and locations in [-0.2, 1.2]."""
    rng = np.random.RandomState(seed)
    b, nh, d, p = 2, 2, 8, 4
    lv = sum(h * w for h, w in SHAPES)
    value = rng.randn(b, lv, nh, d).astype(np.float32)
    locs = rng.uniform(-0.2, 1.2, (b, q, nh, len(SHAPES), p, 2)).astype(
        np.float32)
    w = rng.rand(b, q, nh, len(SHAPES), p).astype(np.float32)
    w /= w.reshape(b, q, nh, -1).sum(-1).reshape(b, q, nh, 1, 1)
    return value, locs, w


def _preset_inputs(seed, b=2, q=11, shapes=PRESET["shapes"]):
    """Seeded inputs at the preset's counts: locations in [-0.2, 1.2],
    weights normalised per (query, head); at every level point 0 of query
    0 on the last pixel centre, of query 1 at -0.5 px and of query 2 far
    off the map; query 9 wholly off the map (the warp path's early
    exit)."""
    rng = np.random.RandomState(seed)
    nh, d, p = PRESET["nh"], PRESET["d"], PRESET["p"]
    lv = sum(h * w for h, w in shapes)
    value = rng.randn(b, lv, nh, d).astype(np.float32)
    locs = rng.uniform(-0.2, 1.2, (b, q, nh, len(shapes), p, 2)).astype(
        np.float32)
    for lid, (h, w) in enumerate(shapes):
        locs[:, 0, :, lid, 0] = [(w - 0.5) / w, (h - 0.5) / h]
    locs[:, 1, :, :, 0] = 0.0
    locs[:, 2, :, :, 0] = [-1e6, 1e7]
    locs[:, OFF_MAP_QUERY] = [-1e6, 1e7]
    w = rng.rand(b, q, nh, len(shapes), p).astype(np.float32)
    w /= w.reshape(b, q, nh, -1).sum(-1).reshape(b, q, nh, 1, 1)
    return value, shapes, locs, w


@pytest.mark.parametrize("seed", [3, 4])
def test_plain_matches_xla_and_pallas_preset_counts(seed):
    """At the counts the kernel's warp path takes, on the inputs on which
    chip_smoke.py holds the kernel against the plain version."""
    value, shapes, locs, w = _preset_inputs(seed)
    got = tmsda.ms_deform_attn(torch.from_numpy(value), shapes,
                               torch.from_numpy(locs), torch.from_numpy(w))
    jargs = (jnp.asarray(value), shapes, jnp.asarray(locs), jnp.asarray(w))
    want = np.asarray(jms_deform_attn(*jargs))
    pallas = np.asarray(ms_deform_attn_pallas(*jargs, q_tile=8,
                                              interpret=True))
    assert got.shape == want.shape == (2, 11, 128)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-5)
    assert not got[:, OFF_MAP_QUERY].any()


def test_k2_warp_schedule_covers_each_sample_once():
    """Every (head, level, point) of a query is computed by one lane, and
    every lane takes each sample of its own head once, in (level, point)
    order, from the lane that computed it at that slot."""
    nl, p = len(PRESET["shapes"]), PRESET["p"]
    computes, reads = k2_schedule(nl, p)
    flat = [s for lane in computes for s in lane]
    assert sorted(flat) == [(h, lvl, pt) for h in range(PRESET["nh"])
                            for lvl in range(nl) for pt in range(p)]
    for lane, order in enumerate(reads):
        got = [computes[src][slot] for src, slot in order]
        assert got == [(lane // p, lvl, pt) for lvl in range(nl)
                       for pt in range(p)]


@pytest.mark.parametrize("seed,b", [(5, 2), (6, 6)])
def test_k2_warp_emulation_matches_plain(seed, b):
    value, shapes, locs, w = (torch.from_numpy(a) if not isinstance(a, tuple)
                              else a for a in _preset_inputs(seed, b=b, q=19))
    got = k2_emulate(value, shapes, locs, w)
    want = tmsda.ms_deform_attn(value, shapes, locs, w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert not got[:, OFF_MAP_QUERY].any()
    assert got[:, 0].abs().max() > 0


@pytest.mark.parametrize("seed,b", [(7, 2), (8, 6)])
def test_k2_warp_emulation_one_level(seed, b):
    """The warp path's L = 1 instantiation (TransFusion + 3D-DF: one FPN
    level): every sample computed once, and the emulation against the
    plain version at 1e-6."""
    shapes = ((6, 9),)
    computes, reads = k2_schedule(1, PRESET["p"])
    assert sorted(s for lane in computes for s in lane) == [
        (h, 0, pt) for h in range(PRESET["nh"]) for pt in range(PRESET["p"])]
    for lane, order in enumerate(reads):
        assert [computes[src][slot] for src, slot in order] == [
            (lane // PRESET["p"], 0, pt) for pt in range(PRESET["p"])]
    value, _, locs, w = (torch.from_numpy(a) if not isinstance(a, tuple)
                         else a for a in _preset_inputs(seed, b, 19, shapes))
    got = k2_emulate(value, shapes, locs, w)
    want = tmsda.ms_deform_attn(value, shapes, locs, w)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert not got[:, OFF_MAP_QUERY].any()
    assert got[:, 0].abs().max() > 0


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_matches_xla_and_pallas(seed):
    value, locs, w = _inputs(seed)
    got = tmsda.ms_deform_attn(torch.from_numpy(value), SHAPES,
                               torch.from_numpy(locs), torch.from_numpy(w))
    jargs = (jnp.asarray(value), SHAPES, jnp.asarray(locs), jnp.asarray(w))
    want = np.asarray(jms_deform_attn(*jargs))
    pallas = np.asarray(ms_deform_attn_pallas(*jargs, q_tile=8,
                                              interpret=True))
    assert got.shape == want.shape == (2, 10, 16)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    np.testing.assert_allclose(got.numpy(), pallas, atol=2e-5)


def test_plain_edges():
    """Corners at exactly x = W-1 / y = H-1, at -0.5 px, and far off the
    map (a query no camera sees) against the XLA formulation."""
    value, _, w = _inputs(2, q=6)
    b, q, nh, nl, p = w.shape
    px = np.array([[0.0, 0.0], [1.0, 1.0], [-1e6, 3.0], [1e7, -1e7],
                   [0.5, 1.0], [1.0, 0.5]], np.float32)
    locs = np.broadcast_to(px[None, :, None, None, None, :],
                           (b, q, nh, nl, p, 2)).copy()
    for lid, (h, wd) in enumerate(SHAPES):
        # (x, y) = (W - 1, H - 1) + 0.5 px: the last pixel centre
        locs[:, 0, :, lid, 1] = [(wd - 0.5) / wd, (h - 0.5) / h]
    got = tmsda.ms_deform_attn(torch.from_numpy(value), SHAPES,
                               torch.from_numpy(locs), torch.from_numpy(w))
    want = np.asarray(jms_deform_attn(jnp.asarray(value), SHAPES,
                                       jnp.asarray(locs), jnp.asarray(w)))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5)
    assert np.abs(got.numpy()[:, 0]).max() > 0


def test_level_start_index():
    assert tmsda.level_start_index(SHAPES) == jlevel_start_index(SHAPES)


@pytest.mark.parametrize("q_method", [None, "gating"])
def test_msdeform_attn_module(q_method):
    rng = np.random.RandomState(5)
    b, q, c, nl = 2, 7, 16, len(SHAPES)
    lv = sum(h * w for h, w in SHAPES)
    query = rng.randn(b, q, c).astype(np.float32)
    i_query = rng.randn(b, q, c).astype(np.float32)
    ref = rng.uniform(0, 1, (b, q, nl, 2)).astype(np.float32)
    value = rng.randn(b, lv, c).astype(np.float32)
    jm = JMSDeformAttnModule(c, nl, n_heads=2, n_points=3, q_method=q_method)
    jargs = (jnp.asarray(query), jnp.asarray(ref), jnp.asarray(value),
             SHAPES, jnp.asarray(i_query))
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), *jargs))
    v = seeded_variables(shapes, np.random.RandomState(6))
    want = np.asarray(jm.apply(v, *jargs))

    tm = load_flax(MSDeformAttnModule(c, nl, n_heads=2, n_points=3,
                                      q_method=q_method), v)
    with torch.no_grad():
        got = tm(torch.from_numpy(query), torch.from_numpy(ref),
                 torch.from_numpy(value), SHAPES, torch.from_numpy(i_query))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)



def test_offset_bias_grid():
    want = _offset_bias_init(8, 3, 4)(jax.random.PRNGKey(0), (192,))
    np.testing.assert_allclose(offset_bias_grid(8, 3, 4).numpy(),
                               np.asarray(want), atol=1e-7)


def _hot_bwd_inputs(seed, b=2, q=40):
    """`_preset_inputs` with every level-0 sample of queries 10.. on one
    point (four rows of each head gather 4 (Q - 10) records), and g = 0 on
    query 5 and on head 3 of query 6."""
    value, shapes, locs, w = _preset_inputs(seed, b, q)
    h, wd = shapes[0]
    locs[:, 10:, :, 0] = [2.3 / wd, 3.6 / h]
    rng = np.random.RandomState(seed + 100)
    grad = rng.randn(b, q, PRESET["nh"] * PRESET["d"]).astype(np.float32)
    grad[:, 5] = 0.0
    grad[:, 6, 3 * PRESET["d"]:4 * PRESET["d"]] = 0.0
    return tuple(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                 for a in (value, shapes, locs, w, grad))


@pytest.mark.parametrize("seed", [11, 12])
def test_k2_bwd_row_sums_match_plain(seed):
    """K2's backward forms dvalue without float atomics: per-corner
    records grouped by dvalue row, each row's products summed exactly as
    scaled 64-bit integers (`k2_bwd_dvalue_by_rows`). That gives autograd
    of the plain version's dvalue (f32 sums in another order: atol 1e-5 of
    values ~1), a hot row of 120 records included."""
    value, shapes, locs, w, grad = _hot_bwd_inputs(seed)
    got, most = k2_bwd_dvalue_by_rows(value, shapes, locs, w, grad)
    want = k2.msda_bwd_plain(value, shapes, locs, w, grad)[0]
    assert most >= 4 * 30
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)


def test_k2_bwd_row_sums_do_not_depend_on_order():
    """Whatever order the integer atomics place a row's records in, the
    exact sum gives the same bits; and it stays within the f32 rounding of
    its products (atol 1e-6 of values ~1) of the plain version in f64."""
    args = _hot_bwd_inputs(13)
    runs = [k2_bwd_dvalue_by_rows(*args, torch.Generator().manual_seed(s))[0]
            for s in (0, 1)]
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], k2_bwd_dvalue_by_rows(*args)[0])
    value, shapes, locs, w, grad = args
    exact = k2.msda_bwd_plain(value.double(), shapes, locs.double(),
                              w.double(), grad.double())[0]
    np.testing.assert_allclose(runs[0].numpy(), exact.numpy(), rtol=0,
                               atol=1e-6)


# (B, LenV, Q, nH, L, P): the phase 18, 23 and 32 steps' launches (L 3,
# L 1, KITTI's D-8 general path) and a small one
SCRATCH_CASES = [(24, 33600, 30000, 8, 3, 4), (24, 22400, 30000, 8, 1, 4),
                 (2, 46080, 4000, 8, 3, 4), (2, 12, 3, 2, 2, 1)]


@pytest.mark.parametrize("case", SCRATCH_CASES, ids=str)
def test_k2_bwd_scratch_sizes(case):
    """The backward's scratch, sized from the shapes: a header, a counter
    per dvalue row, a live bit per (query, head) unit, a sum per scan tile,
    the live list and its units' largest |g|, and 4 records per sample
    (every query live at worst)."""
    b, len_v, q, nh, nl, npnt = case
    n_ints, n_recs = k2.bwd_scratch(b, len_v, q, nh, nl, npnt)
    rows, units = b * len_v * nh, b * q * nh
    assert n_recs == 4 * units * nl * npnt
    tiles = -(-rows // k2.BWD_SCAN_TILE)
    assert n_ints == k2.BWD_HEADER + rows + -(-units // 32) + tiles + 2 * units
    # ~2.3 GB at the L 3 step, the largest: the records
    assert 4 * n_ints + 8 * n_recs < 2.5e9


def test_k2_bwd_scratch_refuses_int_overflow():
    """Rows and records are ints in the kernel: larger shapes are refused
    before any allocation."""
    with pytest.raises(ValueError, match="fit an int"):
        k2.bwd_scratch(64, 33600, 120000, 8, 3, 4)
    with pytest.raises(ValueError, match="fit an int"):
        k2.bwd_scratch(2**16, 2**12, 1, 8, 1, 1)
