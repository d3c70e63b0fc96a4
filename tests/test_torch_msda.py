"""df3d_torch's deformable-attention sampling (K2's plain version) and
MSDeformAttnModule against df3d's, with the same seeded inputs and flax
weights carried across by df3d_torch.weights.

Tolerances: the sampling core matches the XLA formulation and the Pallas
kernel (interpret mode) to atol 2e-5, the bound tests/test_msda_pallas.py
holds those two to (f32, other summation order); the module, whose
projections add two f32 matmuls, to atol 1e-4."""

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
from torch_port_helpers import load_flax, seeded_variables

SHAPES = ((6, 9), (3, 5))


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
