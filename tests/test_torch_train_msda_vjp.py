"""K2's backward on the CPU: df3d_torch's `msda_bwd_plain` (torch autograd
of the plain sampling) and autograd through `ops.msda.ms_deform_attn` on
CPU tensors against `jax.vjp` of df3d.ops.msda.ms_deform_attn and `jax.grad`
of `ms_deform_attn_pallas(..., interpret=True)` (whose VJP is the XLA
formulation's), with the same seeded numpy inputs and cotangent; the
arithmetic of the CUDA backward kernels (tests/torch_port_helpers.py
`k2_bwd_emulate`) against the plain version; the `torch.autograd.Function`
CUDA tensors take (`ops.msda._MSDA`), with stand-ins for the launchers;
MSDeformAttnModule's parameter and input gradients against flax's.

Inputs: L = 1 and L = 3, samples on the last pixel centre, at -0.5 px
(the top-left corners off the map), half off the map and far off it, at
exact integer pixel positions (loc = (k + 0.5) / size on power-of-two
sizes, so that loc * size - 0.5 is exact in f32 and every formulation
takes the same corners, where the bilinear derivative jumps), and masked
(zero) attention weights.

Tolerances (f32, other summation order), per gradient: atol = 1e-5 *
max|ref| + 1e-6 for dvalue, dloc and dattn against JAX and for the kernel
arithmetic against the plain version; the module's gradients, through two
more f32 matmuls and a softmax, 1e-4 * max|ref| + 1e-6."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from df3d.models.fusion.msda_module import (
    MSDeformAttnModule as JMSDeformAttnModule,
)
from df3d.ops.msda import ms_deform_attn as jms_deform_attn
from df3d.ops.pallas.msda_kernel import ms_deform_attn_pallas
from df3d_torch.models.fusion.msda_module import MSDeformAttnModule
from df3d_torch.ops import msda as tmsda
from df3d_torch.ops import msda_kernel as K2
from df3d_torch.weights import params_from_flax, state_dict_from_flax
from torch_port_helpers import k2_bwd_emulate, seeded_variables
from torch_port_helpers import one_torch_thread  # noqa: F401

# power-of-two widths and heights: exact integer pixel positions
LEVELS_3 = ((8, 16), (4, 8), (2, 4))
LEVELS_1 = ((8, 16),)
OFF_MAP_QUERY, MASKED_QUERY = 5, 6


def _inputs(seed, shapes, b=2, q=9, nh=2, d=8, p=4):
    """Seeded value, locations in [-0.2, 1.2], weights normalised per
    (query, head), cotangent; and at every level: point 0 of query 0 on
    the last pixel centre, of query 1 at -0.5 px, of query 2 at x = -0.3
    (one column of corners off the map), of query 3 far off the map; every
    point of query 4 on an exact integer pixel position; query 5 wholly off
    the map; query 6 with zero weights."""
    rng = np.random.RandomState(seed)
    nl = len(shapes)
    len_v = sum(h * w for h, w in shapes)
    value = rng.randn(b, len_v, nh, d).astype(np.float32)
    locs = rng.uniform(-0.2, 1.2, (b, q, nh, nl, p, 2)).astype(np.float32)
    for lid, (h, w) in enumerate(shapes):
        locs[:, 0, :, lid, 0] = [(w - 0.5) / w, (h - 0.5) / h]
        kx = rng.randint(-1, w + 1, (b, nh, p))
        ky = rng.randint(-1, h + 1, (b, nh, p))
        locs[:, 4, :, lid, :, 0] = (kx + 0.5) / w
        locs[:, 4, :, lid, :, 1] = (ky + 0.5) / h
    locs[:, 1, :, :, 0] = 0.0
    locs[:, 2, :, :, 0, 0] = -0.3 / np.array([w for _, w in shapes])
    locs[:, 3, :, :, 0] = [-1e6, 1e7]
    locs[:, OFF_MAP_QUERY] = [-1e6, 1e7]
    attn = rng.rand(b, q, nh, nl, p).astype(np.float32)
    attn /= attn.reshape(b, q, nh, -1).sum(-1).reshape(b, q, nh, 1, 1)
    attn[:, MASKED_QUERY] = 0.0
    grad = rng.randn(b, q, nh * d).astype(np.float32)
    return value, shapes, locs, attn, grad


def _tol(ref):
    return 1e-5 * np.abs(ref).max() + 1e-6


@functools.partial(jax.jit, static_argnums=1)
def _jvjp(v, shapes, l, a, g):
    """One program a level layout (op by op it compiled ~230 small ones a
    case)."""
    _, pull = jax.vjp(lambda v, l, a: jms_deform_attn(v, shapes, l, a),
                      v, l, a)
    return pull(g)


def _jax_vjp(value, shapes, locs, attn, grad):
    return [np.asarray(t) for t in _jvjp(jnp.asarray(value), shapes,
                                         jnp.asarray(locs), jnp.asarray(attn),
                                         jnp.asarray(grad))]


@functools.partial(jax.jit, static_argnums=1)
def _pallas_grad(v, shapes, l, a, g):
    return jax.grad(lambda v, l, a: (ms_deform_attn_pallas(
        v, shapes, l, a, 4, True) * g).sum(), argnums=(0, 1, 2))(v, l, a)


CASES = [pytest.param(s, shapes, id=f"L{len(shapes)}_seed{s}")
         for s, shapes in ((0, LEVELS_3), (1, LEVELS_1), (2, LEVELS_3))]


@pytest.mark.parametrize("seed,shapes", CASES)
def test_bwd_plain_matches_jax_vjp(seed, shapes):
    value, shapes, locs, attn, grad = _inputs(seed, shapes)
    want = _jax_vjp(value, shapes, locs, attn, grad)
    got = K2.msda_bwd_plain(*(torch.from_numpy(t) if isinstance(t, np.ndarray)
                              else t for t in (value, shapes, locs, attn,
                                               grad)))
    for name, g, w in zip(("dvalue", "dloc", "dattn"), got, want):
        assert g.shape == w.shape
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=_tol(w),
                                   err_msg=name)
    dvalue, dloc, dattn = got
    assert not dloc[:, OFF_MAP_QUERY].any()
    assert not dattn[:, OFF_MAP_QUERY].any()
    assert not dloc[:, MASKED_QUERY].any() and dattn[:, MASKED_QUERY].any()
    assert dloc[:, 4].abs().max() > 0  # the exact pixel positions move


@pytest.mark.parametrize("seed,shapes", CASES)
def test_autograd_matches_pallas_grad(seed, shapes):
    """Autograd through `ops.msda.ms_deform_attn` on CPU tensors against
    jax.grad of the Pallas kernel in interpret mode (routed to XLA), the
    pattern of tests/test_msda_pallas.py."""
    value, shapes, locs, attn, grad = _inputs(seed, shapes)
    tin = [torch.from_numpy(t).requires_grad_(True)
           for t in (value, locs, attn)]
    out = tmsda.ms_deform_attn(tin[0], shapes, tin[1], tin[2])
    got = torch.autograd.grad(out, tin, torch.from_numpy(grad))

    want = _pallas_grad(jnp.asarray(value), shapes, jnp.asarray(locs),
                        jnp.asarray(attn), jnp.asarray(grad))
    for name, g, w in zip(("dvalue", "dloc", "dattn"), got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=_tol(w),
                                   err_msg=name)


@pytest.mark.parametrize("seed,shapes,d", [
    pytest.param(3, LEVELS_3, 16, id="preset_L3"),
    pytest.param(4, LEVELS_1, 16, id="preset_L1"),
    pytest.param(5, LEVELS_3, 8, id="general_D8")])
def test_kernel_arithmetic_matches_plain(seed, shapes, d):
    """The backward kernels' formulas (dloc from the corner differences,
    dattn, dvalue at the in-bounds corners) against autograd of the plain
    version; the preset's head counts (8 heads, D 16, 4 points, the warp
    path's shapes) and a general-path D of 8."""
    value, shapes, locs, attn, grad = _inputs(seed, shapes, nh=8, d=d, q=11)
    args = [torch.from_numpy(t) if isinstance(t, np.ndarray) else t
            for t in (value, shapes, locs, attn, grad)]
    want = K2.msda_bwd_plain(*args)
    got = k2_bwd_emulate(*args)
    for name, g, w in zip(("dvalue", "dloc", "dattn"), got, want):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=0,
                                   atol=_tol(w.numpy()), err_msg=name)


def test_bwd_cuda_raises_on_cpu_tensors():
    value, shapes, locs, attn, grad = _inputs(0, LEVELS_1)
    with pytest.raises(RuntimeError, match="not a CUDA tensor"):
        K2.msda_bwd_cuda(torch.from_numpy(value), shapes,
                         torch.from_numpy(locs), torch.from_numpy(attn),
                         torch.from_numpy(grad))


@pytest.mark.parametrize("q_method", [None, "gating"])
def test_msdeform_attn_module_gradients(q_method):
    """MSDeformAttnModule's parameter gradients and its inputs' (query,
    reference points, value, image query) against flax's, for a seeded
    cotangent."""
    rng = np.random.RandomState(7)
    shapes = ((6, 9), (3, 5))
    b, q, c, nl = 2, 7, 16, len(shapes)
    len_v = sum(h * w for h, w in shapes)
    query = rng.randn(b, q, c).astype(np.float32)
    i_query = rng.randn(b, q, c).astype(np.float32)
    ref = rng.uniform(0, 1, (b, q, nl, 2)).astype(np.float32)
    value = rng.randn(b, len_v, c).astype(np.float32)
    cot = rng.randn(b, q, c).astype(np.float32)
    jm = JMSDeformAttnModule(c, nl, n_heads=2, n_points=3, q_method=q_method)
    jin = [jnp.asarray(t) for t in (query, ref, value, i_query)]
    variables = seeded_variables(jax.eval_shape(
        lambda: jm.init(jax.random.PRNGKey(0), jin[0], jin[1], jin[2],
                        shapes, jin[3])), np.random.RandomState(8))

    def f(params, qu, re, va, iq):
        return jm.apply({"params": params}, qu, re, va, shapes, iq)

    @jax.jit
    def vjp(params, qu, re, va, iq, g):
        return jax.vjp(f, params, qu, re, va, iq)[1](g)

    want_params, *want_inputs = vjp(variables["params"], *jin,
                                    jnp.asarray(cot))

    tm = MSDeformAttnModule(c, nl, n_heads=2, n_points=3, q_method=q_method)
    tm.load_state_dict(state_dict_from_flax(tm, variables))
    tin = [torch.from_numpy(t).requires_grad_(True)
           for t in (query, ref, value, i_query)]
    out = tm(tin[0], tin[1], tin[2], shapes, tin[3])
    names = [n for n, _ in tm.named_parameters()]
    got = torch.autograd.grad(out, [*tm.parameters(), *tin],
                              torch.from_numpy(cot), allow_unused=True,
                              materialize_grads=True)
    want = params_from_flax(tm, jax.tree_util.tree_map(np.asarray,
                                                       want_params))
    for name, g in zip(names, got):
        w = want[name].numpy()
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-6,
                                   err_msg=name)
    for name, g, w in zip(("query", "reference_points", "value", "i_query"),
                          got[len(names):], want_inputs):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=0,
                                   atol=1e-4 * np.abs(w).max() + 1e-6,
                                   err_msg=name)


def test_autograd_function_launches_forward_and_backward(monkeypatch):
    """`ops.msda._MSDA`, the path CUDA tensors take, with the two launchers
    standing in for the kernels on CPU tensors: one forward and one
    backward call a step, the backward given a contiguous cotangent (here
    a transposed view's), and the gradients those of autograd of the plain
    version."""
    calls = {"fwd": 0, "bwd": 0}

    def fwd(*args):
        calls["fwd"] += 1
        return K2.msda_plain(*args)

    def bwd(*args):
        calls["bwd"] += 1
        assert args[-1].is_contiguous()
        return K2.msda_bwd_plain(*args)

    monkeypatch.setattr(K2, "msda_cuda", fwd)
    monkeypatch.setattr(K2, "msda_bwd_cuda", bwd)
    value, shapes, locs, attn, grad = _inputs(6, LEVELS_3)
    tin = [torch.from_numpy(t).requires_grad_(True)
           for t in (value, locs, attn)]
    out = tmsda._MSDA.apply(tin[0], shapes, tin[1], tin[2])
    cot = torch.from_numpy(grad).transpose(0, 1).contiguous().transpose(0, 1)
    assert not cot.is_contiguous()
    got = torch.autograd.grad(out, tin, cot)
    assert calls == {"fwd": 1, "bwd": 1}
    want = K2.msda_bwd_plain(*(torch.from_numpy(t) if isinstance(
        t, np.ndarray) else t for t in (value, shapes, locs, attn, grad)))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
