"""Multi-scale deformable attention sampling (port of df3d/ops/msda.py).

`ms_deform_attn` takes the reference MSDeformAttn op's layout (value (B,
LenV, nH, D), locations (B, Q, nH, L, P, 2), weights (B, Q, nH, L, P)) and
returns (B, Q, nH * D): bilinear sampling at loc * (W, H) - 0.5 with zero
padding, the semantics of the reference's `ms_deform_attn_core_pytorch`.
A CUDA tensor runs the hand-written kernel K2
(`msda_kernel.msda_cuda`) forward and its backward kernel
(`msda_kernel.msda_bwd_cuda`) under autograd, through `_MSDA`; a CPU
tensor runs the plain PyTorch version, differentiated by autograd. The
JAX package's lane-first layout (`ms_deform_attn_t`) is a TPU layout
choice with the same result and is not carried over.
"""

from __future__ import annotations

import torch

from df3d_torch.ops import msda_kernel as _k


class _MSDA(torch.autograd.Function):
    """K2 with its gradients on CUDA tensors (the counterpart of the JAX
    package's custom VJP around the Pallas kernel): forward `msda_cuda`,
    backward `msda_bwd_cuda`, no gradient for the level shapes."""

    @staticmethod
    def forward(ctx, value, spatial_shapes, sampling_locations,
                attention_weights):
        ctx.spatial_shapes = spatial_shapes
        ctx.save_for_backward(value, sampling_locations, attention_weights)
        return _k.msda_cuda(value, spatial_shapes, sampling_locations,
                            attention_weights)

    @staticmethod
    @torch.autograd.function.once_differentiable
    def backward(ctx, grad_output):
        value, locs, attn = ctx.saved_tensors
        dvalue, dloc, dattn = _k.msda_bwd_cuda(
            value, ctx.spatial_shapes, locs, attn, grad_output.contiguous())
        return dvalue, None, dloc, dattn


def ms_deform_attn(value: torch.Tensor, spatial_shapes,
                   sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    if value.is_cuda:
        return _MSDA.apply(value, spatial_shapes, sampling_locations,
                           attention_weights)
    if value.device.type == "cpu":
        return _k.msda_plain(value, spatial_shapes, sampling_locations,
                             attention_weights)
    raise RuntimeError(f"ms_deform_attn: no path for {value.device}")


def level_start_index(spatial_shapes) -> tuple:
    idx, acc = [], 0
    for h, w in spatial_shapes:
        idx.append(acc)
        acc += h * w
    return tuple(idx)
