"""Shared building blocks (port of df3d/models/layers.py).

The sparse 3D modules keep the JAX package's polymorphism: a SparseTensor +
ConvPlan runs the gather-GEMM body (the CUDA kernel on the card), a
DenseTensor + DenseConvSpec runs a dense conv masked to the active set. The
(K, Cin, Cout) tap weights are the same either way. BatchNorms on voxel
features and BEV maps use eps=1e-3 (det3d/pcdet norm_cfg) and flax's
momentum 0.99 in training. Under `parallel.ddp.data_parallel` the training
norms take their statistics over the global batch (SyncBN).

The 2D blocks take NCHW tensors (PyTorch's layout); `BEVBackbone` and
`CenterHead` convert at their boundary, where the layout is the JAX
package's channel-last one.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from df3d_torch.ops.dense3d import DenseTensor, dense_conv
from df3d_torch.parallel import ddp
from df3d_torch.ops.sparse import SparseTensor, apply_sparse_conv, _triple


# flax's default momentum of the running statistics (torch's 0.01); a norm
# built with another one (TransFusion's head: 0.9) keeps its own
MOMENTUM = 0.99


@torch.no_grad()
def _update_running(bn: nn.Module, mean: torch.Tensor,
                    var: torch.Tensor) -> None:
    """flax's update of the running statistics, in place: old * momentum +
    batch * (1 - momentum), at the norm's own `momentum`."""
    m = bn.momentum
    bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
    bn.running_var.copy_(m * bn.running_var + (1 - m) * var)


def promoted(x: torch.Tensor, layer: nn.Module) -> torch.Tensor:
    """x in the dtype flax's promotion gives it against `layer`'s weight
    (a bf16 input of an f32 layer becomes f32, exactly), where torch's
    linear and conv layers refuse mixed dtypes."""
    return x.to(torch.promote_types(x.dtype, layer.weight.dtype))


class _FlaxNorm(nn.Module):
    """The parameters and running statistics of a flax `nn.BatchNorm`."""

    def __init__(self, channels: int, eps: float, momentum: float):
        super().__init__()
        self.eps, self.momentum = eps, momentum
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))


class MaskedBatchNorm(_FlaxNorm):
    """BatchNorm over the valid rows of padded (..., C) features; rows
    outside the mask come out zero. In training the statistics are the mean
    and the biased variance over the valid rows, pooled over batch and rows,
    and the running statistics move as flax's do: old * MOMENTUM + batch *
    (1 - MOMENTUM)."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__(channels, eps, MOMENTUM)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask[..., None].to(x.dtype)
            red = tuple(range(x.dim() - 1))
            # over the global batch under `ddp.data_parallel`: the sum and
            # the count, then the squared deviations from the global mean
            total, cnt = ddp.global_sum((x * m).sum(red), m.sum())
            cnt = cnt.clamp_min(1.0)
            mean = total / cnt
            var = ddp.global_sum(((x - mean).square() * m).sum(red)) / cnt
            _update_running(self, mean, var)
        else:
            mean, var = self.running_mean, self.running_var
        inv = torch.rsqrt(var + self.eps) * self.weight
        # in x's dtype, as the JAX package casts: a bf16 x (the bf16 serving
        # profile) stays bf16 where torch would promote it to f32
        dt = x.dtype
        y = (x - mean.to(dt)) * inv.to(dt) + self.bias.to(dt)
        return torch.where(mask[..., None], y, torch.zeros_like(y))


class FlaxBatchNorm(_FlaxNorm):
    """flax's `nn.BatchNorm` over the last axis of (..., C). In training it
    normalises with the batch mean and the biased variance max(0, E[x^2] -
    E[x]^2) (flax's fast variance) over every other axis and moves the
    running statistics by old * momentum + batch * (1 - momentum); torch's
    BatchNorms would put the unbiased variance there, with a reversed
    momentum. In eval it is `F.batch_norm` on the running statistics."""

    channel_axis = -1

    def __init__(self, channels: int, eps: float,
                 momentum: float = MOMENTUM):
        super().__init__(channels, eps, momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        axis = self.channel_axis % x.dim()
        if not self.training:
            if axis == 1:
                return F.batch_norm(x, self.running_mean, self.running_var,
                                    self.weight, self.bias, False, 0.0,
                                    self.eps)
            return F.batch_norm(
                x.reshape(-1, x.shape[-1]), self.running_mean,
                self.running_var, self.weight, self.bias, False, 0.0,
                self.eps).reshape(x.shape)
        red = tuple(d for d in range(x.dim()) if d != axis)
        if ddp.world_size() > 1:  # over the global batch: one all-reduce
            total, sq, n = ddp.global_sum(
                x.sum(red), x.square().sum(red),
                x.new_full((1,), x.numel() // x.shape[axis]))
            mean, sq_mean = total / n, sq / n
        else:
            mean, sq_mean = x.mean(red), x.square().mean(red)
        var = (sq_mean - mean.square()).clamp_min(0.0)
        _update_running(self, mean, var)
        shape = [1] * x.dim()
        shape[axis] = -1
        inv = torch.rsqrt(var + self.eps) * self.weight
        return ((x - mean.view(shape)) * inv.view(shape)
                + self.bias.view(shape))


class FlaxBatchNorm2d(FlaxBatchNorm):
    """`FlaxBatchNorm` over the channels of NCHW maps."""

    channel_axis = 1


class _TapConv(nn.Module):
    """(K, Cin, Cout) tap weights and the serving profile's numerics
    (`serving.apply_profile`): `compute_dtype` None computes in the input's
    dtype; bf16 takes bf16 operands with f32 accumulation, on a sparse body
    only from `min_channels` input channels on, on the dense tail always."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3):
        super().__init__()
        k = _triple(kernel_size)
        self.weight = nn.Parameter(
            torch.zeros(k[0] * k[1] * k[2], in_channels, out_channels))
        self.compute_dtype: torch.dtype | None = None
        self.min_channels = 0

    def _body(self, features, plan):
        return apply_sparse_conv(features, plan, self.weight,
                                 self.compute_dtype, self.min_channels)


class SubMConv3d(_TapConv):
    """Submanifold conv; the plan (or dense spec) is supplied by the caller
    so one plan serves every layer of a stage."""

    def forward(self, st, plan):
        if isinstance(st, DenseTensor):
            return dense_conv(st, self.weight, plan.ksize, stride=1,
                              padding=tuple(k // 2 for k in plan.ksize),
                              subm=True, compute_dtype=self.compute_dtype)
        return st.with_features(self._body(st.features, plan))


class SparseConv3d(_TapConv):
    """Strided conv: a new coord set from plan.out_coords, or on the dense
    tail a DenseTensor whose mask is the exact dilation of the input's."""

    def forward(self, st, plan):
        if isinstance(st, DenseTensor):
            return dense_conv(st, self.weight, plan.ksize, stride=plan.stride,
                              padding=plan.padding, subm=False,
                              compute_dtype=self.compute_dtype)
        feats = self._body(st.features, plan)
        return SparseTensor(feats, plan.out_coords, plan.out_spatial_shape)


class SparseConvBNReLU(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, subm: bool = True,
                 kernel_size=3):
        super().__init__()
        self.subm = subm
        conv = SubMConv3d if subm else SparseConv3d
        self.conv = conv(in_channels, out_channels, kernel_size)
        self.bn = MaskedBatchNorm(out_channels)

    def forward(self, st, plan):
        st = self.conv(st, plan)
        return st.with_features(torch.relu(self.bn(st.features, st.valid)))


class SparseBasicBlock(nn.Module):
    """ResNet-style block of two subm convs (det3d scn.py SparseBasicBlock)."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv1 = SubMConv3d(channels, channels)
        self.bn1 = MaskedBatchNorm(channels)
        self.conv2 = SubMConv3d(channels, channels)
        self.bn2 = MaskedBatchNorm(channels)

    def forward(self, st, plan):
        identity = st.features
        out = self.conv1(st, plan)
        h = torch.relu(self.bn1(out.features, st.valid))
        out = self.conv2(st.with_features(h), plan)
        h = self.bn2(out.features, st.valid)
        return st.with_features(torch.relu(h + identity))


@torch.no_grad()
def flax_trunc_normal_(w: torch.Tensor, fan_in: int, scale: float,
                       generator: torch.Generator) -> None:
    """Fill w as flax's variance_scaling(scale, "fan_in",
    "truncated_normal") draws (He for scale 2, LeCun for 1): the std of a
    unit normal truncated to [-2, 2] is 0.87962566."""
    std = math.sqrt(scale / fan_in) / 0.87962566103423978
    draw = torch.empty(w.shape, dtype=w.dtype)
    nn.init.trunc_normal_(draw, 0.0, std, -2 * std, 2 * std,
                          generator=generator)
    w.copy_(draw)


@torch.no_grad()
def flax_dense_init_(module: nn.Module, generator: torch.Generator) -> None:
    """flax's Dense initializer on every Linear of `module`: LeCun
    truncated-normal weights, zero biases."""
    for m in module.modules():
        if isinstance(m, nn.Linear):
            flax_trunc_normal_(m.weight, m.in_features, 1.0, generator)
            if m.bias is not None:
                m.bias.zero_()


def same_pads(size: int, kernel: int, stride: int) -> tuple[int, int]:
    """flax/XLA "SAME" padding (lo, hi) for one spatial dim: asymmetric
    when the total is odd (lo = total // 2)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return total // 2, total - total // 2


def conv2d_same(conv: nn.Conv2d, x: torch.Tensor) -> torch.Tensor:
    """Apply an unpadded Conv2d with flax "SAME" padding to NCHW x."""
    kh, kw = conv.kernel_size
    sh, sw = conv.stride
    hlo, hhi = same_pads(x.shape[2], kh, sh)
    wlo, whi = same_pads(x.shape[3], kw, sw)
    return conv(F.pad(x, (wlo, whi, hlo, hhi)))


class ConvBNReLU2d(nn.Module):
    """BEV 2D conv block on NCHW maps, flax "SAME" padding."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1,
                 use_bias: bool = False):
        super().__init__()
        self.conv = nn.Conv2d(in_channels, out_channels, kernel_size,
                              stride=stride, bias=use_bias)
        self.bn = FlaxBatchNorm2d(out_channels, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(conv2d_same(self.conv, x)))


class DeconvBNReLU2d(nn.Module):
    """Transposed-conv upsample block (RPN deblocks) on NCHW maps."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 2):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(in_channels, out_channels, stride,
                                         stride=stride, bias=False)
        self.bn = FlaxBatchNorm2d(out_channels, eps=1e-3)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.deconv(x)))


class MLP(nn.Module):
    """ReLU MLP over the last axis (the JAX package's `MLP`): Linear layers
    of `hidden` widths, a ReLU between them, and after the last with
    `activate_final`. flax names the layers `Dense_<i>`, here `layers.<i>`."""

    def __init__(self, in_features: int, hidden, activate_final: bool = False):
        super().__init__()
        widths = (in_features, *hidden)
        self.layers = nn.ModuleList(nn.Linear(a, b) for a, b in
                                    zip(widths[:-1], widths[1:]))
        self.activate_final = activate_final

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.layers) - 1
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < last or self.activate_final:
                x = torch.relu(x)
        return x
