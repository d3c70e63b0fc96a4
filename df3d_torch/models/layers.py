"""Shared building blocks (port of df3d/models/layers.py).

The sparse 3D modules keep the JAX package's polymorphism: a SparseTensor +
ConvPlan runs the gather-GEMM body (the CUDA kernel on the card), a
DenseTensor + DenseConvSpec runs a dense conv masked to the active set. The
(K, Cin, Cout) tap weights are the same either way. BatchNorms on voxel
features and BEV maps use eps=1e-3 (det3d/pcdet norm_cfg).

The 2D blocks take NCHW tensors (PyTorch's layout); `BEVBackbone` and
`CenterHead` convert at their boundary, where the layout is the JAX
package's channel-last one.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from df3d_torch.ops.dense3d import DenseTensor, dense_conv
from df3d_torch.ops.sparse import SparseTensor, apply_sparse_conv, _triple


class MaskedBatchNorm(nn.Module):
    """BatchNorm over the valid rows of padded (..., C) features, eval
    path (running statistics); rows outside the mask come out zero.
    Training statistics wait for the training slice."""

    def __init__(self, channels: int, eps: float = 1e-3):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            raise NotImplementedError(
                "MaskedBatchNorm: only the eval path is ported; call .eval()")
        inv = torch.rsqrt(self.running_var + self.eps) * self.weight
        y = (x - self.running_mean) * inv + self.bias
        return torch.where(mask[..., None], y, torch.zeros_like(y))


class SubMConv3d(nn.Module):
    """Submanifold conv; the plan (or dense spec) is supplied by the caller
    so one plan serves every layer of a stage."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3):
        super().__init__()
        k = _triple(kernel_size)
        self.weight = nn.Parameter(
            torch.zeros(k[0] * k[1] * k[2], in_channels, out_channels))

    def forward(self, st, plan):
        if isinstance(st, DenseTensor):
            return dense_conv(st, self.weight, plan.ksize, stride=1,
                              padding=tuple(k // 2 for k in plan.ksize),
                              subm=True)
        return st.with_features(
            apply_sparse_conv(st.features, plan, self.weight))


class SparseConv3d(nn.Module):
    """Strided conv: a new coord set from plan.out_coords, or on the dense
    tail a DenseTensor whose mask is the exact dilation of the input's."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size=3):
        super().__init__()
        k = _triple(kernel_size)
        self.weight = nn.Parameter(
            torch.zeros(k[0] * k[1] * k[2], in_channels, out_channels))

    def forward(self, st, plan):
        if isinstance(st, DenseTensor):
            return dense_conv(st, self.weight, plan.ksize, stride=plan.stride,
                              padding=plan.padding, subm=False)
        feats = apply_sparse_conv(st.features, plan, self.weight)
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
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-3, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(conv2d_same(self.conv, x)))


class DeconvBNReLU2d(nn.Module):
    """Transposed-conv upsample block (RPN deblocks) on NCHW maps."""

    def __init__(self, in_channels: int, out_channels: int, stride: int = 2):
        super().__init__()
        self.deconv = nn.ConvTranspose2d(in_channels, out_channels, stride,
                                         stride=stride, bias=False)
        self.bn = nn.BatchNorm2d(out_channels, eps=1e-3, momentum=0.01)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(self.bn(self.deconv(x)))
