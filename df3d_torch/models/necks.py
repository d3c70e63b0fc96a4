"""BEV 2D conv neck (port of df3d/models/necks.py).

Downsample conv stacks + transposed-conv upsample branches, concatenated.
Takes and returns channel-last (B, H, W, C) maps like the JAX package; the
blocks run on NCHW inside.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from df3d_torch.models.layers import ConvBNReLU2d, DeconvBNReLU2d


class BEVBackbone(nn.Module):
    def __init__(self, in_channels: int, layer_nums: Sequence[int],
                 layer_strides: Sequence[int], num_filters: Sequence[int],
                 upsample_strides: Sequence[int],
                 num_upsample_filters: Sequence[int]):
        super().__init__()
        self.layer_nums = tuple(layer_nums)
        self.up_start = len(layer_nums) - len(upsample_strides)
        self.blocks = nn.ModuleDict()
        c = in_channels
        for i, n in enumerate(layer_nums):
            self.blocks[f"block{i}_in"] = ConvBNReLU2d(
                c, num_filters[i], 3, layer_strides[i])
            c = num_filters[i]
            for j in range(n):
                self.blocks[f"block{i}_conv{j}"] = ConvBNReLU2d(c, c, 3, 1)
            k = i - self.up_start
            if k >= 0:
                stride = upsample_strides[k]
                if stride > 1:
                    up = DeconvBNReLU2d(c, num_upsample_filters[k], stride)
                else:  # stride 1 (or < 1 in pcdet: a strided conv)
                    s = max(int(round(1 / stride)), 1)
                    up = ConvBNReLU2d(c, num_upsample_filters[k], s, s)
                self.blocks[f"deblock{k}"] = up

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (B, H, W, C) -> (B, H', W', sum(num_upsample_filters)). A bf16
        map (the bf16 serving profile's backbone) is taken to the
        parameters' dtype, exactly, as flax's convs promote it against their
        f32 parameters."""
        w = self.blocks["block0_in"].conv.weight
        x = x.permute(0, 3, 1, 2).to(w.dtype).contiguous()
        ups = []
        for i, n in enumerate(self.layer_nums):
            x = self.blocks[f"block{i}_in"](x)
            for j in range(n):
                x = self.blocks[f"block{i}_conv{j}"](x)
            k = i - self.up_start
            if k >= 0:
                ups.append(self.blocks[f"deblock{k}"](x))
        out = torch.cat(ups, 1) if len(ups) > 1 else ups[0]
        return out.permute(0, 2, 3, 1)
