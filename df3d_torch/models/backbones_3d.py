"""Sparse 3D voxel backbone (port of df3d/models/backbones_3d.py).

`SpMiddleResNetFHD` on the JAX package's default path: sparse through
`down4` (hybrid tail, `dense_tail=True`, `dense_from=4`), then `densify` and
the dense stage-4 blocks. Conv plans are built once per coord set and shared
by every submanifold layer of a stage (spconv's indice_key pattern).

With a `fusion_hook` (the 3D-DF camera fusion) the stage-4 grid goes back
to rows (`sparsify`, capped at the stage-4 cap), through the hook, and is
densified again before `extra_conv`. The hook is a child module, so its
parameters sit under the backbone as flax puts them.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from df3d_torch.ops.dense3d import (
    DenseConvSpec, bev_from_dense, densify, sparsify,
)
from df3d_torch.ops.sparse import SparseTensor, build_conv_plan, build_subm_plan
from df3d_torch.models.layers import SparseBasicBlock, SparseConvBNReLU
from df3d_torch.utils import stages


def _overflow(plan) -> torch.Tensor:
    """Output sites the static cap dropped: true occupancy minus the cap."""
    return (plan.true_occ - plan.num_out_rows).clamp_min(0)


class SpMiddleResNetFHD(nn.Module):
    """det3d resnet-style middle encoder: 8x BEV downsample + z collapse."""

    def __init__(self, num_input_features: int,
                 fusion_hook: nn.Module | None = None):
        super().__init__()
        c1, c2, c3, c4 = 16, 32, 64, 128
        self.conv_input = SparseConvBNReLU(num_input_features, c1)
        self.res1a = SparseBasicBlock(c1)
        self.res1b = SparseBasicBlock(c1)
        self.down2 = SparseConvBNReLU(c1, c2, subm=False)
        self.res2a = SparseBasicBlock(c2)
        self.res2b = SparseBasicBlock(c2)
        self.down3 = SparseConvBNReLU(c2, c3, subm=False)
        self.res3a = SparseBasicBlock(c3)
        self.res3b = SparseBasicBlock(c3)
        self.down4 = SparseConvBNReLU(c3, c4, subm=False)
        self.res4a = SparseBasicBlock(c4)
        self.res4b = SparseBasicBlock(c4)
        self.extra_conv = SparseConvBNReLU(c4, c4, subm=False,
                                           kernel_size=(3, 1, 1))
        self.fusion_hook = fusion_hook

    @staticmethod
    def out_depth(sparse_z: int) -> int:
        """Z extent of the BEV output: three stride-2 z convs (pads 1, 1,
        0), then `extra_conv` (kernel 3, stride 2, no pad)."""
        z = sparse_z
        for pad in (1, 1, 0, 0):
            z = (z + 2 * pad - 3) // 2 + 1
        return z

    def forward(self, st: SparseTensor, stage_caps: Sequence[int],
                fusion_kwargs: dict | None = None):
        """stage_caps: static max voxel counts after each downsample
        (input/conv1, conv2, conv3, conv4). fusion_kwargs: the hook's
        inputs (image_feats, proj); without them the hook passes the
        stage through, as in the JAX package.

        -> (BEV map (B, Y, X, Z*C), per-stage tensors, cap overflows)."""
        _, n2, n3, n4 = stage_caps
        overflow = {}

        plan1 = build_subm_plan(st, 3)
        x = self.conv_input(st, plan1)
        x = self.res1a(x, plan1)
        x_conv1 = self.res1b(x, plan1)

        down2 = build_conv_plan(x_conv1, 3, 2, 1, max_out=n2)
        overflow["cap_overflow_down2"] = _overflow(down2)
        x = self.down2(x_conv1, down2)
        plan2 = build_subm_plan(x, 3)
        x = self.res2a(x, plan2)
        x_conv2 = self.res2b(x, plan2)

        down3 = build_conv_plan(x_conv2, 3, 2, 1, max_out=n3)
        overflow["cap_overflow_down3"] = _overflow(down3)
        x = self.down3(x_conv2, down3)
        plan3 = build_subm_plan(x, 3)
        x = self.res3a(x, plan3)
        x_conv3 = self.res3b(x, plan3)

        # hybrid tail: down4 runs sparse, then the 16x smaller stage-4 grid
        # goes dense
        down4 = build_conv_plan(x_conv3, 3, 2, (0, 1, 1), max_out=n4)
        overflow["cap_overflow_down4"] = _overflow(down4)
        x = densify(self.down4(x_conv3, down4))
        spec_s = DenseConvSpec((3, 3, 3), (1, 1, 1), (1, 1, 1))
        x = self.res4a(x, spec_s)
        x_conv4 = self.res4b(x, spec_s)

        if self.fusion_hook is not None:
            # the JAX package sows this count summed over the batch
            overflow["cap_overflow_dense_tail"] = (
                x_conv4.mask.sum(dtype=torch.int32) - n4).clamp_min(0)
            x_conv4_sp = sparsify(x_conv4, n4)
            stages.mark("backbone_3d")
            if fusion_kwargs:
                x_conv4_sp = self.fusion_hook(x_conv4_sp, **fusion_kwargs)
            x_conv4 = densify(x_conv4_sp)

        spec_x = DenseConvSpec((3, 1, 1), (2, 1, 1), (0, 0, 0))
        out = self.extra_conv(x_conv4, spec_x)
        stages.mark("backbone_3d" if self.fusion_hook is None
                    else "backbone_3d_tail")
        ms = {"conv1": x_conv1, "conv2": x_conv2, "conv3": x_conv3,
              "conv4": x_conv4}
        return bev_from_dense(out), ms, overflow
