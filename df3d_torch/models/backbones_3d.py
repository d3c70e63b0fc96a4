"""Sparse 3D voxel backbones (port of df3d/models/backbones_3d.py).

`SpMiddleResNetFHD` (CenterPoint) and `SparseEncoder` (TransFusion) on the
JAX package's hybrid tail (`dense_tail=True`): sparse through the last
downsample, then `densify` and the dense last-stage blocks.
`VoxelBackBone8x` (Voxel R-CNN, KITTI) is sparse throughout, `conv_out`
included, and `height_compress` makes its BEV map. Conv plans are built
once per coord set and shared by every submanifold layer of a stage
(spconv's indice_key pattern).

With a `fusion_hook` (the 3D-DF camera fusion) the dense-tail backbones'
stride-8 grid goes back to rows (`sparsify`, capped at the stage-4 cap), through the hook, and is
densified again before the last (3, 1, 1) conv. The hook is a child module,
so its parameters sit under the backbone as flax puts them.
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


def _fuse_dense_tail(x, n4: int, hook, fusion_kwargs, overflow: dict):
    """The stride-8 dense grid through the fusion hook: its overflow count
    (summed over the batch, as the JAX package sows it), `sparsify` to the
    stage-4 cap, the hook (only when it has inputs), `densify`."""
    overflow["cap_overflow_dense_tail"] = (
        x.mask.sum(dtype=torch.int32) - n4).clamp_min(0)
    x_sp = sparsify(x, n4)
    stages.mark("backbone_3d")
    if fusion_kwargs:
        x_sp = hook(x_sp, **fusion_kwargs)
    return densify(x_sp)


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
            x_conv4 = _fuse_dense_tail(x_conv4, n4, self.fusion_hook,
                                       fusion_kwargs, overflow)

        spec_x = DenseConvSpec((3, 1, 1), (2, 1, 1), (0, 0, 0))
        out = self.extra_conv(x_conv4, spec_x)
        stages.mark("backbone_3d" if self.fusion_hook is None
                    else "backbone_3d_tail")
        ms = {"conv1": x_conv1, "conv2": x_conv2, "conv3": x_conv3,
              "conv4": x_conv4}
        return bev_from_dense(out), ms, overflow


class SparseEncoder(nn.Module):
    """mmdet3d's middle encoder as TransFusion uses it (basic blocks):
    `conv_input` (subm, in -> 16), then per stage its blocks and, but for
    the last stage, a strided downsample (pads 1, 1, then (0, 1, 1));
    `conv_out` (3, 1, 1) / (2, 1, 1) to 128. The last downsample runs
    sparse and the last stage and `conv_out` run on the dense grid (the
    hybrid tail, the JAX package's `dense_tail=True`)."""

    # per stage: the basic blocks' widths, then (but for the last stage)
    # the downsample's output width
    ENCODER_CHANNELS = ((16, 16, 32), (32, 32, 64), (64, 64, 128), (128, 128))

    def __init__(self, num_input_features: int,
                 fusion_hook: nn.Module | None = None):
        super().__init__()
        self.conv_input = SparseConvBNReLU(num_input_features, 16)
        c = 16
        last_stage = len(self.ENCODER_CHANNELS) - 1
        for i, blocks in enumerate(self.ENCODER_CHANNELS):
            for j, ch in enumerate(blocks):
                if j == len(blocks) - 1 and i != last_stage:
                    self.add_module(f"stage{i}_down",
                                    SparseConvBNReLU(c, ch, subm=False))
                else:
                    self.add_module(f"stage{i}_block{j}",
                                    SparseBasicBlock(ch))
                c = ch
        self.conv_out = SparseConvBNReLU(c, 128, subm=False,
                                         kernel_size=(3, 1, 1))
        self.fusion_hook = fusion_hook

    def forward(self, st: SparseTensor, stage_caps: Sequence[int],
                fusion_kwargs: dict | None = None):
        """stage_caps: static max voxel counts at strides 1, 2, 4, 8;
        fusion_kwargs as for `SpMiddleResNetFHD`.

        -> (BEV map (B, Y, X, Z*C), per-stage tensors, cap overflows)."""
        _, n2, n3, n4 = stage_caps
        caps = (n2, n3, n4)
        last_stage = len(self.ENCODER_CHANNELS) - 1
        overflow = {}

        plan = build_subm_plan(st, 3)
        x = self.conv_input(st, plan)
        stage_outs = []
        for i, blocks in enumerate(self.ENCODER_CHANNELS):
            for j in range(len(blocks)):
                if j == len(blocks) - 1 and i != last_stage:
                    pad = (0, 1, 1) if i == 2 else 1
                    down = build_conv_plan(x, 3, 2, pad, max_out=caps[i])
                    overflow[f"cap_overflow_down{i + 2}"] = _overflow(down)
                    x = getattr(self, f"stage{i}_down")(x, down)
                    if i == last_stage - 1:  # hybrid tail
                        x = densify(x)
                        plan = DenseConvSpec((3, 3, 3), (1, 1, 1), (1, 1, 1))
                    else:
                        plan = build_subm_plan(x, 3)
                else:
                    x = getattr(self, f"stage{i}_block{j}")(x, plan)
            stage_outs.append(x)

        if self.fusion_hook is not None:
            x = _fuse_dense_tail(x, n4, self.fusion_hook, fusion_kwargs,
                                 overflow)
        out = self.conv_out(x, DenseConvSpec((3, 1, 1), (2, 1, 1), (0, 0, 0)))
        stages.mark("backbone_3d" if self.fusion_hook is None
                    else "backbone_3d_tail")
        ms = {f"conv{i + 1}": s for i, s in enumerate(stage_outs)}
        return bev_from_dense(out), ms, overflow


def height_compress(st: SparseTensor) -> torch.Tensor:
    """Sparse tensor -> BEV map (B, Y, X, Z*C) (pcdet's
    HeightCompression)."""
    return bev_from_dense(densify(st))


class VoxelBackBone8x(nn.Module):
    """pcdet's KITTI backbone: plain sparse conv stacks of 16, 32, 64 and 64
    channels, then `conv_out` to 128 with a (3, 1, 1) kernel and (2, 1, 1)
    stride. With a `fusion_hook` (Voxel R-CNN + 3D-DF) the hook runs on
    conv1's output (`stage="conv1"`, MVX early fusion) and on conv4's
    (`stage="conv4"`, ACTR), when it has inputs."""

    CHANNELS = (16, 32, 64, 64)

    def __init__(self, num_input_features: int,
                 fusion_hook: nn.Module | None = None):
        super().__init__()
        c1, c2, c3, c4 = self.CHANNELS
        self.conv_input = SparseConvBNReLU(num_input_features, c1)
        self.conv1 = SparseConvBNReLU(c1, c1)
        self.down2 = SparseConvBNReLU(c1, c2, subm=False)
        self.conv2a = SparseConvBNReLU(c2, c2)
        self.conv2b = SparseConvBNReLU(c2, c2)
        self.down3 = SparseConvBNReLU(c2, c3, subm=False)
        self.conv3a = SparseConvBNReLU(c3, c3)
        self.conv3b = SparseConvBNReLU(c3, c3)
        self.down4 = SparseConvBNReLU(c3, c4, subm=False)
        self.conv4a = SparseConvBNReLU(c4, c4)
        self.conv4b = SparseConvBNReLU(c4, c4)
        self.conv_out = SparseConvBNReLU(c4, 128, subm=False,
                                         kernel_size=(3, 1, 1))
        self.fusion_hook = fusion_hook

    @staticmethod
    def out_depth(sparse_z: int) -> int:
        """Z extent of the BEV output: three stride-2 z convs (pads 1, 1,
        0), then `conv_out` (kernel 3, stride 2, no pad)."""
        z = sparse_z
        for pad in (1, 1, 0, 0):
            z = (z + 2 * pad - 3) // 2 + 1
        return z

    def _fuse(self, x: SparseTensor, stage: str, fusion_kwargs):
        if self.fusion_hook is None or not fusion_kwargs:
            return x
        stages.mark("backbone_3d")
        return self.fusion_hook(x, stage=stage, **fusion_kwargs)

    def forward(self, st: SparseTensor, stage_caps: Sequence[int],
                fusion_kwargs: dict | None = None):
        """stage_caps: static max voxel counts at strides 1, 2, 4, 8
        (`conv_out` shares the last); fusion_kwargs the hook's inputs.

        -> (BEV map (B, Y, X, Z*C), per-stage tensors, cap overflows)."""
        _, n2, n3, n4 = stage_caps
        overflow = {}

        plan1 = build_subm_plan(st, 3)
        x = self.conv_input(st, plan1)
        x_conv1 = self._fuse(self.conv1(x, plan1), "conv1", fusion_kwargs)

        down2 = build_conv_plan(x_conv1, 3, 2, 1, max_out=n2)
        overflow["cap_overflow_down2"] = _overflow(down2)
        x = self.down2(x_conv1, down2)
        plan2 = build_subm_plan(x, 3)
        x_conv2 = self.conv2b(self.conv2a(x, plan2), plan2)

        down3 = build_conv_plan(x_conv2, 3, 2, 1, max_out=n3)
        overflow["cap_overflow_down3"] = _overflow(down3)
        x = self.down3(x_conv2, down3)
        plan3 = build_subm_plan(x, 3)
        x_conv3 = self.conv3b(self.conv3a(x, plan3), plan3)

        down4 = build_conv_plan(x_conv3, 3, 2, (0, 1, 1), max_out=n4)
        overflow["cap_overflow_down4"] = _overflow(down4)
        x = self.down4(x_conv3, down4)
        plan4 = build_subm_plan(x, 3)
        x_conv4 = self._fuse(self.conv4b(self.conv4a(x, plan4), plan4),
                             "conv4", fusion_kwargs)

        out_plan = build_conv_plan(x_conv4, (3, 1, 1), (2, 1, 1), 0,
                                   max_out=n4)
        overflow["cap_overflow_out"] = _overflow(out_plan)
        bev = height_compress(self.conv_out(x_conv4, out_plan))
        stages.mark("backbone_3d")
        ms = {"conv1": x_conv1, "conv2": x_conv2, "conv3": x_conv3,
              "conv4": x_conv4}
        return bev, ms, overflow
