"""IFAT, image-side gated attention (port of `IFATGate` in
df3d/models/fusion/ifat.py): splat the voxel features onto the image plane
at each image-feature scale, run a small conv stack to a one-channel
sigmoid gate, and scale the image features by it. Its BatchNorms are
flax's (`layers.FlaxBatchNorm2d`) with eps 1e-3, as the JAX package sets
them: in training they normalise with the biased batch variance and move
the running statistics at flax's momentum 0.99. The other IFAT variants
are not on the CenterPoint + 3D-DF path and are not ported.
"""

from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from df3d_torch.models.fusion.projection import splat_to_image
from df3d_torch.models.layers import FlaxBatchNorm2d


class IFATGate(nn.Module):
    """One gate per image scale: num_conv - 1 x [conv 3x3 + BN + ReLU], then
    a conv 3x3 to one channel. `voxel_channels[s]` is the width of the
    features splat at scale s."""

    def __init__(self, voxel_channels: Sequence[int], num_conv: int = 2):
        super().__init__()
        self.num_scales = len(voxel_channels)
        self.num_conv = num_conv
        for s, c in enumerate(voxel_channels):
            for i in range(num_conv - 1):
                self.add_module(f"s{s}_conv{i}", nn.Conv2d(c, c, 3, padding=1))
                self.add_module(f"s{s}_bn{i}", FlaxBatchNorm2d(c, eps=1e-3))
            self.add_module(f"s{s}_out", nn.Conv2d(c, 1, 3, padding=1))

    def forward(self, img_feats: Sequence[torch.Tensor],
                voxel_feats: Sequence[torch.Tensor],
                uv_norms: Sequence[torch.Tensor],
                masks: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """Per scale: img_feats (B, H, W, C_img), voxel_feats (B, N, C),
        uv_norms (B, N, 2), masks (B, N) -> gated (B, H, W, C_img)."""
        out = []
        for s in range(self.num_scales):
            h, w = img_feats[s].shape[1:3]
            g = splat_to_image(uv_norms[s], voxel_feats[s], masks[s], (h, w))
            g = g.permute(0, 3, 1, 2)
            for i in range(self.num_conv - 1):
                g = getattr(self, f"s{s}_conv{i}")(g)
                g = torch.relu(getattr(self, f"s{s}_bn{i}")(g))
            g = getattr(self, f"s{s}_out")(g).permute(0, 2, 3, 1)
            out.append(img_feats[s] * torch.sigmoid(g))
        return out
