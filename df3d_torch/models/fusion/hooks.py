"""The multi-camera ACTR fusion hook (port of
`make_multicam_actr_fusion_hook` in df3d/models/fusion/hooks.py).

The cameras fold into the batch axis: the stage's voxel queries become
(B * n_cam, N, ...) with a visibility mask per camera; the image query is
the nearest-pixel image feature at each voxel's projection; IFAT gates the
camera features; ACTR enhances the queries; the enhancements of all
cameras are summed back into the voxel stream. The hook is a module whose
children (`ifat`, `actr`, `actr_out_proj`) sit under the backbone, where
flax puts them. The single-camera hook (MVX early fusion at stride 1) and
the bilinear image query are not on the CenterPoint + 3D-DF path and are
not ported.

Gradients in training, as JAX's autodiff gives them: the image query reads
the frozen image branch's features and gets none; the IFAT gate's splat
passes it back to the winning voxel of each pixel (`splat_to_image`) and so
into the stride-8 voxel features; projections, FPS and ball-query indices
carry none.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch
from torch import nn

from df3d_torch.core.calib import voxel_centers_from_coords
from df3d_torch.models.fusion.actr import ACTR, ACTRConfig
from df3d_torch.models.fusion.ifat import IFATGate
from df3d_torch.models.fusion.projection import (
    pixel_index, project_voxels_to_image,
)
from df3d_torch.ops.sparse import SparseTensor
from df3d_torch.utils import stages


def gather_image_query(i_feats: Sequence[torch.Tensor], uv_norm: torch.Tensor,
                       mask: torch.Tensor) -> torch.Tensor:
    """Nearest-pixel image features at each voxel, concatenated over the
    scales. i_feats: list of (B, H, W, C); uv_norm (B, N, 2) -> (B, N,
    sum C), zero where mask is False."""
    outs = []
    for f in i_feats:
        b, h, w, c = f.shape
        xi = pixel_index(uv_norm[..., 0], w).clamp(0, w - 1)
        yi = pixel_index(uv_norm[..., 1], h).clamp(0, h - 1)
        flat = (yi * w + xi).long()
        g = f.reshape(b, h * w, c).gather(
            1, flat[..., None].expand(-1, -1, c))
        outs.append(g * mask[..., None])
    return torch.cat(outs, -1)


@dataclasses.dataclass(frozen=True)
class ACTRFusionSpec:
    """An ACTR fusion point inside a backbone stage."""

    actr: ACTRConfig
    downsample: int            # voxel stride at the fusion stage
    use_ifat: bool = True


class MultiCamACTRFusionHook(nn.Module):
    """forward(st, image_feats, proj) -> st with the fused features.

    image_feats: per level (B, n_cam, H_l, W_l, C_l); proj (B, n_cam, 3, 4)
    lidar -> image matrices; st the stage's SparseTensor, whose features
    are `voxel_channels` wide."""

    def __init__(self, spec: ACTRFusionSpec, voxel_size, pc_range,
                 image_shape, num_cams: int, voxel_channels: int,
                 image_channels: Sequence[int]):
        super().__init__()
        self.spec = spec
        self.voxel_size, self.pc_range = tuple(voxel_size), tuple(pc_range)
        self.image_shape, self.num_cams = tuple(image_shape), num_cams
        if spec.use_ifat:
            self.ifat = IFATGate([voxel_channels] * len(image_channels))
        self.actr = ACTR(spec.actr, voxel_channels, sum(image_channels),
                         image_channels)
        self.actr_out_proj = nn.Linear(spec.actr.d_model, voxel_channels)

    def forward(self, st: SparseTensor, image_feats, proj) -> SparseTensor:
        b, n, c = st.features.shape
        nc = self.num_cams
        uv, _, mask = project_voxels_to_image(
            st.coords, st.valid, proj, self.image_shape, self.voxel_size,
            self.pc_range, downsample=self.spec.downsample)
        uv = uv.reshape(b * nc, n, 2)
        mask_f = mask.reshape(b * nc, n)
        cam_feats = [f.reshape(b * nc, *f.shape[2:]) for f in image_feats]
        i_query = gather_image_query(cam_feats, uv, mask_f)
        q_feat_rep = st.features.repeat_interleave(nc, 0)

        feats_for_actr = cam_feats
        if self.spec.use_ifat:
            k = len(cam_feats)
            feats_for_actr = self.ifat(cam_feats, [q_feat_rep] * k, [uv] * k,
                                       [mask_f] * k)
        stages.mark("ifat")

        centers = voxel_centers_from_coords(
            st.coords, self.voxel_size, self.pc_range, self.spec.downsample)
        enh = self.actr(q_feat_rep, i_query, uv,
                        centers.repeat_interleave(nc, 0), mask_f,
                        feats_for_actr)
        enh = self.actr_out_proj(enh) * mask_f[..., None]
        # sum the cameras' contributions (det3d sum-scatter)
        enh_sum = enh.reshape(b, nc, n, c).sum(1)
        stages.mark("msda_actr")
        return st.with_features(st.features + enh_sum)
