"""The ACTR fusion hook (port of `make_multicam_actr_fusion_hook` and
`make_actr_fusion_hook` in df3d/models/fusion/hooks.py).

The cameras fold into the batch axis: the stage's voxel queries become
(B * n_cam, N, ...) with a visibility mask per camera; the image query is
the nearest-pixel image feature at each voxel's projection; IFAT gates the
camera features; ACTR enhances the queries; the enhancements of all
cameras are summed back into the voxel stream. With one camera this is the
JAX package's single-camera hook (Voxel R-CNN + 3D-DF, KITTI), which also
runs MVX early fusion on the stride-1 voxels: the nearest image query of
every level through `mvx_proj`, summed in where the camera sees the voxel.
The hook is a module whose children (`mvx_proj`, `ifat`, `actr`,
`actr_out_proj`) sit under the backbone, where flax puts them. The
bilinear image query is not on a ported path and is not ported.

Given a list `aux_pairs` (a training step's aux objectives), the ACTR
fusion point appends its consistency pair, the counterpart of the JAX
package's `sow("intermediates", "aux_consistency", ...)`: the voxel
features ahead of the sum, the cameras' summed enhancement and the voxels
any camera sees. With one camera that is the single-camera hook's pair
(the features, the masked enhancement, the mask); MVX gives none.

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

from df3d_torch.core.calib import voxel_centers_fma
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
    """forward(st, image_feats, proj, stage=None) -> st with the fused
    features.

    image_feats: per level (B, n_cam, H_l, W_l, C_l); proj (B, n_cam, 3, 4)
    lidar -> image matrices; st the stage's SparseTensor, whose features
    are `voxel_channels` wide (`mvx_channels` wide at `stage="conv1"`,
    where the MVX sum runs if `mvx_channels` is given; any other stage
    runs ACTR). noise_rot, noise_scale, flip_x and flip_y (B,), when given,
    are each sample's world augmentation, undone on the voxel centres
    before they are projected (`core.calib.augmented_lidar_to_raw`), at
    both fusion points."""

    def __init__(self, spec: ACTRFusionSpec, voxel_size, pc_range,
                 image_shape, num_cams: int, voxel_channels: int,
                 image_channels: Sequence[int],
                 mvx_channels: int | None = None):
        super().__init__()
        self.spec = spec
        self.voxel_size, self.pc_range = tuple(voxel_size), tuple(pc_range)
        self.image_shape, self.num_cams = tuple(image_shape), num_cams
        if spec.use_ifat:
            self.ifat = IFATGate([voxel_channels] * len(image_channels))
        self.actr = ACTR(spec.actr, voxel_channels, sum(image_channels),
                         image_channels)
        self.actr_out_proj = nn.Linear(spec.actr.d_model, voxel_channels)
        if mvx_channels is not None:
            if num_cams != 1:
                raise ValueError("MVX early fusion is the single-camera "
                                 "hook's")
            self.mvx_proj = nn.Linear(sum(image_channels), mvx_channels)

    def _project(self, st, image_feats, proj, downsample, aug):
        """Per camera (folded into the batch): uv (B*n_cam, N, 2), mask
        (B*n_cam, N), the image feature maps and the image query."""
        b, n, _ = st.features.shape
        uv, _, mask = project_voxels_to_image(
            st.coords, st.valid, proj, self.image_shape, self.voxel_size,
            self.pc_range, downsample=downsample, **aug)
        uv = uv.reshape(b * self.num_cams, n, 2)
        mask_f = mask.reshape(b * self.num_cams, n)
        cam_feats = [f.reshape(-1, *f.shape[2:]) for f in image_feats]
        return uv, mask_f, cam_feats, gather_image_query(cam_feats, uv,
                                                         mask_f)

    def forward(self, st: SparseTensor, image_feats, proj, stage=None,
                aux_pairs: list | None = None, noise_rot=None,
                noise_scale=None, flip_x=None, flip_y=None) -> SparseTensor:
        b, n, c = st.features.shape
        nc = self.num_cams
        aug = dict(noise_rot=noise_rot, noise_scale=noise_scale,
                   flip_x=flip_x, flip_y=flip_y)
        if stage == "conv1":
            if not hasattr(self, "mvx_proj"):
                return st
            _, mask_f, _, i_query = self._project(st, image_feats, proj, 1,
                                                  aug)
            iq = self.mvx_proj(i_query) * mask_f[..., None]
            stages.mark("mvx")
            return st.with_features(st.features
                                    + iq.reshape(b, nc, n, c).sum(1))
        uv, mask_f, cam_feats, i_query = self._project(
            st, image_feats, proj, self.spec.downsample, aug)
        q_feat_rep = st.features.repeat_interleave(nc, 0)

        feats_for_actr = cam_feats
        if self.spec.use_ifat:
            k = len(cam_feats)
            feats_for_actr = self.ifat(cam_feats, [q_feat_rep] * k, [uv] * k,
                                       [mask_f] * k)
        stages.mark("ifat")

        # rounded as under `jit`: LT's ball query decides pairs that lie
        # on its radius by the centres' last bit
        centers = voxel_centers_fma(
            st.coords, self.voxel_size, self.pc_range, self.spec.downsample)
        enh = self.actr(q_feat_rep, i_query, uv,
                        centers.repeat_interleave(nc, 0), mask_f,
                        feats_for_actr)
        enh = self.actr_out_proj(enh) * mask_f[..., None]
        # sum the cameras' contributions (det3d sum-scatter)
        enh_sum = enh.reshape(b, nc, n, c).sum(1)
        if aux_pairs is not None:
            aux_pairs.append((st.features, enh_sum,
                              mask_f.reshape(b, nc, n).any(1)))
        stages.mark("msda_actr")
        return st.with_features(st.features + enh_sum)
