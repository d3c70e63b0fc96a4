"""Voxel <-> image projection for the fusion layers (port of
df3d/models/fusion/projection.py): voxel centers to normalized image
coordinates with an in-frustum mask, and the nearest-pixel splat of voxel
features onto an image grid. Static shapes: invalid voxels are masked,
never dropped. The bilinear `sample_image_features` is not on the
CenterPoint + 3D-DF path and is not ported.
"""

from __future__ import annotations

import torch

from df3d_torch.core.calib import (
    augmented_lidar_to_raw, project_to_image, voxel_centers_from_coords,
)
from df3d_torch.models.fusion.pointformer import scatter_rows_last


def _col(x):
    """Broadcast per-sample scalars over the voxel axis."""
    return None if x is None else x[:, None]


def project_voxels_to_image(coords_zyx: torch.Tensor, valid: torch.Tensor,
                            proj: torch.Tensor, image_shape, voxel_size,
                            pc_range, downsample: int, noise_rot=None,
                            noise_scale=None, flip_x=None, flip_y=None):
    """coords (B, N, 3) int at this stride, valid (B, N), proj (B, 3, 4) or
    (B, n_cam, 3, 4) -> (uv_norm (..., N, 2), depth (..., N), mask (...,
    N)); with a camera axis the outputs are (B, n_cam, N, ...)."""
    centers = voxel_centers_from_coords(coords_zyx, voxel_size, pc_range,
                                        downsample)
    centers = augmented_lidar_to_raw(
        centers, noise_rot=_col(noise_rot), noise_scale=_col(noise_scale),
        flip_x=_col(flip_x), flip_y=_col(flip_y))
    h, w = image_shape
    if proj.dim() == 4:  # multi-camera
        centers = centers[:, None]
        valid = valid[:, None]
    uv, depth = project_to_image(proj, centers)
    uv_norm = uv / torch.tensor([w, h], dtype=torch.float32,
                                device=uv.device)
    in_img = ((uv_norm[..., 0] >= 0.0) & (uv_norm[..., 0] < 1.0)
              & (uv_norm[..., 1] >= 0.0) & (uv_norm[..., 1] < 1.0)
              & (depth > 0.1) & valid)
    return uv_norm, depth, in_img


def pixel_index(u: torch.Tensor, size: int) -> torch.Tensor:
    """int32 truncation of u * size, as the JAX package's astype(int32),
    with the float clamped to [-1, size] first so far-off voxels cannot
    overflow the cast (they fall outside the image either way)."""
    return (u * size).clamp(-1, size).to(torch.int32)


def splat_to_image(uv_norm: torch.Tensor, feats: torch.Tensor,
                   mask: torch.Tensor, out_shape) -> torch.Tensor:
    """Nearest-pixel scatter of voxel features (B, N, C) onto an (H, W)
    grid -> (B, H, W, C). Where several voxels fall on one pixel the last
    in row order wins (the JAX package's scatter on the CPU), on every
    device."""
    h, w = out_shape
    b, n, c = feats.shape
    xi = pixel_index(uv_norm[..., 0], w)
    yi = pixel_index(uv_norm[..., 1], h)
    ok = mask & (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
    flat = torch.where(ok, yi * w + xi, h * w)
    grid = scatter_rows_last(feats.new_zeros(b, h * w, c), flat, feats)
    return grid.view(b, h, w, c)
