"""Camera projection chains on the device (port of df3d/core/calib.py).

Every transform is a precomputed (3, 4) or (4, 4) matrix carried with the
batch. The products are written out coordinate by coordinate, one
elementwise op at a time, so the CPU and the card round them identically:
which voxels a camera sees, and at which pixel, is the same on both.
"""

from __future__ import annotations

import torch


def project_to_image(proj: torch.Tensor, points: torch.Tensor):
    """Project (..., N, 3) points with a (..., 3, 4) or (..., 4, 4)
    matrix -> ((..., N, 2) pixel uv, (..., N) depth)."""
    p = proj[..., :3, :4]
    x, y, z = (points[..., i] for i in range(3))

    def row(i):
        m = p[..., i, :]
        return (m[..., 0, None] * x + m[..., 1, None] * y
                + m[..., 2, None] * z + m[..., 3, None])

    u, v, depth = row(0), row(1), row(2)
    uv = (torch.stack([u, v], -1) / depth.abs().clamp_min(1e-6)[..., None]
          * torch.sign(depth)[..., None])
    return uv, depth


def augmented_lidar_to_raw(points: torch.Tensor, noise_rot=None,
                           noise_scale=None, flip_x=None, flip_y=None):
    """Undo world augmentations (p' = s * R * F * p) so points line up with
    the un-augmented camera frame: scale, rotation, then flip undone.
    Each argument has the points' shape without the last axis, or one that
    broadcasts to it (a per-sample scalar as (B, 1))."""
    xyz = points[..., :3]
    if noise_scale is not None:
        # the JAX package divides (B, N, 3) by (B, 1) here, which
        # broadcasts only for B == 1; the trailing axis makes it per sample
        xyz = xyz / noise_scale.clamp_min(1e-6)[..., None]
    if noise_rot is not None:
        c, s = torch.cos(-noise_rot), torch.sin(-noise_rot)
        x = xyz[..., 0] * c - xyz[..., 1] * s
        y = xyz[..., 0] * s + xyz[..., 1] * c
        xyz = torch.stack([x, y, xyz[..., 2]], -1)
    if flip_x is not None:  # flip along x: y was negated
        xyz = torch.stack([xyz[..., 0],
                           xyz[..., 1] * torch.where(flip_x, -1.0, 1.0),
                           xyz[..., 2]], -1)
    if flip_y is not None:  # flip along y: x was negated
        xyz = torch.stack([xyz[..., 0] * torch.where(flip_y, -1.0, 1.0),
                           xyz[..., 1], xyz[..., 2]], -1)
    return torch.cat([xyz, points[..., 3:]], -1)


def voxel_centers_from_coords(coords_zyx: torch.Tensor, voxel_size,
                              pc_range, downsample: int = 1) -> torch.Tensor:
    """(..., 3) int voxel coords (z, y, x) at a stride -> metric center
    xyz."""
    dev = coords_zyx.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev) * downsample
    origin = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    xyz_idx = coords_zyx.flip(-1).to(torch.float32)
    return xyz_idx * vs + origin + 0.5 * vs


def voxel_centers_fma(coords_zyx: torch.Tensor, voxel_size, pc_range,
                      downsample: int = 1) -> torch.Tensor:
    """`voxel_centers_from_coords` rounded as XLA computes it under `jit`:
    idx * size + origin as one fused multiply-add (exact in f64, one f32
    rounding), then + size / 2. The RoI head's neighbour search ranks
    lattice distances, where the last bit decides ties."""
    dev = coords_zyx.device
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=dev) * downsample
    origin = torch.tensor(pc_range[:3], dtype=torch.float32, device=dev)
    xyz_idx = coords_zyx.flip(-1).to(torch.float64)
    return ((xyz_idx * vs.double() + origin.double()).float()
            + 0.5 * vs)
