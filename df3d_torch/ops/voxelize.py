"""Device-side voxelization: key -> stable sort -> segment reduce.

Port of df3d/ops/voxelize.py, "sort" method (reference-exact hard
voxelization with the mean VFE fused in). Everything is static-shape:
P input points, `max_voxels` output slots, the first `max_points_per_voxel`
points per voxel in file order, voxels sorted by spatial key with -1
padding rows.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

INT_MAX = 2**31 - 1


class VoxelizationResult(NamedTuple):
    features: torch.Tensor     # (max_voxels, F) mean of the kept points
    coords: torch.Tensor       # (max_voxels, 3) int32 (z, y, x); -1 padding
    num_points: torch.Tensor   # (max_voxels,) int32, capped counts
    num_voxels: torch.Tensor   # () int32
    point_voxel_id: torch.Tensor  # (P,) int32 voxel slot per point, -1 dropped


def compute_voxel_coords(points, voxel_size, pc_range):
    """(P, 3+) metric points -> (P, 3) int32 (z, y, x) grid coords. A true
    f32 division, as in the JAX package: a multiply by the reciprocal moves
    boundary points into other voxels."""
    vs = torch.tensor(voxel_size, dtype=torch.float32, device=points.device)
    origin = torch.tensor(pc_range[:3], dtype=torch.float32,
                          device=points.device)
    xyz = torch.floor((points[..., :3] - origin) / vs).to(torch.int32)
    return xyz.flip(-1)  # x,y,z -> z,y,x


def voxelize(points: torch.Tensor, valid: torch.Tensor, voxel_size, pc_range,
             grid_size, max_voxels: int,
             max_points_per_voxel: int = 10) -> VoxelizationResult:
    """Hard voxelization with mean pooling. points (P, F) xyz first; valid
    (P,) masks padding rows; grid_size = (Z, Y, X)."""
    p, f = points.shape
    zg, yg, xg = grid_size
    assert zg * yg * xg < 2**31
    dev = points.device

    coords = compute_voxel_coords(points, voxel_size, pc_range)
    in_range = (
        valid
        & (coords[:, 0] >= 0) & (coords[:, 0] < zg)
        & (coords[:, 1] >= 0) & (coords[:, 1] < yg)
        & (coords[:, 2] >= 0) & (coords[:, 2] < xg)
    )
    c64 = coords.long()
    key = (c64[:, 0] * yg + c64[:, 1]) * xg + c64[:, 2]
    key = torch.where(in_range, key, torch.full_like(key, INT_MAX))

    skey, order = torch.sort(key, stable=True)
    first = torch.ones_like(skey, dtype=torch.bool)
    first[1:] = skey[1:] != skey[:-1]
    first &= skey != INT_MAX
    vid = torch.cumsum(first.to(torch.int64), 0) - 1
    vid = torch.where(skey == INT_MAX, torch.full_like(vid, max_voxels), vid)

    # within-voxel rank for the max_points cap (the stable sort keeps file
    # order inside a voxel)
    idx = torch.arange(p, device=dev)
    seg_start = torch.cummax(
        torch.where(first, idx, torch.full_like(idx, -1)), 0).values
    keep = (idx - seg_start < max_points_per_voxel) & (vid < max_voxels)

    seg_id = vid.clamp_max(max_voxels)
    aug = torch.cat([points[order], points.new_ones(p, 1)], 1)
    aug = torch.where(keep[:, None], aug, torch.zeros_like(aug))
    sums = points.new_zeros(max_voxels + 1, f + 1).index_add_(
        0, seg_id, aug)[:max_voxels]
    counts = sums[:, f].to(torch.int32)
    features = sums[:, :f] / counts.clamp_min(1)[:, None].to(sums.dtype)

    # every row of a voxel carries the same coords; slot max_voxels drops
    out_coords = torch.full((max_voxels + 1, 3), -1, dtype=torch.int32,
                            device=dev)
    out_coords[seg_id] = coords[order]
    num_voxels = first.sum().clamp_max(max_voxels).to(torch.int32)

    pv_sorted = torch.where(keep, vid, torch.full_like(vid, -1))
    point_voxel_id = torch.empty(p, dtype=torch.int32, device=dev)
    point_voxel_id[order] = pv_sorted.to(torch.int32)
    return VoxelizationResult(features, out_coords[:max_voxels], counts,
                              num_voxels, point_voxel_id)


def voxelize_batch(points: torch.Tensor, valid: torch.Tensor, voxel_size,
                   pc_range, grid_size, max_voxels: int,
                   max_points_per_voxel: int = 10) -> VoxelizationResult:
    """Per-sample voxelize over the leading batch dim: features (B, V, F),
    coords (B, V, 3), ..."""
    outs = [
        voxelize(points[i], valid[i], voxel_size, pc_range, grid_size,
                 max_voxels, max_points_per_voxel)
        for i in range(points.shape[0])
    ]
    return VoxelizationResult(*[torch.stack(list(t)) for t in zip(*outs)])
