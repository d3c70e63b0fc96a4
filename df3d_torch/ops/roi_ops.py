"""RoI grid pooling ops of Voxel R-CNN's second stage (port of
df3d/ops/roi_ops.py), batched over a leading dim where the JAX package
vmaps.

The neighbour search has two stages, as in the JAX package: per RoI the
`max_local` voxels nearest its centre within a coarse radius, then a ball
query of the RoI's grid points against only those voxels, first
`nsample` by local order. On a voxel lattice many squared distances tie
exactly, or fall exactly on the radius, so both stages round them as XLA
does under `jit` (a fused multiply-add chain, x^2 then + y^2 then + z^2,
one rounding each; `pointops.fma_dot3`) and break ties as `jax.lax.top_k`
does, the lower index first: the 256-th neighbour and the local order
depend on it.
"""

from __future__ import annotations

import torch

from df3d_torch.core.boxes import rotate_points_along_z
from df3d_torch.core.nms import top_k_stable
from df3d_torch.ops.pointops import fma_dot3

_BIG = 1e10


def _sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return fma_dot3(d, d)


def roi_grid_points(rois: torch.Tensor, grid_size: int) -> torch.Tensor:
    """Grid points inside each RoI (pcdet's get_global_grid_points_of_roi):
    rois (..., R, 7) -> (..., R, grid_size^3, 3) world-frame points, x index
    slowest, rounded as XLA rounds them under `jit` (but for its sin and
    cos, which differ from torch's by an ulp on a few per cent of
    headings)."""
    g = grid_size
    ar = torch.arange(g, device=rois.device)
    idx = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), -1)
    # (idx + 0.5) / g - 0.5 as XLA computes it: a multiply by the f32
    # reciprocal fused with the subtraction
    inv = torch.tensor(1.0 / g, dtype=torch.float32).double()
    local = ((idx.reshape(-1, 3).double() + 0.5) * inv - 0.5).float()
    pts = local * rois[..., None, 3:6]
    pts = rotate_points_along_z(pts, rois[..., 6])
    return pts + rois[..., None, :3]


def collect_local_voxels(roi_centers: torch.Tensor, voxel_xyz: torch.Tensor,
                         voxel_valid: torch.Tensor, coarse_radius: float,
                         max_local: int):
    """Stage 1: per RoI the `max_local` nearest voxels, nearest first (the
    lower row first at equal distance), and whether each is within
    `coarse_radius`. roi_centers (B, R, 3), voxel_xyz (B, N, 3),
    voxel_valid (B, N) -> (idx (B, R, L), mask (B, R, L))."""
    d2 = _sqdist(roi_centers[:, :, None], voxel_xyz[:, None])
    d2 = torch.where(voxel_valid[:, None], d2, torch.full_like(d2, _BIG))
    neg, idx = top_k_stable(-d2, max_local)
    return idx, -neg <= coarse_radius * coarse_radius


def grid_ball_query(grid_pts: torch.Tensor, voxel_xyz: torch.Tensor,
                    local_idx: torch.Tensor, local_mask: torch.Tensor,
                    radius: float, nsample: int):
    """Stage 2: per grid point the first `nsample` local voxels (by local
    order) within `radius`. grid_pts (B, R, G, 3), voxel_xyz (B, N, 3),
    local_idx / local_mask (B, R, L) -> (idx (B, R, G, nsample) into the
    full voxel array, found mask). Slots past the neighbour count repeat
    the first neighbour (local slot 0 when there is none)."""
    b, r, l = local_idx.shape
    local_xyz = voxel_xyz.gather(
        1, local_idx.reshape(b, r * l, 1).expand(-1, -1, 3)).view(b, r, l, 3)
    d2 = _sqdist(grid_pts[:, :, :, None], local_xyz[:, :, None])
    within = (d2 <= radius * radius) & local_mask[:, :, None]
    rank = torch.where(within, torch.arange(l, device=within.device), l)
    # found ranks are distinct, so their order is unique; slots past the
    # count are replaced below, whatever order they came in
    vals, sel = torch.topk(rank, nsample, dim=-1, largest=False, sorted=True)
    found = vals < l
    first = torch.where(found[..., :1], sel[..., :1], 0)
    sel = torch.where(found, sel, first)
    g = grid_pts.shape[2]
    idx = local_idx[:, :, None].expand(-1, -1, g, -1).gather(-1, sel)
    return idx, found
