"""3D box geometry (port of df3d/core/boxes.py): what the IoU, the anchor
decode, the RoI grid and the RCNN corner loss need.

Box convention as in the JAX package: 7-dof ``(cx, cy, cz, dx, dy, dz,
heading)`` with ``cz`` the gravity center and ``heading`` the CCW rotation
around +z; trailing dims (vx, vy) ride along untouched.
"""

from __future__ import annotations

import math

import torch

_BEV_SIGNS = ((1.0, 1.0), (-1.0, 1.0), (-1.0, -1.0), (1.0, -1.0))
# pcdet's corner order: the 4 bottom corners, then the 4 top ones, from
# (+x, +y)
_CORNER_SIGNS = ((1, 1, -1), (1, -1, -1), (-1, -1, -1), (-1, 1, -1),
                 (1, 1, 1), (1, -1, 1), (-1, -1, 1), (-1, 1, 1))


def boxes_bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 4, 2) BEV rectangle corners (CCW)."""
    dx, dy = boxes[..., 3], boxes[..., 4]
    signs = torch.tensor(_BEV_SIGNS, dtype=boxes.dtype, device=boxes.device)
    local = 0.5 * signs * torch.stack([dx, dy], -1)[..., None, :]
    c, s = torch.cos(boxes[..., 6]), torch.sin(boxes[..., 6])
    x = local[..., 0] * c[..., None] - local[..., 1] * s[..., None]
    y = local[..., 0] * s[..., None] + local[..., 1] * c[..., None]
    return torch.stack([x, y], -1) + boxes[..., None, :2]


def limit_period(val: torch.Tensor, offset: float = 0.5,
                 period: float = math.pi) -> torch.Tensor:
    """Wrap angle into [-offset*period, (1-offset)*period)."""
    return val - torch.floor(val / period + offset) * period


def rotate_points_along_z(points: torch.Tensor,
                          angle: torch.Tensor) -> torch.Tensor:
    """Rotate points CCW around +z. points (..., N, 3+F), angle (...,);
    trailing features ride along. Rounded as XLA computes the JAX package's
    rotation-matrix product under `jit`: x' = fma(-sin, y, cos * x), y' =
    fma(cos, y, sin * x) (the products exact in f64, one f32 rounding
    each), so RoI grid points land on the same bits."""
    c = torch.cos(angle)[..., None].double()
    s = torch.sin(angle)[..., None].double()
    x, y = points[..., 0].double(), points[..., 1].double()
    xr = ((c * x).float().double() - s * y).float()
    yr = ((s * x).float().double() + c * y).float()
    return torch.cat([torch.stack([xr, yr], -1), points[..., 2:]], -1)


def boxes_to_corners_3d(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 8, 3) corner points, in pcdet's order."""
    signs = torch.tensor(_CORNER_SIGNS, dtype=boxes.dtype,
                         device=boxes.device)
    corners = 0.5 * boxes[..., None, 3:6] * signs
    corners = rotate_points_along_z(corners, boxes[..., 6])
    return corners + boxes[..., None, :3]
