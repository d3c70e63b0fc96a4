"""3D box geometry (port of df3d/core/boxes.py): what the IoU needs.

Box convention as in the JAX package: 7-dof ``(cx, cy, cz, dx, dy, dz,
heading)`` with ``cz`` the gravity center and ``heading`` the CCW rotation
around +z; trailing dims (vx, vy) ride along untouched.
"""

from __future__ import annotations

import torch

_BEV_SIGNS = ((1.0, 1.0), (-1.0, 1.0), (-1.0, -1.0), (1.0, -1.0))


def boxes_bev_corners(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 7) -> (..., 4, 2) BEV rectangle corners (CCW)."""
    dx, dy = boxes[..., 3], boxes[..., 4]
    signs = torch.tensor(_BEV_SIGNS, dtype=boxes.dtype, device=boxes.device)
    local = 0.5 * signs * torch.stack([dx, dy], -1)[..., None, :]
    c, s = torch.cos(boxes[..., 6]), torch.sin(boxes[..., 6])
    x = local[..., 0] * c[..., None] - local[..., 1] * s[..., None]
    y = local[..., 0] * s[..., None] + local[..., 1] * c[..., None]
    return torch.stack([x, y], -1) + boxes[..., None, :2]
