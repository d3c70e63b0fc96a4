"""TransFusion's box coder (port of `TransFusionBBoxCoder` in
df3d/core/box_coders.py).

encode() takes bottom-centre 9-dof boxes (x, y, z, dx, dy, dz, heading,
vx, vy) and gives the 10-wide code (x, y in BEV feature pixels,
gravity-centre z, log dims, sin, cos, vx, vy) that TransFusion's head
predicts; decode() inverts it to bottom-centre boxes. Both take leading
batch dims. decode is on the serving path, encode makes the training
targets.
"""

from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class TransFusionBBoxCoder:
    pc_range: tuple[float, float]
    voxel_size: tuple[float, float]
    out_size_factor: int

    def encode(self, boxes: torch.Tensor) -> torch.Tensor:
        tx = (boxes[..., 0] - self.pc_range[0]) / (
            self.out_size_factor * self.voxel_size[0])
        ty = (boxes[..., 1] - self.pc_range[1]) / (
            self.out_size_factor * self.voxel_size[1])
        tz = boxes[..., 2] + 0.5 * boxes[..., 5]  # bottom -> gravity centre
        return torch.stack([
            tx, ty, tz, torch.log(boxes[..., 3]), torch.log(boxes[..., 4]),
            torch.log(boxes[..., 5]), torch.sin(boxes[..., 6]),
            torch.cos(boxes[..., 6]), boxes[..., 7], boxes[..., 8]], -1)

    def decode(self, center, height, dim, rot_sin, rot_cos, vel=None):
        """center (..., 2) in feature-map pixels; height (...,) gravity z;
        dim (..., 3) log -> bottom-centre boxes (..., 7 or 9)."""
        x = (center[..., 0] * self.out_size_factor * self.voxel_size[0]
             + self.pc_range[0])
        y = (center[..., 1] * self.out_size_factor * self.voxel_size[1]
             + self.pc_range[1])
        dims = torch.exp(dim)
        z = height - 0.5 * dims[..., 2]  # gravity -> bottom centre
        heading = torch.atan2(rot_sin, rot_cos)
        parts = [x[..., None], y[..., None], z[..., None], dims,
                 heading[..., None]]
        if vel is not None:
            parts.append(vel)
        return torch.cat(parts, -1)
