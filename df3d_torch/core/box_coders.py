"""Box coders (port of `ResidualCoder` and `TransFusionBBoxCoder` in
df3d/core/box_coders.py).

`ResidualCoder.decode` turns Voxel R-CNN's anchor-relative 7-dof residuals
(pcdet's convention) back into boxes; it is on the serving path of both
stages (anchors, and RoIs in their canonical frame). `encode` makes both
stages' regression targets in training.

`TransFusionBBoxCoder.encode` takes bottom-centre 9-dof boxes (x, y, z,
dx, dy, dz, heading, vx, vy) and gives the 10-wide code (x, y in BEV feature pixels,
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


@dataclasses.dataclass(frozen=True)
class ResidualCoder:
    """Anchor-relative 7-dof residual coder (pcdet convention), the JAX
    package's default (no sin/cos heading). Leading batch dims broadcast."""

    def encode(self, boxes: torch.Tensor,
               anchors: torch.Tensor) -> torch.Tensor:
        """Boxes (..., 7) relative to anchors (..., 7): centre offsets over
        the anchor's BEV diagonal (z over its height), log size ratios
        (sizes floored at 1e-5), heading difference."""
        anchors = torch.cat([anchors[..., :3],
                             anchors[..., 3:6].clamp_min(1e-5),
                             anchors[..., 6:]], -1)
        boxes = torch.cat([boxes[..., :3], boxes[..., 3:6].clamp_min(1e-5),
                           boxes[..., 6:]], -1)
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa, dya, dza = anchors[..., 3], anchors[..., 4], anchors[..., 5]
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([
            (boxes[..., 0] - xa) / diag, (boxes[..., 1] - ya) / diag,
            (boxes[..., 2] - za) / dza, torch.log(boxes[..., 3] / dxa),
            torch.log(boxes[..., 4] / dya), torch.log(boxes[..., 5] / dza),
            boxes[..., 6] - anchors[..., 6]], -1)

    def decode(self, encodings: torch.Tensor,
               anchors: torch.Tensor) -> torch.Tensor:
        xa, ya, za = anchors[..., 0], anchors[..., 1], anchors[..., 2]
        dxa, dya, dza = anchors[..., 3], anchors[..., 4], anchors[..., 5]
        diag = torch.sqrt(dxa ** 2 + dya ** 2)
        return torch.stack([
            encodings[..., 0] * diag + xa, encodings[..., 1] * diag + ya,
            encodings[..., 2] * dza + za, torch.exp(encodings[..., 3]) * dxa,
            torch.exp(encodings[..., 4]) * dya,
            torch.exp(encodings[..., 5]) * dza,
            encodings[..., 6] + anchors[..., 6]], -1)
