"""Voxel R-CNN's anchor RPN head, its serving half (port of
df3d/models/heads/anchor_head.py): `AnchorClassCfg`, `generate_anchors`,
`AnchorHeadSingle` and `anchor_head_decode`.

Anchors are flattened location-major, in (y, x, class, rotation) order: the
order in which a channel-last 1x1 conv's output, reshaped to (B, H*W*A,
.), lists its per-anchor predictions. The head's 1x1 convs run here as
`nn.Linear` on the channel-last BEV map, so the reshape reads the same
order (an NCHW conv would have to be permuted first). The targets and the
loss (training) are not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn

from df3d_torch.core.box_coders import ResidualCoder
from df3d_torch.core.boxes import limit_period


# pcdet's direction classifier: two bins, headings offset by ~pi/4
NUM_DIR_BINS = 2
DIR_OFFSET = 0.78539


@dataclasses.dataclass(frozen=True)
class AnchorClassCfg:
    name: str
    size: tuple          # (dx, dy, dz)
    bottom_height: float
    rotations: tuple = (0.0, 1.5707963)


def generate_anchors(grid_size_xy: tuple, pc_range,
                     classes: Sequence[AnchorClassCfg]) -> np.ndarray:
    """-> (ny, nx, num_classes, num_rot, 7) float32 (pcdet's
    AnchorGenerator): anchor centres on the corners of the BEV grid, z at
    the class's box centre."""
    nx, ny = grid_size_xy
    all_anchors = []
    for cfg in classes:
        x_stride = (pc_range[3] - pc_range[0]) / (nx - 1)
        y_stride = (pc_range[4] - pc_range[1]) / (ny - 1)
        xs = pc_range[0] + np.arange(nx) * x_stride
        ys = pc_range[1] + np.arange(ny) * y_stride
        z = cfg.bottom_height + cfg.size[2] / 2
        xx, yy, rr = np.meshgrid(xs, ys, np.asarray(cfg.rotations),
                                 indexing="ij")
        a = np.stack([xx, yy, np.full_like(xx, z),
                      np.full_like(xx, cfg.size[0]),
                      np.full_like(xx, cfg.size[1]),
                      np.full_like(xx, cfg.size[2]), rr], axis=-1)
        all_anchors.append(a.transpose(1, 0, 2, 3))  # (ny, nx, R, 7)
    return np.stack(all_anchors, axis=2).astype(np.float32)


class AnchorHeadSingle(nn.Module):
    """1x1 conv heads over the channel-last BEV map (pcdet's
    anchor_head_single.py): class logits, box residuals and direction-bin
    logits per anchor."""

    def __init__(self, in_channels: int, num_classes: int,
                 num_anchors_per_loc: int):
        super().__init__()
        self.num_classes = num_classes
        n = num_anchors_per_loc
        self.conv_cls = nn.Linear(in_channels, n * num_classes)
        self.conv_box = nn.Linear(in_channels, n * 7)
        self.conv_dir = nn.Linear(in_channels, n * NUM_DIR_BINS)

    def forward(self, bev: torch.Tensor):
        """bev (B, H, W, C) -> cls (B, H*W*A, ncls), box (B, H*W*A, 7),
        dir (B, H*W*A, 2)."""
        b = bev.shape[0]
        return (self.conv_cls(bev).reshape(b, -1, self.num_classes),
                self.conv_box(bev).reshape(b, -1, 7),
                self.conv_dir(bev).reshape(b, -1, NUM_DIR_BINS))


def anchor_head_decode(cls_preds, box_preds, dir_preds, anchors,
                       coder: ResidualCoder):
    """Residuals decoded at every anchor, the heading snapped to the
    predicted direction bin (period pi, offset DIR_OFFSET; the first bin
    wins a tie). -> (scores (B, A, ncls) sigmoid, boxes (B, A, 7))."""
    boxes = coder.decode(box_preds, anchors[None])
    dir_bin = dir_preds.argmax(-1)
    rot = limit_period(boxes[..., 6] - DIR_OFFSET, 0.0, math.pi)
    heading = rot + DIR_OFFSET + math.pi * dir_bin
    boxes = torch.cat([boxes[..., :6], heading[..., None]], -1)
    return torch.sigmoid(cls_preds), boxes
