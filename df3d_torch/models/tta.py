"""Double-flip test-time augmentation (port of df3d/models/tta.py, det3d's
CenterPoint TTA): each sample is evaluated as [identity, flip_y, flip_x,
flip_both], a batch x4, and the CenterHead maps are un-flipped and
averaged before decoding.

The un-flip follows the geometry of the head's targets
(`core.target_utils.assign_center_targets`). On a range symmetric about
the origin, a reflected axis maps BEV cell i to cell n - 1 - i and a
sub-cell offset `off = pix - floor(pix)` to `1 - off`; a heading's (sin,
cos) loses the sign of sin under flip_y (yaw -> -yaw), of cos under flip_x
(yaw -> pi - yaw) and of both under flip_both (yaw -> yaw + pi). The JAX
package's merge takes `-off` and other rot signs (ROADMAP section 3);
`vel` and `height` are as there. The heatmap logits and `dim` are averaged
as raw maps, as the JAX package averages them.
"""

from __future__ import annotations

import torch

# flip_y negates y (the maps' H axis), flip_x negates x (their W axis)
_VARIANT_AXES = ((), (1,), (2,), (1, 2))
# per map, the channels that each flipped variant (flip_y, flip_x,
# flip_both) negates, and those it measures from the other cell edge
_NEGATED = {"rot": ((0,), (1,), (0, 1)),   # (sin, cos)
            "vel": ((1,), (0,), (0, 1))}   # (vx, vy)
_FROM_EDGE = {"reg": ((1,), (0,), (0, 1))}  # (x, y) sub-cell offsets


def expand_points_double_flip(points: torch.Tensor) -> torch.Tensor:
    """(B, P, F) -> (B*4, P, F), sample-major: [id, flip_y (y negated),
    flip_x (x negated), flip_both]."""
    out = points[:, None].repeat(1, 4, 1, 1)
    out[:, 1, :, 1] *= -1.0
    out[:, 2, :, 0] *= -1.0
    out[:, 3, :, :2] *= -1.0
    return out.reshape(-1, *points.shape[1:])


def expand_proj_double_flip(proj: torch.Tensor) -> torch.Tensor:
    """(B, [n_cam,] 3, 4) lidar -> image -> (B*4, [n_cam,] 3, 4), each
    variant's reflection composed into the matrices (P' = P @ F), so that
    the flipped points project onto the unchanged images: P' (F x) = P x."""
    signs = proj.new_tensor([[1.0, 1.0], [1.0, -1.0], [-1.0, 1.0],
                             [-1.0, -1.0]])
    out = proj[:, None].repeat(1, 4, *([1] * (proj.dim() - 1)))
    for v in range(1, 4):
        out[:, v, ..., :2] *= signs[v]
    return out.reshape(-1, *proj.shape[1:])


def expand_images_double_flip(images: torch.Tensor) -> torch.Tensor:
    """(B, ...) -> (B*4, ...): the cameras never move, so each sample's
    images repeat for its four variants, sample-major."""
    return images.repeat_interleave(4, dim=0)


def merge_center_head_maps(preds: list[dict]) -> list[dict]:
    """CenterHead maps of a (B*4, H, W, C) batch of flipped variants ->
    (B, H, W, C) per task: each variant un-flipped, then the four
    averaged."""
    merged = []
    for task in preds:
        out = {}
        for name, m in task.items():
            m = m.reshape(-1, 4, *m.shape[1:])
            total = m[:, 0]
            for v, axes in enumerate(_VARIANT_AXES[1:]):
                mv = m[:, v + 1].flip(axes)  # a copy
                for c in _NEGATED.get(name, ((),) * 3)[v]:
                    mv[..., c] = -mv[..., c]
                for c in _FROM_EDGE.get(name, ((),) * 3)[v]:
                    mv[..., c] = 1.0 - mv[..., c]
                total = total + mv
            out[name] = total / 4.0
        merged.append(out)
    return merged
