"""Rotated BEV and 3D IoU (port of df3d/core/iou.py: `iou_bev`,
`iou_bev_chunked`, `iou_3d`), and the axis-aligned `iou_nearest_bev` of the
anchor target assigner.

The intersection area of two rotated rectangles is the branch-free
Green's-theorem clipping of the JAX package: the boundary of A∩B is made of
the parts of A's edges inside B and of B's edges inside A, each found by
clipping the edge's parameter interval against 4 half-planes, each adding
0.5 * cross(start, end). A metric tolerance of 1e-4 counts a coincident
boundary once: A's edges are inclusive, B's edges exclusive.

Every function broadcasts over leading batch dims, so the NMS of all
(batch x task) problems runs as one set of tensor ops.
"""

from __future__ import annotations

import math

import torch

from df3d_torch.core.boxes import boxes_bev_corners

_EPS = 1e-8
_TOL = 1e-4  # meters; must exceed f32 cross-product noise at ~100 m coords


def _edge_clip_contribution(p0, p1, quad, tol):
    """Green's-theorem contribution of edges p0->p1 clipped to inside
    `quad`. p0/p1 (..., E, 2), quad (..., 4, 2), broadcast over the leading
    dims; returns (..., E)."""
    d = p1 - p0
    t_lo = torch.zeros((), dtype=p0.dtype, device=p0.device)
    t_hi = torch.ones((), dtype=p0.dtype, device=p0.device)
    inside_all = torch.ones((), dtype=torch.bool, device=p0.device)
    for k in range(4):
        a = quad[..., k:k + 1, :]
        e = quad[..., (k + 1) % 4:(k + 1) % 4 + 1, :] - a
        inv_len = torch.rsqrt(
            torch.clamp_min(e[..., 0] ** 2 + e[..., 1] ** 2, _EPS))
        # signed distance f(t) = c0 + t*(c1-c0); inside iff f >= -tol
        c0 = (e[..., 0] * (p0[..., 1] - a[..., 1])
              - e[..., 1] * (p0[..., 0] - a[..., 0])) * inv_len
        c1 = (e[..., 0] * (p1[..., 1] - a[..., 1])
              - e[..., 1] * (p1[..., 0] - a[..., 0])) * inv_len
        slope = c1 - c0
        flat = torch.abs(slope) < _EPS
        tc = -(c0 + tol) / torch.where(flat, torch.full_like(slope, _EPS),
                                       slope)
        # slope > 0: the constraint bounds t from below (entry); < 0: exit
        t_lo = torch.where(slope > 0, torch.maximum(t_lo, tc), t_lo)
        t_hi = torch.where(slope < 0, torch.minimum(t_hi, tc), t_hi)
        # an edge parallel to the half-plane is inside only if c0 >= -tol
        inside_all = inside_all & (~flat | (c0 >= -tol))
    ok = inside_all & (t_hi > t_lo)
    q0 = p0 + t_lo[..., None] * d
    q1 = p0 + t_hi[..., None] * d
    contrib = 0.5 * (q0[..., 0] * q1[..., 1] - q1[..., 0] * q0[..., 1])
    return torch.where(ok, contrib, torch.zeros_like(contrib))


def _rect_intersection_area(corners_a, corners_b):
    """Intersection area of CCW rectangles (..., 4, 2), broadcast."""
    a1 = torch.roll(corners_a, -1, dims=-2)
    b1 = torch.roll(corners_b, -1, dims=-2)
    area = (_edge_clip_contribution(corners_a, a1, corners_b, _TOL).sum(-1)
            + _edge_clip_contribution(corners_b, b1, corners_a, -_TOL).sum(-1))
    return torch.clamp_min(area, 0.0)


def overlap_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated BEV intersection area: (..., N, 7), (..., M, 7) ->
    (..., N, M)."""
    ca = boxes_bev_corners(boxes_a).unsqueeze(-3)  # (..., N, 1, 4, 2)
    cb = boxes_bev_corners(boxes_b).unsqueeze(-4)  # (..., 1, M, 4, 2)
    return _rect_intersection_area(ca, cb)


def iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated BEV IoU: (..., N, 7), (..., M, 7) -> (..., N, M)."""
    inter = overlap_bev(boxes_a, boxes_b)
    area_a = boxes_a[..., 3] * boxes_a[..., 4]
    area_b = boxes_b[..., 3] * boxes_b[..., 4]
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / torch.clamp_min(union, _EPS)


def iou_bev_chunked(boxes_a: torch.Tensor, boxes_b: torch.Tensor,
                    chunk: int = 256) -> torch.Tensor:
    """`iou_bev` over row chunks of boxes_a (N % chunk == 0) to bound the
    memory of the (..., chunk, M, 4) clipping temporaries."""
    n = boxes_a.shape[-2]
    assert n % chunk == 0, f"pad N={n} to a multiple of {chunk}"
    return torch.cat([iou_bev(boxes_a[..., i:i + chunk, :], boxes_b)
                      for i in range(0, n, chunk)], dim=-2)


def iou_3d(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise 3D IoU of gravity-centre boxes: the rotated BEV
    intersection times the z overlap, over the union of the volumes
    (floored at 1e-8). (..., N, 7), (..., M, 7) -> (..., N, M)."""
    inter_bev = overlap_bev(boxes_a, boxes_b)
    za1 = boxes_a[..., 2] - 0.5 * boxes_a[..., 5]
    za2 = boxes_a[..., 2] + 0.5 * boxes_a[..., 5]
    zb1 = boxes_b[..., 2] - 0.5 * boxes_b[..., 5]
    zb2 = boxes_b[..., 2] + 0.5 * boxes_b[..., 5]
    overlap_h = (torch.minimum(za2[..., :, None], zb2[..., None, :])
                 - torch.maximum(za1[..., :, None], zb1[..., None, :])
                 ).clamp_min(0.0)
    inter = inter_bev * overlap_h
    vol_a = boxes_a[..., 3] * boxes_a[..., 4] * boxes_a[..., 5]
    vol_b = boxes_b[..., 3] * boxes_b[..., 4] * boxes_b[..., 5]
    union = vol_a[..., :, None] + vol_b[..., None, :] - inter
    return inter / torch.clamp_min(union, _EPS)


def iou_nearest_bev(boxes_a: torch.Tensor,
                    boxes_b: torch.Tensor) -> torch.Tensor:
    """Axis-aligned BEV IoU after snapping each heading to the nearest
    multiple of pi/2 (pcdet's boxes3d_nearest_bev_iou, which its anchor
    target assigner uses): (N, 7), (M, 7) -> (N, M).

    Rounded as XLA computes the JAX package's under `jit`: the union's
    area_a + area_b as one fused multiply-add of b's sides onto area_a (the
    product exact in f64, one f32 rounding). On a lattice of anchors two
    anchors symmetric about a gt tie in exact arithmetic, and that last bit
    decides which one the target assigner forces and whether an IoU
    reaches a threshold."""

    def to_aabb(boxes):
        swap = torch.sin(boxes[:, 6]).abs() > math.sqrt(0.5)
        dx = torch.where(swap, boxes[:, 4], boxes[:, 3])
        dy = torch.where(swap, boxes[:, 3], boxes[:, 4])
        return torch.stack([boxes[:, 0] - dx / 2, boxes[:, 1] - dy / 2,
                            boxes[:, 0] + dx / 2, boxes[:, 1] + dy / 2], -1)

    aa, bb = to_aabb(boxes_a), to_aabb(boxes_b)
    lt = torch.maximum(aa[:, None, :2], bb[None, :, :2])
    rb = torch.minimum(aa[:, None, 2:], bb[None, :, 2:])
    wh = (rb - lt).clamp_min(0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (aa[:, 2] - aa[:, 0]) * (aa[:, 3] - aa[:, 1])
    sides_b = (bb[:, 2:] - bb[:, :2]).double()
    areas = (area_a[:, None].double()
             + (sides_b[:, 0] * sides_b[:, 1])[None, :]).float()
    return inter / torch.clamp_min(areas - inter, _EPS)
