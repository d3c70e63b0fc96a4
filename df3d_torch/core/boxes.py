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


# glibc's sinf and cosf (sysdeps/ieee754/flt-32/s_sinf.c, s_cosf.c), which
# XLA's CPU backend calls for f32 sin and cos: cosine and sine polynomials
# in f64 on the argument reduced by the nearest multiple of pi/2
_COS_POLY = tuple(float.fromhex(c) for c in (
    "0x1p0", "-0x1.ffffffd0c621cp-2", "0x1.55553e1068f19p-5",
    "-0x1.6c087e89a359dp-10", "0x1.99343027bf8c3p-16"))
_SIN_POLY = tuple(float.fromhex(c) for c in (
    "-0x1.555545995a603p-3", "0x1.1107605230bc4p-7",
    "-0x1.994eb3774cf24p-13"))
_HPI_INV_2_24 = float.fromhex("0x1.45F306DC9C883p+23")  # 2^24 * 2 / pi
_HPI = float.fromhex("0x1.921FB54442D18p0")


def _sincosf_poly(x, x2, cosine, negate_cos):
    """glibc's `sinf_poly`: the sine polynomial at x, or (`cosine`) the
    cosine one, its coefficients negated where `negate_cos`."""
    x3 = x * x2
    sin = (x + x3 * _SIN_POLY[0]) + (x3 * x2) * (
        _SIN_POLY[1] + x2 * _SIN_POLY[2])
    c = torch.where(negate_cos, -1.0, 1.0).to(x.dtype)
    x4 = x2 * x2
    cos = ((c * _COS_POLY[0] + x2 * (c * _COS_POLY[1]))
           + x4 * (c * _COS_POLY[2])) + (x4 * x2) * (
               c * _COS_POLY[3] + x2 * (c * _COS_POLY[4]))
    return torch.where(cosine, cos, sin)


def xla_sin_cos(angle: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 sin and cos of f32 `angle` to the bit as XLA's CPU backend (so
    the JAX package under `jit` on the CPU) computes them, which is glibc's
    sinf and cosf: torch's differ by an ulp on ~5% of headings, and an ulp
    in a RoI grid point moves a neighbour across the ball query's radius
    (tests/test_torch_voxelrcnn_sincos.py). |angle| < 0.75 takes the
    polynomials directly (sin = angle, cos = 1 below 2^-12); below 120
    the argument is reduced by n * pi/2 in f64; beyond, torch's f64 sin
    and cos rounded to f32 stand in (glibc reduces there with more bits
    of pi; no heading comes near)."""
    y = angle.float()
    top = (y.view(torch.int32) >> 20) & 0x7FF
    x = y.double()
    n = ((x * _HPI_INV_2_24).to(torch.int32) + 0x800000) >> 24
    n = torch.where(top < 0x3F4, 0, n)
    r = x - n.double() * _HPI
    r_signed = torch.where((n & 3 == 1) | (n & 3 == 2), -r, r)
    odd, flip = (n & 1) == 1, (n & 2) != 0
    sin = _sincosf_poly(r_signed, r * r, odd, flip).float()
    cos = _sincosf_poly(r_signed, r * r, ~odd, flip).float()
    tiny = top < 0x398
    sin = torch.where(tiny, y, sin)
    cos = torch.where(tiny, torch.ones_like(y), cos)
    huge = top >= 0x42F  # |angle| >= 120
    sin = torch.where(huge, torch.sin(x).float(), sin)
    cos = torch.where(huge, torch.cos(x).float(), cos)
    return sin, cos


def rotate_points_along_z(points: torch.Tensor,
                          angle: torch.Tensor) -> torch.Tensor:
    """Rotate points CCW around +z. points (..., N, 3+F), angle (...,);
    trailing features ride along. Rounded as XLA computes the JAX package's
    rotation-matrix product under `jit`: sin and cos as XLA's
    (`xla_sin_cos`), x' = fma(-sin, y, cos * x), y' = fma(cos, y, sin *
    x) (the products exact in f64, one f32 rounding each), so RoI grid
    points land on the same bits."""
    s, c = xla_sin_cos(angle)
    c, s = c[..., None].double(), s[..., None].double()
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
