"""Point-set operators with static shapes (port of df3d/ops/pointops.py).

Furthest point sampling (an iterative masked argmax, exact or chunked) and
the first-k-by-index ball query, batched over a leading dim where the JAX
package vmaps. Padded or invalid points never get selected; returned masks
mark real results. Index outputs equal the JAX package's on the CPU.

Distances are written as explicit per-coordinate products and sums, one
elementwise op at a time, so the CPU and the card round them identically
and every index decision (FPS argmax, in-radius test) is the same on both.
FPS and the ball query round their distances as XLA does under `jit` (a
fused multiply-add chain, x^2 then + y^2 then + z^2, one rounding each;
the ball query's |a|^2 + |b|^2 - 2 a.b likewise for both norms and the dot
product): on a voxel lattice many distances tie, or fall exactly on the
radius, and the decision follows the last bit.
"""

from __future__ import annotations

import torch

_BIG = 1e10
# (centre, point) pairs whose f64 distance temporaries the ball query holds
# at a time (128 MiB for each)
_PAIRS_PER_CHUNK = 1 << 24


def _sqdist(xyz: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """xyz (..., N, 3), c (..., 3) -> (..., N) f32 squared distances as a
    fused multiply-add chain: each product is exact in f64 and each
    partial sum is rounded to f32 once."""
    d = (xyz - c[..., None, :]).double()
    acc = (d[..., 0] * d[..., 0]).float().double()
    acc = (d[..., 1] * d[..., 1] + acc).float().double()
    return (d[..., 2] * d[..., 2] + acc).float()


def fma_dot3(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_i a_i b_i over the last axis (3) of f32 a and b, as a fused
    multiply-add chain: each product is exact in f64 and each partial sum
    is rounded to f32 once."""
    a, b = a.double(), b.double()
    acc = (a[..., 0] * b[..., 0]).float().double()
    acc = (a[..., 1] * b[..., 1] + acc).float().double()
    return (a[..., 2] * b[..., 2] + acc).float()


def pairwise_dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances in the JAX package's form |a|^2 + |b|^2 -
    2 a.b, rounded as XLA computes it under `jit`: both norms and the dot
    product as fused multiply-add chains, then (|a|^2 + |b|^2) - 2 a.b.
    a (..., S, 3), b (..., N, 3) -> (..., S, N)."""
    a2 = fma_dot3(a, a)
    b2 = fma_dot3(b, b)
    ab = fma_dot3(a[..., :, None, :], b[..., None, :, :])
    return (a2[..., :, None] + b2[..., None, :]) - 2.0 * ab


def _fps_exact(xyz: torch.Tensor, valid: torch.Tensor,
               num_samples: int) -> torch.Tensor:
    """Exact D-FPS over (B, N, 3) -> (B, num_samples) int64."""
    b, n, _ = xyz.shape
    rows = torch.arange(b, device=xyz.device)
    big_valid = torch.where(valid, 0.0, -_BIG).to(xyz.dtype)
    first = valid.to(torch.int32).argmax(-1)       # first valid point
    idxs = torch.zeros(b, num_samples, dtype=torch.long, device=xyz.device)
    idxs[:, 0] = first
    dists = torch.minimum(torch.full((b, n), _BIG, dtype=xyz.dtype,
                                     device=xyz.device),
                          _sqdist(xyz, xyz[rows, first]))
    last = first
    for i in range(1, num_samples):
        dists = torch.minimum(dists, _sqdist(xyz, xyz[rows, last]))
        last = (dists + big_valid).argmax(-1)
        idxs[:, i] = last
    return idxs


def furthest_point_sample(xyz: torch.Tensor, valid: torch.Tensor,
                          num_samples: int, chunks: int = 1) -> torch.Tensor:
    """D-FPS. xyz (B, N, 3), valid (B, N) -> (B, num_samples) int64. With
    fewer valid points than samples, indices repeat.

    chunks > 1 is the JAX package's stratified form: the rows split into
    `chunks` contiguous slabs and exact FPS picks num_samples / chunks
    centers in each, all slabs at once."""
    if chunks == 1:
        return _fps_exact(xyz, valid, num_samples)
    b, n, _ = xyz.shape
    if num_samples % chunks:
        raise ValueError(f"num_samples {num_samples} % chunks {chunks}")
    per = num_samples // chunks
    cs = -(-n // chunks)
    pad = chunks * cs - n
    if pad:
        xyz = torch.cat([xyz, xyz.new_full((b, pad, 3), 1e6)], 1)
        valid = torch.cat([valid, valid.new_zeros(b, pad)], 1)
    local = _fps_exact(xyz.reshape(b * chunks, cs, 3),
                       valid.reshape(b * chunks, cs), per)
    base = torch.arange(chunks, device=xyz.device)[:, None] * cs
    glob = local.view(b, chunks, per) + base
    return glob.reshape(b, num_samples).clamp_max(n - 1)


def ball_query(centers: torch.Tensor, xyz: torch.Tensor, valid: torch.Tensor,
               radius: float, k: int):
    """First k neighbors by index within `radius` (pointnet2 ball_query).

    centers (B, S, 3), xyz (B, N, 3), valid (B, N) -> (idx (B, S, k)
    int64, mask (B, S, k)). Slots past the neighbor count repeat the first
    neighbor (index 0 when there is none) and are False in mask."""
    b, s, _ = centers.shape
    n = xyz.shape[1]
    rows = max(1, _PAIRS_PER_CHUNK // max(b * n, 1))
    within = torch.cat([pairwise_dist2(centers[:, i:i + rows], xyz)
                        <= radius * radius for i in range(0, s, rows)], 1)
    within &= valid[:, None]
    rank = torch.where(within, torch.arange(n, device=xyz.device,
                                            dtype=torch.int32), n)
    # found ranks are distinct, so their order is unique; the order among
    # the n's does not matter, they are all replaced below
    vals, idx = torch.topk(rank, k, dim=-1, largest=False, sorted=True)
    found = vals < n
    first = torch.where(found[..., :1], idx[..., :1], 0)
    return torch.where(found, idx, first), found
