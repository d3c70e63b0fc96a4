"""Point-set operators with static shapes (port of df3d/ops/pointops.py).

Furthest point sampling (an iterative masked argmax, exact or chunked) and
the first-k-by-index ball query, batched over a leading dim where the JAX
package vmaps. Padded or invalid points never get selected; returned masks
mark real results. Index outputs equal the JAX package's on the CPU.

Distances are written as explicit per-coordinate products and sums, one
elementwise op at a time, so the CPU and the card round them identically
and every index decision (FPS argmax, in-radius test) is the same on both.
FPS rounds its distances as XLA does once it fuses the sum of squares
under `jit` (a fused multiply-add chain, x^2 then + y^2 then + z^2, one
rounding each): on a voxel lattice many distances tie, and the argmax
follows the last bit.
"""

from __future__ import annotations

import torch

_BIG = 1e10


def _sqdist(xyz: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """xyz (..., N, 3), c (..., 3) -> (..., N) f32 squared distances as a
    fused multiply-add chain: each product is exact in f64 and each
    partial sum is rounded to f32 once."""
    d = (xyz - c[..., None, :]).double()
    acc = (d[..., 0] * d[..., 0]).float().double()
    acc = (d[..., 1] * d[..., 1] + acc).float().double()
    return (d[..., 2] * d[..., 2] + acc).float()


def pairwise_dist2(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared euclidean distances in the JAX package's form |a|^2 + |b|^2 -
    2 a.b. a (..., S, 3), b (..., N, 3) -> (..., S, N)."""
    a2 = a[..., 0] * a[..., 0] + a[..., 1] * a[..., 1] + a[..., 2] * a[..., 2]
    b2 = b[..., 0] * b[..., 0] + b[..., 1] * b[..., 1] + b[..., 2] * b[..., 2]
    ab = (a[..., :, None, 0] * b[..., None, :, 0]
          + a[..., :, None, 1] * b[..., None, :, 1]
          + a[..., :, None, 2] * b[..., None, :, 2])
    return a2[..., :, None] + b2[..., None, :] - 2.0 * ab


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
    n = xyz.shape[1]
    within = (pairwise_dist2(centers, xyz) <= radius * radius) & valid[:, None]
    rank = torch.where(within, torch.arange(n, device=xyz.device,
                                            dtype=torch.int32), n)
    # found ranks are distinct, so their order is unique; the order among
    # the n's does not matter, they are all replaced below
    vals, idx = torch.topk(rank, k, dim=-1, largest=False, sorted=True)
    found = vals < n
    first = torch.where(found[..., :1], idx[..., :1], 0)
    return torch.where(found, idx, first), found
