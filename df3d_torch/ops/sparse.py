"""Static-shape sparse voxel tensors and conv plans (port of df3d/ops/sparse.py).

* `SparseTensor` - features (B, N, C) + coords (B, N, 3) = (z, y, x), padded
  to a static N per sample; padding rows have coords -1.
* `build_subm_plan` / `build_conv_plan` - the rulebook: for every output row
  and kernel tap, the row of the contributing input (or N_in for "none").
  Built with sort + `searchsorted`, which gives the JAX package's plans bit
  for bit (the JAX word-rank tables are a TPU layout choice with the same
  result).
* `apply_sparse_conv` - the gather-GEMM conv body. A CUDA tensor goes to the
  hand-written kernel (`sparse_conv_kernel.sparse_conv_cuda`), a CPU tensor
  to its plain PyTorch version.
"""

from __future__ import annotations

import dataclasses

import torch

from df3d_torch.ops import sparse_conv_kernel as _k

INT_MAX = 2**31 - 1


def _triple(v) -> tuple[int, int, int]:
    return (v, v, v) if isinstance(v, int) else tuple(v)


@dataclasses.dataclass(frozen=True)
class SparseTensor:
    """Batched sparse voxel tensor with a static per-sample row count."""

    features: torch.Tensor  # (B, N, C)
    coords: torch.Tensor    # (B, N, 3) int32 (z, y, x); -1 rows are padding
    spatial_shape: tuple[int, int, int]

    @property
    def valid(self) -> torch.Tensor:  # (B, N)
        return self.coords[..., 0] >= 0

    @property
    def batch_size(self) -> int:
        return self.features.shape[0]

    @property
    def num_rows(self) -> int:
        return self.features.shape[1]

    def with_features(self, features: torch.Tensor) -> "SparseTensor":
        return dataclasses.replace(self, features=features)

    def keys(self) -> torch.Tensor:
        """(B, N) int64 linearized spatial keys; padding rows -> INT_MAX."""
        z, y, x = self.spatial_shape
        assert z * y * x < 2**31, "int32 key overflow"
        c = self.coords.long()
        key = (c[..., 0] * y + c[..., 1]) * x + c[..., 2]
        return torch.where(self.valid, key, torch.full_like(key, INT_MAX))


@dataclasses.dataclass(frozen=True)
class ConvPlan:
    """Gather plan: for each sample, tap and output row, the input row (or
    N_in for "no contribution"), stored tap-major and flat (B, K*N_out).
    Reusable across layers with identical coords (spconv's indice_key)."""

    gather_idx: torch.Tensor  # (B, K*N_out) int32 in [0, N_in], tap-major
    out_coords: torch.Tensor  # (B, N_out, 3) int32
    out_spatial_shape: tuple[int, int, int]
    kernel_size: tuple[int, int, int]
    # strided plans: true output occupancy per sample before the cap
    true_occ: torch.Tensor | None = None  # (B,) int32, or None (subm plans)

    @property
    def num_taps(self) -> int:
        k = self.kernel_size
        return k[0] * k[1] * k[2]

    @property
    def num_out_rows(self) -> int:
        return self.gather_idx.shape[1] // self.num_taps


def _centered_offsets(ksize):
    """Python list of (dz, dy, dx) tap offsets, row-major like spconv."""
    kz, ky, kx = ksize
    return [
        (dz - (kz - 1) // 2, dy - (ky - 1) // 2, dx - (kx - 1) // 2)
        for dz in range(kz) for dy in range(ky) for dx in range(kx)
    ]


def _lookup(sorted_keys, query, row_of_sorted, n):
    """Rows whose key == query; n ("no match") points at the zero pad row."""
    pos = torch.searchsorted(sorted_keys, query)
    pos = pos.clamp_max(sorted_keys.shape[0] - 1)
    found = sorted_keys[pos] == query
    return torch.where(found, row_of_sorted[pos], torch.full_like(pos, n))


def _in_grid(ok, c, d, size):
    return ok & (c + d >= 0) & (c + d < size) if d else ok


def build_subm_plan(st: SparseTensor, ksize) -> ConvPlan:
    """Submanifold plan: output sites = input sites; the neighbour at tap k
    is input site + k - (ksize-1)//2. Valid rows must have unique keys."""
    ksize = _triple(ksize)
    z, y, x = st.spatial_shape
    n = st.num_rows
    k_total = ksize[0] * ksize[1] * ksize[2]
    assert k_total % 2 == 1, "submanifold kernels must be odd-sized"
    offs = _centered_offsets(ksize)

    keys_all, valid_all = st.keys(), st.valid
    rows = []
    for b in range(st.batch_size):
        coords, keys, valid = st.coords[b].long(), keys_all[b], valid_all[b]
        cz, cy, cx = coords[:, 0], coords[:, 1], coords[:, 2]
        qs, oks = [], []
        for dz, dy, dx in offs:
            ok = _in_grid(_in_grid(_in_grid(valid, cz, dz, z), cy, dy, y),
                          cx, dx, x)
            qs.append(keys + ((dz * y + dy) * x + dx))
            oks.append(ok)
        q = torch.stack(qs).reshape(-1)  # (K*N,) tap-major
        ok = torch.stack(oks).reshape(-1)
        skeys, order = torch.sort(keys)
        query = torch.where(ok, q, torch.full_like(q, INT_MAX - 1))
        rows.append(_lookup(skeys, query, order, n))
    gather = torch.stack(rows).to(torch.int32)
    return ConvPlan(gather, st.coords, st.spatial_shape, ksize)


def build_conv_plan(st: SparseTensor, ksize, stride, padding,
                    max_out: int) -> ConvPlan:
    """Strided sparse conv plan (SparseConv3d semantics).

    Output sites: all o with o*stride - padding + k == some input site for
    some tap k, deduped per sample; the `max_out` lowest keys are kept. Then
    for each output and tap, gather the input at i = o*stride - padding + k.
    """
    ksize, stride, padding = _triple(ksize), _triple(stride), _triple(padding)
    z, y, x = st.spatial_shape
    oz = (z + 2 * padding[0] - ksize[0]) // stride[0] + 1
    oy = (y + 2 * padding[1] - ksize[1]) // stride[1] + 1
    ox = (x + 2 * padding[2] - ksize[2]) // stride[2] + 1
    assert min(oz, oy, ox) > 0, (
        f"conv collapses spatial shape {st.spatial_shape} -> {(oz, oy, ox)}")
    assert oz * oy * ox < 2**31
    n = st.num_rows
    # per-dim candidate count: o in [ceil((i+pad-ks+1)/s), floor((i+pad)/s)]
    ncand = tuple(-(-k // s) for k, s in zip(ksize, stride))
    cand_list = [(az, ay, ax) for az in range(ncand[0])
                 for ay in range(ncand[1]) for ax in range(ncand[2])]
    taps = [(a, b, c) for a in range(ksize[0]) for b in range(ksize[1])
            for c in range(ksize[2])]

    keys_all, valid_all = st.keys(), st.valid
    gathers, out_coords_all, occ = [], [], []
    for b in range(st.batch_size):
        coords, keys, valid = st.coords[b].long(), keys_all[b], valid_all[b]
        tz = coords[:, 0] + padding[0]
        ty = coords[:, 1] + padding[1]
        tx = coords[:, 2] + padding[2]
        o0z = torch.div(tz, stride[0], rounding_mode="floor")
        o0y = torch.div(ty, stride[1], rounding_mode="floor")
        o0x = torch.div(tx, stride[2], rounding_mode="floor")
        ckeys = []
        for az, ay, ax in cand_list:
            co_z, co_y, co_x = o0z - az, o0y - ay, o0x - ax
            ok_c = (
                valid
                & (tz - co_z * stride[0] < ksize[0])
                & (ty - co_y * stride[1] < ksize[1])
                & (tx - co_x * stride[2] < ksize[2])
                & (co_z >= 0) & (co_y >= 0) & (co_x >= 0)
                & (co_z < oz) & (co_y < oy) & (co_x < ox)
            )  # residuals are >= 0 by construction of the floor-div
            ck = (co_z * oy + co_y) * ox + co_x
            ckeys.append(torch.where(ok_c, ck, torch.full_like(ck, INT_MAX)))
        skey, _ = torch.sort(torch.stack(ckeys).reshape(-1))
        first = torch.ones_like(skey, dtype=torch.bool)
        first[1:] = skey[1:] != skey[:-1]
        first &= skey != INT_MAX
        uid = torch.cumsum(first.to(torch.int64), 0) - 1
        slot = torch.where(skey != INT_MAX, uid.clamp_max(max_out),
                           torch.full_like(uid, max_out))
        # duplicate keys write identical values; slot max_out is dropped
        out_key = torch.full((max_out + 1,), INT_MAX, dtype=torch.int64,
                             device=skey.device)
        out_key[slot] = skey
        out_key = out_key[:max_out]

        ovalid = out_key != INT_MAX
        k_ = torch.where(ovalid, out_key, torch.zeros_like(out_key))
        cx = k_ % ox
        cy = torch.div(k_, ox, rounding_mode="floor") % oy
        cz = torch.div(k_, ox * oy, rounding_mode="floor")
        oc = torch.stack([cz, cy, cx], -1)
        out_coords_all.append(torch.where(
            ovalid[:, None], oc, torch.full_like(oc, -1)).to(torch.int32))

        skeys, order = torch.sort(keys)
        qs, oks = [], []
        for dz, dy, dx in taps:
            sz_ = cz * stride[0] - padding[0] + dz
            sy_ = cy * stride[1] - padding[1] + dy
            sx_ = cx * stride[2] - padding[2] + dx
            oks.append(ovalid & (sz_ >= 0) & (sz_ < z) & (sy_ >= 0)
                       & (sy_ < y) & (sx_ >= 0) & (sx_ < x))
            qs.append((sz_ * y + sy_) * x + sx_)
        q = torch.stack(qs).reshape(-1)
        ok = torch.stack(oks).reshape(-1)
        query = torch.where(ok, q, torch.full_like(q, INT_MAX - 1))
        gathers.append(_lookup(skeys, query, order, n))
        occ.append(first.sum())  # uniques before the cap
    return ConvPlan(
        torch.stack(gathers).to(torch.int32), torch.stack(out_coords_all),
        (oz, oy, ox), ksize,
        true_occ=torch.stack(occ).to(torch.int32),
    )


def apply_sparse_conv(features: torch.Tensor, plan: ConvPlan,
                      weights: torch.Tensor) -> torch.Tensor:
    """Gather-GEMM conv body (pull formulation, no scatter).

    features (B, N_in, Cin); weights (K, Cin, Cout) with K taps in the
    plan's row-major (z, y, x) order. Returns (B, N_out, Cout).
    A CUDA tensor runs the hand-written kernel; a CPU tensor runs its plain
    PyTorch version."""
    if features.is_cuda:
        return _k.sparse_conv_cuda(features, plan.gather_idx, weights)
    if features.device.type == "cpu":
        return _k.sparse_conv_plain(features, plan.gather_idx, weights)
    raise RuntimeError(f"apply_sparse_conv: no path for {features.device}")
