"""Dense 3D grid ops for the backbone's dense tail (port of df3d/ops/dense3d.py).

Channel-last (B, Z, Y, X, C) features with the active-site mask riding
along; a submanifold conv is a dense conv times the input mask, a strided
conv's new mask is the any-pool dilation of the input mask (exact spconv
semantics, uncapped). The dense tail is plain XLA in the JAX package, so
`F.conv3d` computes it here. `sparsify` takes the grid back to rows for the
fusion hook.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from df3d_torch.ops.sparse import SparseTensor, _triple


@dataclasses.dataclass
class DenseTensor:
    """Dense twin of SparseTensor: features (B, Z, Y, X, C) and an
    active-site mask (B, Z, Y, X)."""

    features: torch.Tensor
    mask: torch.Tensor

    @property
    def valid(self):
        """Alias so the layer modules treat dense and sparse alike."""
        return self.mask

    def with_features(self, feats: torch.Tensor) -> "DenseTensor":
        return DenseTensor(feats, self.mask)


@dataclasses.dataclass(frozen=True)
class DenseConvSpec:
    """Plan-free stand-in for ConvPlan on the dense tail: the conv geometry."""

    ksize: tuple = (3, 3, 3)
    stride: tuple = (1, 1, 1)
    padding: tuple = (1, 1, 1)


def densify(st: SparseTensor) -> DenseTensor:
    """SparseTensor -> DenseTensor; padding rows are dropped."""
    z, y, x = st.spatial_shape
    b, n, c = st.features.shape
    cells = z * y * x
    valid, keys = st.valid, st.keys()
    flat_idx = torch.where(valid, keys, torch.full_like(keys, cells))
    feats = st.features.new_zeros(b, cells + 1, c)
    feats.scatter_(1, flat_idx[..., None].expand(-1, -1, c), st.features)
    mask = torch.zeros(b, cells + 1, dtype=torch.bool, device=valid.device)
    mask.scatter_(1, flat_idx, valid)
    return DenseTensor(feats[:, :cells].reshape(b, z, y, x, c),
                       mask[:, :cells].reshape(b, z, y, x))


def sparsify(dt: DenseTensor, max_rows: int) -> SparseTensor:
    """DenseTensor -> SparseTensor of `max_rows` rows per sample: the first
    `max_rows` active cells in key order, then padding rows (coords -1,
    features 0), the row order the JAX package's cumsum-rank compaction
    gives."""
    b, z, y, x, c = dt.features.shape
    cells = z * y * x
    flat_m = dt.mask.reshape(b, cells)
    # stable sort of the inactive flag: active cells first, in key order
    order = torch.sort((~flat_m).to(torch.int8), dim=1, stable=True).indices
    if max_rows > cells:
        order = torch.cat([order, order.new_zeros(b, max_rows - cells)], 1)
    key = order[:, :max_rows]
    ok = flat_m.gather(1, key)
    ok &= torch.arange(max_rows, device=key.device) < cells
    coords = torch.stack([key // (y * x), (key // x) % y, key % x], -1)
    coords = torch.where(ok[..., None], coords, -1).to(torch.int32)
    feats = dt.features.reshape(b, cells, c).gather(
        1, key[..., None].expand(-1, -1, c))
    return SparseTensor(feats * ok[..., None].to(feats.dtype), coords,
                        (z, y, x))


def dense_conv(dt: DenseTensor, w_taps: torch.Tensor, ksize, stride=1,
               padding=1, subm: bool = True) -> DenseTensor:
    """Conv with sparse-layout weights (K, Cin, Cout) on the dense grid.
    subm=True: output masked to the input's active set. subm=False: the
    active set becomes the dilated input mask."""
    ksize, stride, padding = _triple(ksize), _triple(stride), _triple(padding)
    cin, cout = w_taps.shape[1:]
    # (K, Cin, Cout) -> (kz, ky, kx, Cin, Cout) -> (Cout, Cin, kz, ky, kx)
    w = w_taps.reshape(*ksize, cin, cout).permute(4, 3, 0, 1, 2)
    x = dt.features.permute(0, 4, 1, 2, 3).contiguous()
    out = F.conv3d(x, w, stride=stride, padding=padding)
    out = out.permute(0, 2, 3, 4, 1)
    if subm:
        assert stride == (1, 1, 1)
        mask = dt.mask
    else:
        mask = F.max_pool3d(dt.mask[:, None].to(out.dtype), ksize, stride,
                            padding)[:, 0] > 0
    return DenseTensor(out * mask[..., None].to(out.dtype), mask)


def bev_from_dense(dt: DenseTensor) -> torch.Tensor:
    """(B, Z, Y, X, C) -> (B, Y, X, Z*C) (HeightCompression)."""
    x = dt.features * dt.mask[..., None].to(dt.features.dtype)
    b, z, y, xx, c = x.shape
    return x.permute(0, 2, 3, 1, 4).reshape(b, y, xx, z * c)
