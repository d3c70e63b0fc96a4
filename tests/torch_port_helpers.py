"""Shared helpers of the tests that hold df3d_torch against df3d.

Inputs and weights are made once with seeded numpy and handed to both
packages: flax variables are filled leaf by leaf (no flax init run) and
carried to the torch modules by `df3d_torch.weights.state_dict_from_flax`.
"""

import jax
import numpy as np
import torch

from df3d_torch.weights import state_dict_from_flax


def seeded_variables(shapes, rng: np.random.RandomState, out_scale=None):
    """Fill a tree of `jax.ShapeDtypeStruct` {"params", "batch_stats"} with
    seeded values as nested dicts of numpy arrays: He-normal kernels over
    prod(shape[:-1]), small biases, non-trivial BatchNorm affine parameters
    and running statistics. `out_scale(path)` may rescale a leaf (e.g. to
    keep heatmap logits away from the sigmoid clamp)."""

    def fill(path, leaf):
        names = [getattr(k, "key", str(k)) for k in path]
        shape, name = tuple(leaf.shape), names[-1]
        if name == "kernel":
            v = rng.randn(*shape) * np.sqrt(2.0 / np.prod(shape[:-1]))
        elif names[0] == "batch_stats" and name == "var":
            v = 0.5 + rng.rand(*shape)
        elif names[0] == "batch_stats":
            v = 0.1 * rng.randn(*shape)
        elif name == "scale":
            v = 1.0 + 0.1 * rng.randn(*shape)
        else:
            v = 0.1 * rng.randn(*shape)
        if out_scale is not None:
            v = out_scale(names, v)
        return v.astype(np.float32)

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return jax.tree_util.tree_map(np.asarray, tree)


def load_flax(module: torch.nn.Module, variables) -> torch.nn.Module:
    """Carry flax variables into `module` (strictly), freeze it and put it
    in eval mode."""
    module.load_state_dict(state_dict_from_flax(module, variables))
    return module.requires_grad_(False).eval()


def sparse_inputs(rng, batch=2, shape=(8, 12, 12), n=64, cin=5, pad_to=96):
    """Per-sample random occupancy, key-sorted rows then -1 padding:
    (features (B, pad_to, cin), coords (B, pad_to, 3)) as numpy."""
    all_coords, all_feats = [], []
    for _ in range(batch):
        sites = set()
        while len(sites) < n:
            sites.add(tuple(rng.randint(0, s) for s in shape))
        coords = np.array(sorted(sites), np.int32)
        feats = rng.randn(n, cin).astype(np.float32)
        pad = pad_to - n
        all_coords.append(
            np.concatenate([coords, -np.ones((pad, 3), np.int32)]))
        all_feats.append(
            np.concatenate([feats, np.zeros((pad, cin), np.float32)]))
    return np.stack(all_feats), np.stack(all_coords)


def k1_schedule(gather_idx, n_in, k, tile_rows, chunk=8):
    """The schedule of the K1 v2 kernel (df3d_torch/csrc/sparse_conv.cu),
    emulated: per sample, tile of `tile_rows` output rows and tap with a
    hit, the tile's hit rows in row order, cut into chunks of `chunk` slots
    (the last one partly empty). Yields (b, tap, rows, sources): rows
    (n_chunks, chunk) output rows of each slot, -1 for an empty slot, and
    sources the input rows they gather."""
    b_size, total = gather_idx.shape
    n_out = total // k
    idx = gather_idx.view(b_size, k, n_out).long()
    for b in range(b_size):
        for m0 in range(0, n_out, tile_rows):
            tile = idx[b, :, m0:m0 + tile_rows]
            for t in range(k):
                hit = torch.nonzero((tile[t] >= 0) & (tile[t] < n_in))[:, 0]
                if hit.numel() == 0:
                    continue
                slots = -(-hit.numel() // chunk) * chunk
                rows = torch.full((slots,), -1, dtype=torch.long)
                rows[:hit.numel()] = m0 + hit
                src = torch.zeros(slots, dtype=torch.long)
                src[:hit.numel()] = tile[t, hit]
                yield b, t, rows.view(-1, chunk), src.view(-1, chunk)


def k1_emulate(features, gather_idx, weights, tile_rows):
    """K1 v2's arithmetic in the kernel's order: per sample and tile, taps
    in order, each chunk of compacted hit rows multiplied by W[t] and added
    into the tile's accumulator at its rows; empty slots are dropped.
    Returns (output (B, N_out, Cout), executed (B, K, N_out) counts of how
    often each (row, tap) was added in)."""
    b_size, n_in, _ = features.shape
    k, _, cout = weights.shape
    n_out = gather_idx.shape[1] // k
    out = features.new_zeros(b_size, n_out, cout)
    executed = torch.zeros(b_size, k, n_out, dtype=torch.long)
    for b, t, rows, src in k1_schedule(gather_idx, n_in, k, tile_rows):
        for r, s in zip(rows, src):
            prod = features[b, s] @ weights[t]
            keep = r >= 0
            out[b, r[keep]] += prod[keep]
            executed[b, t, r[keep]] += 1
    return out, executed
