"""Shared helpers of the tests that hold df3d_torch against df3d.

Inputs and weights are made once with seeded numpy and handed to both
packages: flax variables are filled leaf by leaf (no flax init run) and
carried to the torch modules by `df3d_torch.weights.state_dict_from_flax`.
"""

import contextlib

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


@contextlib.contextmanager
def recorded_jax_relus(store: list):
    """While the JAX package's modules are traced inside the block, each
    `nn.relu` call appends its input to `store`, in call order (return the
    list from the jitted function to read it)."""
    from flax import linen

    relu = linen.relu

    def recording(x):
        store.append(x)
        return relu(x)

    linen.relu = recording
    try:
        yield store
    finally:
        linen.relu = relu


@contextlib.contextmanager
def replayed_relus(jax_inputs):
    """Give the port's ReLUs (`torch.relu`, in call order) the decisions
    (x > 0) of the JAX package's ReLUs, whose inputs `recorded_jax_relus`
    gave (an NHWC map stands for the port's NCHW one, and the first of B
    equal rows for the port's one row): where the two
    disagree, the input takes JAX's sign at its own magnitude, and the
    gradient passes through unchanged. Yields the replayed disagreements,
    (call, elements, largest |x|) per call that had any; raises if a call
    has no JAX counterpart of its shape."""
    relu, flips = torch.relu, []
    calls = iter(enumerate(jax_inputs))

    def patched(x):
        i, z_jax = next(calls, (None, None))
        if z_jax is None:
            raise AssertionError(f"ReLU of {tuple(x.shape)} has no JAX call")
        z_jax = torch.from_numpy(np.array(z_jax))
        if z_jax.shape != x.shape and z_jax.dim() == 4:
            z_jax = z_jax.permute(0, 3, 1, 2)
        if z_jax.shape[1:] == x.shape[1:] and x.shape[0] == 1:
            z_jax = z_jax[:1]  # one row where JAX runs B equal ones
        if z_jax.shape != x.shape:
            raise AssertionError(f"ReLU call {i}: {tuple(x.shape)} against "
                                 f"JAX's {tuple(z_jax.shape)}")
        z = x.detach()
        want = z_jax > 0
        flip = (z > 0) != want
        if not flip.any():
            return relu(x)
        flips.append((i, int(flip.sum()), float(z[flip].abs().max())))
        signed = torch.where(want, z.abs(), -z.abs())
        return relu(torch.where(flip, x - z + signed, x))

    torch.relu = patched
    try:
        yield flips
    finally:
        torch.relu = relu
    assert next(calls, None) is None, "JAX made more ReLU calls"


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


def k2_schedule(n_levels, n_points):
    """The warp path of the K2 kernel (df3d_torch/csrc/msda.cu,
    msda_warp_kernel), emulated for one query: P lanes per head, 32 / P
    heads, each lane 4 channels. Returns (computes, reads): computes[lane]
    lists the samples (head, level, point) the lane computes, slot by slot
    (slot = level); reads[lane] lists, in summation order, the (source lane,
    slot) each of its head's L x P samples is shuffled from."""
    computes, reads = [], []
    for lane in range(32):
        head, point = divmod(lane, n_points)
        computes.append([(head, lvl, point) for lvl in range(n_levels)])
        reads.append([(head * n_points + p, lvl) for lvl in range(n_levels)
                      for p in range(n_points)])
    return computes, reads


def k2_emulate(value, spatial_shapes, sampling_locations, attention_weights):
    """The warp path's arithmetic in its order, vectorised over (B, Q): each
    lane's samples as the kernel packs them (top-left pixel * 16 + the
    corners' in-bounds mask, four corner weights with the attention weight
    folded in, 0 off the map), then per lane its head's samples taken from
    their source lanes and summed in (level, point, corner) order over its
    4 channels. Takes the kernel's shapes (nH x D = 128, D = 4P)."""
    b, len_v, nh, d = value.shape
    q, nl, npnt = sampling_locations.shape[1], *sampling_locations.shape[3:5]
    assert nh * d == 128 and d == 4 * npnt
    starts, acc_start = [], 0
    for h, w in spatial_shapes:
        starts.append(acc_start)
        acc_start += h * w
    computes, reads = k2_schedule(nl, npnt)
    packed = {}
    for lane, samples in enumerate(computes):
        for slot, (head, lvl, point) in enumerate(samples):
            h, w = spatial_shapes[lvl]
            xy = sampling_locations[:, :, head, lvl, point]
            a = attention_weights[:, :, head, lvl, point]
            px, py = xy[..., 0] * w - 0.5, xy[..., 1] * h - 0.5
            x0, y0 = torch.floor(px), torch.floor(py)
            near = (x0 >= -1) & (x0 < w) & (y0 >= -1) & (y0 < h)
            dx, dy = px - x0, py - y0
            xi = torch.where(near, x0, 0).long()
            yi = torch.where(near, y0, 0).long()
            x_lo, x_hi, y_lo, y_hi = xi >= 0, xi + 1 < w, yi >= 0, yi + 1 < h
            inb = [x_lo & y_lo, x_hi & y_lo, x_lo & y_hi, x_hi & y_hi]
            mask = sum(m.long() << k for k, m in enumerate(inb)) * near
            corner = torch.where(near, (starts[lvl] + yi * w + xi) * 16 + mask,
                                 0)
            cw = [a * ((1 - dx) * (1 - dy)), a * (dx * (1 - dy)),
                  a * ((1 - dx) * dy), a * (dx * dy)]
            cw = [torch.where(near & m, c, 0.0) for c, m in zip(cw, inb)]
            packed[lane, slot] = (corner, cw)
    rows = value.view(b, len_v, 32, 4)   # (camera, pixel, lane, 4 channels)
    cam = torch.arange(b).view(b, 1)
    out = value.new_zeros(b, q, 32, 4)
    for lane in range(32):
        acc = value.new_zeros(b, q, 4)
        for src, slot in reads[lane]:
            corner, cw = packed[src, slot]
            w = spatial_shapes[computes[src][slot][1]][1]
            base = corner >> 4
            for k, step in enumerate((0, 1, w, w + 1)):
                hit = (corner >> k) & 1 == 1
                pix = torch.where(hit, base + step, 0)
                v = rows[cam, pix, lane] * hit[..., None]
                acc = acc + v * cw[k][..., None]
        out[:, :, lane] = acc
    return out.view(b, q, nh * d)


def k2_bwd_emulate(value, spatial_shapes, sampling_locations,
                   attention_weights, grad_output):
    """The arithmetic of K2's backward (df3d_torch/csrc/msda.cu,
    `sample_grads` and both backward kernels), vectorised over the
    samples: positions loc * size - 0.5, the four corners with their
    in-bounds masks, s_c = g . v_c over the head's channels (0 off the
    map), then dattn = sum_c bilinear_c s_c, dloc = a (W, H) (d/ddx, d/ddy)
    in the kernel's form, dvalue += g a bilinear_c at each in-bounds
    corner. Returns (dvalue, dloc, dattn)."""
    b, len_v, nh, d = value.shape
    q, nl, npnt = sampling_locations.shape[1], *sampling_locations.shape[3:5]
    g = grad_output.view(b, q, nh, 1, d)
    rows = value.reshape(b * len_v * nh, d)
    dvalue = torch.zeros_like(rows)
    dloc = torch.zeros_like(sampling_locations)
    dattn = torch.zeros_like(attention_weights)
    batch = torch.arange(b).view(b, 1, 1, 1)
    heads = torch.arange(nh).view(1, 1, nh, 1)
    start = 0
    for lid, (h, w) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lid]
        a = attention_weights[:, :, :, lid]
        px, py = loc[..., 0] * w - 0.5, loc[..., 1] * h - 0.5
        x0, y0 = torch.floor(px), torch.floor(py)
        dx, dy = px - x0, py - y0
        s = []
        for cx, cy, bil in ((x0, y0, (1 - dx) * (1 - dy)),
                            (x0 + 1, y0, dx * (1 - dy)),
                            (x0, y0 + 1, (1 - dx) * dy),
                            (x0 + 1, y0 + 1, dx * dy)):
            inb = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
            pix = start + (cy.clamp(0, h - 1) * w + cx.clamp(0, w - 1)).long()
            idx = ((batch * len_v + pix) * nh + heads).reshape(-1)
            v = rows[idx].view(b, q, nh, npnt, d)
            s.append(torch.where(inb, (g * v).sum(-1), 0.0))
            contrib = g * torch.where(inb, a * bil, 0.0)[..., None]
            dvalue.index_add_(0, idx, contrib.reshape(-1, d))
        s00, s01, s10, s11 = s
        dattn[:, :, :, lid] = (s00 * ((1 - dx) * (1 - dy))
                               + s01 * (dx * (1 - dy))
                               + s10 * ((1 - dx) * dy) + s11 * (dx * dy))
        gx = (s01 - s00) * (1 - dy) + (s11 - s10) * dy
        gy = (s10 - s00) * (1 - dx) + (s11 - s01) * dx
        dloc[:, :, :, lid] = torch.stack([a * w * gx, a * h * gy], -1)
        start += h * w
    return dvalue.view_as(value), dloc, dattn
