"""Shared helpers of the tests that hold df3d_torch against df3d.

Inputs and weights are made once with seeded numpy and handed to both
packages: flax variables are filled leaf by leaf (no flax init run) and
carried to the torch modules by `df3d_torch.weights.state_dict_from_flax`.

Every port test module but tests/test_torch_train_step.py imports
`one_torch_thread`, an autouse fixture: its tests run torch's CPU ops on
one thread, as the data-parallel ranks do
(`torch_parallel_ranks.one_thread`), so that several test workers on the
machine's cores do not park each other's intra-op threads. The CenterPoint
step test compares the port's step with JAX's without replaying ReLU
decisions, and at one thread a neck ReLU input of the port's step lands
on the other side of 0 from JAX's; it runs at torch's default.
"""

import contextlib
import dataclasses

import jax
import numpy as np
import pytest
import torch

from df3d_torch.weights import state_dict_from_flax


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch's intra-op threads at one for the module that imports this
    fixture, restored after it."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


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


# the logs the aux objectives add to a fused step's
AUX_LOGS = ("aux_seg_loss", "aux_consistency_loss", "aux_loss")


# the aux weights (seg, consistency) at which the fused step tests run
# JAX's aux step: (0, 0) is its aux-off step
AUX_WEIGHTS = {"aux_off": (0.0, 0.0), "aux_on": (1.0, 0.1)}


def without_aux(tree):
    """A tree of flax variables, their shapes or their gradients without
    the aux segmentation head's `aux_seg` subtrees, at any depth (the top
    of a fused model's collections, a Voxel R-CNN tree's "rpn")."""
    if not hasattr(tree, "items"):
        return tree
    return {k: without_aux(v) for k, v in tree.items() if k != "aux_seg"}


def new_without_aux(new):
    """A JAX `TrainState` after a step (behind `record_grads`, whose state
    holds the gradients) without the aux head's leaves."""
    return new.replace(
        params=without_aux(new.params),
        opt_state=(without_aux(new.opt_state[0]),) + tuple(new.opt_state[1:]))


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
def replayed_relus(jax_inputs, skip=None):
    """Give the port's ReLUs (`torch.relu`, in call order) the decisions
    (x > 0) of the JAX package's ReLUs, whose inputs `recorded_jax_relus`
    gave (an NHWC map stands for the port's NCHW one, and the first of B
    equal rows for the port's one row): where the two
    disagree, the input takes JAX's sign at its own magnitude, and the
    gradient passes through unchanged. The ReLUs inside `skip` (a module,
    or a tuple of modules and Nones, whose JAX calls are not in
    `jax_inputs`) are left alone. Yields the
    replayed disagreements, (call, elements, largest |x|) per call that had
    any; raises if a call has no JAX counterpart of its shape."""
    relu, flips, paused = torch.relu, [], []
    calls = iter(enumerate(jax_inputs))
    skip = skip if isinstance(skip, tuple) else (skip,)
    hooks = [h for m in skip if m is not None for h in (
        m.register_forward_pre_hook(lambda *_: paused.append(True)),
        m.register_forward_hook(lambda *_: paused.clear()))]

    def patched(x):
        if paused:
            return relu(x)
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
        for h in hooks:
            h.remove()
    assert next(calls, None) is None, "JAX made more ReLU calls"


@contextlib.contextmanager
def recorded_plans(module, plans: list):
    """Appends the gather index of every plan `module`'s backbones build
    while the block runs."""
    names = ("build_subm_plan", "build_conv_plan")
    builders = {n: getattr(module, n) for n in names}

    def recording(build):
        def wrapped(*args, **kwargs):
            plan = build(*args, **kwargs)
            plans.append(plan.gather_idx)
            return plan
        return wrapped

    for n, build in builders.items():
        setattr(module, n, recording(build))
    try:
        yield plans
    finally:
        for n, build in builders.items():
            setattr(module, n, build)


def port_config(jax_cfg, like):
    """The port's counterpart of a JAX package config dataclass: `like` is
    an instance of the port's class (its defaults); every field of the
    port's class takes the JAX config's value, nested configs (and tuples
    of them) converted the same way."""
    if dataclasses.is_dataclass(jax_cfg):
        return type(like)(**{
            f.name: port_config(getattr(jax_cfg, f.name), getattr(like, f.name))
            for f in dataclasses.fields(like)})
    if (isinstance(jax_cfg, tuple) and jax_cfg
            and dataclasses.is_dataclass(jax_cfg[0])):
        return tuple(port_config(v, like[0]) for v in jax_cfg)
    return jax_cfg


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


def k2_bwd_dvalue_by_rows(value, spatial_shapes, sampling_locations,
                          attention_weights, grad_output, placement=None):
    """dvalue as K2's backward forms it without float atomics
    (df3d_torch/csrc/msda.cu, passes A1 to C): one record (dvalue row,
    (query, head) unit, attention x bilinear weight w) per in-bounds corner
    of each sample of a unit whose g is not 0, each row's bound M = (its
    largest |w|) x (the largest |g|); the records placed by row in the
    order of `placement` (a torch.Generator standing in for the order the
    kernel's integer atomics happen to take; else emission order); each
    row's sum of the f32 products g[unit, c] * w taken exactly: each scaled
    by 2^e, e = 61 - exponent(M) - ceil(log2(records)) within [-126, 126],
    rounded to an integer (half to even), the integers summed, the total
    scaled back and rounded to f32. Returns (dvalue, the most records of
    one row)."""
    b, len_v, nh, d = value.shape
    q, nl, npnt = sampling_locations.shape[1], *sampling_locations.shape[3:5]
    g = grad_output.reshape(b * q * nh, d)
    g_max = g.abs().amax(-1)
    live = (g_max > 0).view(b, q, nh)
    unit = torch.arange(b * q * nh).view(b, q, nh, 1)
    batch = torch.arange(b).view(b, 1, 1, 1)
    heads = torch.arange(nh).view(1, 1, nh, 1)
    rows, units, weights, start = [], [], [], 0
    for lid, (h, w) in enumerate(spatial_shapes):
        loc = sampling_locations[:, :, :, lid]
        a = attention_weights[:, :, :, lid]
        px, py = loc[..., 0] * w - 0.5, loc[..., 1] * h - 0.5
        x0, y0 = torch.floor(px), torch.floor(py)
        near = (x0 >= -1) & (x0 < w) & (y0 >= -1) & (y0 < h)
        dx, dy = px - x0, py - y0
        for (ox, oy), bil in (((0, 0), (1 - dx) * (1 - dy)),
                              ((1, 0), dx * (1 - dy)),
                              ((0, 1), (1 - dx) * dy), ((1, 1), dx * dy)):
            cx, cy = x0 + ox, y0 + oy
            inb = (near & (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
                   & live[..., None])
            pix = start + (torch.where(inb, cy, 0) * w
                           + torch.where(inb, cx, 0)).long()
            rows.append(((batch * len_v + pix) * nh + heads)[inb])
            units.append(unit.expand(b, q, nh, npnt)[inb])
            weights.append((a * bil)[inb])
        start += h * w
    rows, units, weights = torch.cat(rows), torch.cat(units), torch.cat(weights)
    if placement is not None:
        perm = torch.randperm(len(rows), generator=placement)
        rows, units, weights = rows[perm], units[perm], weights[perm]
    n_rows = b * len_v * nh
    counts = torch.bincount(rows, minlength=n_rows)
    def finite_abs(x):
        return torch.where(torch.isfinite(x), x.abs(), 0.0)

    w_max = torch.zeros(n_rows).scatter_reduce(0, rows, finite_abs(weights),
                                               "amax")
    bound = (w_max * finite_abs(g).max()).clamp(max=3.4e38)
    exp = torch.frexp(bound)[1]
    log2n = torch.ceil(torch.log2(counts.clamp(min=1).double())).long()
    e = (61 - exp - log2n).clamp(-126, 126).double()
    prods = (g[units] * weights[:, None]).double()  # f32 products
    scaled = torch.round(prods * torch.exp2(e[rows])[:, None]).long()
    sums = torch.zeros(n_rows, d, dtype=torch.long).index_add_(0, rows,
                                                                scaled)
    dvalue = (sums.double() * torch.exp2(-e)[:, None]).float()
    dvalue[counts == 0] = 0.0
    return dvalue.view_as(value), int(counts.max()) if len(rows) else 0


def record_grads():
    """An optax transform that passes the gradients through and keeps them
    as its state (chain it ahead of the optimizer to read a step's raw
    gradients from `opt_state[0]`)."""
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(np.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def voxelrcnn_stop_gradient_step(model, head, cfg, fused: bool,
                                 aux_weights=None, image_hw=None):
    """The JAX package's `make_voxelrcnn_train_step` composed from its own
    functions with the proposals' gradient stopped, as pcdet's
    `torch.no_grad()` proposal and proposal-target layers stop it:
    `step(state, batch, rng) -> (state, logs, extra)`, extra holding the
    ReLU inputs of the training forward in call order (`relus`), the
    proposals (`proposals`: rois, scores, mask), the proposal target
    layer's output (`targets`), its noise (`noise`) and the consistency
    pair the forward sows (`pair`, when there is one). With
    `aux_weights` (seg, consistency), the step's aux branch
    (`_fused_aux_terms`, the images `image_hw`) at those weights, which
    may be traced."""
    from df3d.models.detectors.voxel_rcnn import (
        assign_rpn_targets, build_anchors, proposal_layer,
        voxel_rcnn_train_losses,
    )
    from df3d.models.heads.voxelrcnn_head import sample_rois_for_training
    from df3d.ops.voxelize import voxelize_batch
    from df3d.train.trainer import (
        _collect_sown, _fused_aux_terms, _overflow_log,
    )

    anchors = build_anchors(cfg)

    def step(state, batch, rng):
        res = voxelize_batch(batch["points"], batch["points_valid"],
                             cfg.voxel_size, cfg.pc_range, cfg.grid_size,
                             cfg.max_voxels, cfg.max_points_per_voxel)
        gt = batch["gt_boxes"][..., :7]
        rpn_targets = assign_rpn_targets(cfg, anchors, gt,
                                         batch["gt_classes"],
                                         batch["gt_valid"])
        fwd = (res.features, res.coords)
        if fused:
            fwd += (batch["images"], batch["proj"])

        def loss_fn(params):
            with recorded_jax_relus([]) as relus:
                preds, updates = model.apply(
                    {"params": params["rpn"],
                     "batch_stats": state.batch_stats["rpn"]}, *fwd,
                    train=True, mutable=["batch_stats", "intermediates"])
                rois, roi_scores, roi_mask = jax.lax.stop_gradient(
                    proposal_layer(cfg, preds, anchors, train=True))
                keys = jax.random.split(rng, rois.shape[0])
                targets = jax.vmap(
                    lambda r, s, m, g, gv, key: sample_rois_for_training(
                        key, r, s, m, g, gv, cfg.rcnn))(
                    rois, roi_scores, roi_mask, gt, batch["gt_valid"], keys)
                (cls, reg), r_updates = head.apply(
                    {"params": params["rcnn"],
                     "batch_stats": state.batch_stats["rcnn"]},
                    targets["rois"], targets["mask"], preds["ms"],
                    train=True, mutable=["batch_stats"])
            total, logs = voxel_rcnn_train_losses(
                cfg, preds, {"cls": cls, "reg": reg}, rpn_targets, targets)
            if aux_weights is not None:
                a_total, a_logs = _fused_aux_terms(
                    updates, batch, image_hw, *aux_weights)
                total = total + a_total
                logs = dict(logs, **a_logs)
                logs["loss"] = total
            logs["cap_overflow"] = _overflow_log(updates)
            noise = jax.vmap(lambda k: jax.random.uniform(
                k, roi_scores.shape[1:]) * 1e-3)(keys)
            extra = dict(relus=relus, targets=targets, noise=noise,
                         proposals=(rois, roi_scores, roi_mask))
            pairs = _collect_sown(updates.get("intermediates", {}),
                                  "aux_consistency")
            if pairs:
                extra["pair"] = pairs[0]
            return total, (logs, updates, r_updates, extra)

        (_, (logs, updates, r_updates, extra)), grads = jax.value_and_grad(
            loss_fn, has_aux=True)(state.params)
        state = state.apply_gradients(grads=grads, batch_stats={
            "rpn": updates["batch_stats"], "rcnn": r_updates["batch_stats"]})
        return state, logs, extra

    return step


def voxelrcnn_variables(jmodel, jhead, fwd, roi_per_image, seed,
                        out_scale=None):
    """Seeded {"rpn", "rcnn"} params and batch_stats (no flax init run):
    the first stage's shapes from `fwd` (its inputs after voxelizing), the
    head's from the stage tensors it returns."""
    import jax.numpy as jnp

    key = jax.random.PRNGKey(0)
    preds, rpn = jax.eval_shape(
        lambda *a: jmodel.init_with_output(key, *a, train=False), *fwd)
    rpn = seeded_variables(rpn, np.random.RandomState(seed), out_scale)
    b = fwd[0].shape[0]
    rcnn = seeded_variables(jax.eval_shape(
        lambda ms: jhead.init(
            key, jnp.zeros((b, roi_per_image, 7)).at[..., 3:6].set(1.0),
            jnp.ones((b, roi_per_image), bool), ms, train=False),
        preds["ms"]), np.random.RandomState(seed + 1), out_scale)
    return dict(
        params={"rpn": rpn["params"], "rcnn": rcnn["params"]},
        batch_stats={"rpn": rpn["batch_stats"], "rcnn": rcnn["batch_stats"]})


def small_box_residuals(names, v):
    """Both stages' box regression kernels (the anchor head's `conv_box`,
    the RCNN head's `reg_pred`) at a tenth of their seeded He scale, so
    that they predict residuals of the size a trained detector does
    (car-sized RoIs near their anchors, refinements near their RoIs). At
    the full scale they reach e^2 to e^3 in size, and the corner loss
    carries the head's f32 rounding times that (2e-5 of it seen, beyond
    the logs' rtol)."""
    if names[-2] in ("conv_box", "reg_pred") and names[-1] == "kernel":
        return v * 0.1
    return v


def gts_near_proposals(model, step, batch):
    """Three gt cars a sample near the proposals 0, 5 and 10 of the port's
    training forward on these weights and points (a copy of the model):
    moved by (0.2, -0.1, 0.05) m and turned by 0.1 rad, the second turned
    by pi more (anti-aligned with its RoI), rounded to 1e-3 (so that the
    batch does not move with the forward's rounding, which the CPU's
    thread count changes); a fourth, padding slot."""
    import copy

    from df3d_torch.models.detectors.voxel_rcnn import proposal_layer

    probe = copy.deepcopy(model).train()
    t = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        res = step.voxelize(t)
        preds, _ = probe.rpn(res.features, res.coords,
                             *step.model_inputs(t))
        rois, _, mask = proposal_layer(step.cfg, preds, probe.anchors,
                                       train=True)
    assert mask[:, 10].all()
    gts = rois[:, [0, 5, 10]].numpy() + np.float32(
        [0.2, -0.1, 0.05, 0.0, 0.0, 0.0, 0.1])
    gts[:, 1, 6] += np.pi
    gts = np.round(gts, 3)
    b = gts.shape[0]
    return {"gt_boxes": np.concatenate(
                [gts, np.zeros((b, 1, 7), np.float32)], 1).astype(np.float32),
            "gt_classes": np.zeros((b, 4), np.int32),
            "gt_valid": np.arange(4)[None].repeat(b, 0) < 3}


def voxelrcnn_jax_runs(jmodel, jhead, jcfg, batch, variables, lr: float,
                       total_steps: int, with_package_step: bool = True,
                       aux_weights=None, image_hw=None) -> list:
    """The JAX side of `voxelrcnn_step_run`: the stop-gradient composition
    (`voxelrcnn_stop_gradient_step`) and, with `with_package_step`, the
    JAX package's own `make_voxelrcnn_train_step`, in one jitted program
    with `adam_onecycle(lr, total_steps)` behind a `record_grads`
    transform, from the flax `variables` on the numpy `batch`. With
    `aux_weights`, a list of (seg, consistency) weights, the composition
    is the aux step with the weights as traced arguments, and the program
    runs once per entry. -> a list of {"sg": (state, logs, extra), "pkg":
    (state, logs)} in numpy, one per run."""
    import jax.numpy as jnp
    import optax

    from df3d.train.schedules import adam_onecycle
    from df3d.train.trainer import TrainState, make_voxelrcnn_train_step

    tx = optax.chain(record_grads(), adam_onecycle(lr, total_steps))
    jstate = TrainState.create(apply_fn=None, params=variables["params"],
                               tx=tx, batch_stats=variables["batch_stats"])
    fused = "images" in batch
    package = make_voxelrcnn_train_step(jmodel, jhead, jcfg, fused=fused)

    @jax.jit
    def run(state, batch, rng, w):
        composed = voxelrcnn_stop_gradient_step(
            jmodel, jhead, jcfg, fused,
            None if aux_weights is None else (w[0], w[1]), image_hw)
        out = {"sg": composed(state, batch, rng)}
        if with_package_step:
            out["pkg"] = package(state, batch, rng)
        return out

    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    return [jax.tree_util.tree_map(np.array, run(
        jstate, jbatch, jax.random.PRNGKey(2), jnp.float32(w)))
        for w in (aux_weights or [(0.0, 0.0)])]


def voxelrcnn_step_run(jmodel, jhead, jcfg, state, step, batch, variables,
                       lr: float, total_steps: int,
                       with_package_step: bool = True,
                       jax_out: dict | None = None) -> dict:
    """One Voxel R-CNN training step both ways, from the same flax
    `variables` (already in the port's `state`) and numpy `batch`: the JAX
    side (`voxelrcnn_jax_runs`, or `jax_out`, one of its runs), then the
    port's `step` with JAX's noise draws, ReLU decisions and proposals,
    the port's own proposals and its proposal target layer's output
    recorded.

    The proposals carry no gradient, so the second stage reads them as an
    input, as it reads the noise: the port's second stage takes JAX's, and
    the port's own are held against them (`check_sampled`). The RoIs'
    coordinates reach 30 m, and the first stage's f32 rounding moves them
    by ~1e-5 m, which the RoI grid's offsets and their batch statistics
    turn into gradient gaps of up to 3x the tolerance (seen on the fused
    step). The ReLUs of the frozen image branch and of an aux head are not
    replayed (JAX's DeepLabV3 runs layer4 and ASPP too).

    -> dict: model, state, logs, grads (by name), new / jlogs / targets /
    proposals (the composition's state, logs, sampled targets and
    proposals), sampled and own_proposals (the port's), flips (the
    replayed ReLUs), before (the state dict ahead of the step), pkg (the
    package step's (state, logs) or None), jpair (the composition's
    consistency pair or None), outputs (the aux outputs of the port's
    forward, () without aux)."""
    import pytest

    from df3d_torch.train import trainer as ttrainer

    if jax_out is None:
        jax_out = voxelrcnn_jax_runs(jmodel, jhead, jcfg, batch, variables,
                                     lr, total_steps, with_package_step)[0]
    new, jlogs, extra = jax_out["sg"]
    fused = "images" in batch

    model = state.model
    relus, skip = extra["relus"], None
    if fused:  # the frozen image branch's ReLUs are not replayed
        skip = (model.rpn.image_branch, getattr(model.rpn, "aux_seg", None))
        n = _image_branch_relus(jmodel, variables, batch)
        relus = relus[n + int(jmodel.fused.with_aux_seg):]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sample, sampled = ttrainer.sample_rois_for_training, []
    propose, proposed = ttrainer.proposal_layer, []
    outputs = []

    def recording(*args):
        sampled.append(sample(*args))
        return sampled[-1]

    def jax_proposals(*args, **kwargs):
        proposed.append(propose(*args, **kwargs))
        return tuple(torch.from_numpy(p) for p in extra["proposals"])

    handle = model.rpn.register_forward_hook(
        lambda mod, args, out: outputs.append(args[4:]))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrainer, "sample_rois_for_training", recording)
        mp.setattr(ttrainer, "proposal_layer", jax_proposals)
        with replayed_relus(relus, skip) as flips:
            logs, grads = step.grads(
                state, {k: torch.from_numpy(v) for k, v in batch.items()},
                noise=torch.from_numpy(extra["noise"]))
    handle.remove()
    grads = dict(zip(state.param_names, [g.clone() for g in grads]))
    state = step.apply(state, list(grads.values()))
    return dict(model=model, state=state, logs=logs, grads=grads, new=new,
                jlogs=jlogs, targets=extra["targets"], sampled=sampled[0],
                proposals=extra["proposals"], own_proposals=proposed[0],
                flips=flips, before=before, pkg=jax_out.get("pkg"),
                jpair=extra.get("pair"), outputs=outputs[0])


def _image_branch_relus(jmodel, variables, batch) -> int:
    """How many ReLU calls the JAX fused model's image branch makes (its
    DeepLabV3 runs layer4 and ASPP too, which the port, needing only the
    taps, skips)."""
    from df3d.models.detectors.fused import ImageBranch

    v = {c: variables[c]["rpn"]["image_branch"]
         for c in ("params", "batch_stats")}
    with recorded_jax_relus([]) as relus:
        jax.eval_shape(lambda im: ImageBranch(jmodel.fused).apply(
            v, im, False), batch["images"])
    return len(relus)


def tol(ref):
    return 1e-4 * np.abs(ref).max() + 1e-6


def check_relu_decisions(r):
    flips = r["flips"]
    assert sum(n for _, n, _ in flips) <= 4, flips
    assert all(z < 1e-4 for *_, z in flips), flips


def check_logs(r, jlogs):
    """Every log; JAX's aux logs where the port's step has none (its aux
    step at weights 0) are exact zeros."""
    if "aux_loss" in jlogs and "aux_loss" not in r["logs"]:
        assert all(jlogs[k] == 0.0 for k in AUX_LOGS)
        jlogs = {k: v for k, v in jlogs.items() if k not in AUX_LOGS}
    assert set(r["logs"]) == set(jlogs)
    assert int(r["logs"]["cap_overflow"]) == int(jlogs["cap_overflow"])
    assert int(jlogs["cap_overflow"]) > 0  # the caps drop rows here
    for k, v in jlogs.items():
        np.testing.assert_allclose(r["logs"][k].item(), v, rtol=1e-5,
                                   err_msg=k)
    assert jlogs["rcnn_reg_loss"] > 0 and jlogs["rcnn_corner_loss"] > 0
    assert r["state"].step == 1


def check_sampled(r):
    """The port's own proposals: roi_mask exactly, RoIs and scores to the
    tolerance; on JAX's proposals, the proposal target layer picks the
    same RoIs, scores and gts, mask and reg_valid exactly, and the cls
    targets (the RoIs' 3D IoUs mapped from [0.25, 0.75] to [0, 1]: twice
    the rotated clipping's f32 rounding, ~1e-5) to the tolerance."""
    (rois, scores, mask), want_p = r["own_proposals"], r["proposals"]
    np.testing.assert_array_equal(mask.numpy(), want_p[2])
    for got, want in ((rois, want_p[0]), (scores, want_p[1])):
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tol(want))
    got, want = r["sampled"], r["targets"]
    for k in ("rois", "roi_scores", "gt_of_roi", "mask", "reg_valid"):
        np.testing.assert_array_equal(got[k].numpy(), want[k], err_msg=k)
    np.testing.assert_allclose(got["cls_targets"].numpy(),
                               want["cls_targets"], rtol=0,
                               atol=tol(want["cls_targets"]))
    assert want["reg_valid"].any() and (want["mask"]
                                        & ~want["reg_valid"]).any()


def check_gradients(r, want_grads, names=None):
    from df3d_torch.weights import params_from_flax

    want = params_from_flax(r["model"], want_grads)
    trainable = {n for n in want if not n.startswith("rpn.image_branch.")}
    assert trainable == set(r["grads"])
    for name in sorted(names or trainable):
        ref = want[name].numpy()
        np.testing.assert_allclose(r["grads"][name].numpy(), ref, rtol=0,
                                   atol=tol(ref), err_msg=name)


def check_batch_stats(r, new):
    want = state_dict_from_flax(r["model"], {"params": new.params,
                                             "batch_stats": new.batch_stats})
    got = r["model"].state_dict()
    stats = [k for k in want if k.endswith(("running_mean", "running_var"))]
    moved = {k for k in stats if not torch.equal(want[k], r["before"][k])}
    assert any(k.startswith("rcnn.") for k in moved)
    assert any(k.startswith("rpn.") for k in moved)
    for k in stats:
        ref = want[k].numpy()
        np.testing.assert_allclose(got[k].numpy(), ref, rtol=0,
                                   atol=tol(ref), err_msg=k)
    return moved


def check_updated_parameters(r):
    from df3d_torch.train.schedules import global_norm
    from df3d_torch.weights import params_from_flax

    want = state_dict_from_flax(r["model"], {
        "params": r["new"].params, "batch_stats": r["new"].batch_stats})
    ref_grads = params_from_flax(r["model"], r["new"].opt_state[0])
    norm = float(global_norm(list(ref_grads.values())))
    clip = min(1.0, 10.0 / norm)
    lr0, eps = float(r["state"].tx.lr(0)), 1e-8

    def u(g):  # Adam's first update direction for a clipped gradient g
        return g / (np.abs(g) + eps)

    for name, p in r["model"].named_parameters():
        if name.startswith("rpn.image_branch."):
            continue
        ref, g = want[name].numpy(), ref_grads[name].numpy() * clip
        t = tol(ref_grads[name].numpy()) * clip
        atol = tol(ref) + lr0 * np.abs(u(g + t) - u(g - t))
        err = np.abs(p.detach().numpy() - ref)
        assert (err <= atol).all(), (name, float((err - atol).max()))


def check_package_step(r):
    """The JAX package's own step: the same logs and batch statistics as
    the composition (the forward is the same), the same RCNN head
    gradients, and other RPN gradients: some RPN leaf moves beyond the
    tolerance, and the port follows the composition there."""
    from df3d_torch.weights import params_from_flax

    new, jlogs = r["pkg"]
    check_logs(r, jlogs)
    check_batch_stats(r, new)
    rcnn = {n for n in r["grads"] if n.startswith("rcnn.")}
    check_gradients(r, new.opt_state[0], rcnn)
    pkg = params_from_flax(r["model"], new.opt_state[0])
    sg = params_from_flax(r["model"], r["new"].opt_state[0])
    off = [n for n in r["grads"] if n.startswith("rpn.")
           and np.abs(pkg[n].numpy() - sg[n].numpy()).max()
           > tol(sg[n].numpy())]
    assert "rpn.dense_head.conv_box.weight" in off, off
    return off


def assert_same(a, b):
    """Nested dicts, lists, tuples, arrays and the augmentation records of
    either package's data pipeline equal bit for bit (dtype, shape,
    values)."""
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            assert_same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            assert_same(x, y)
    elif hasattr(a, "noise_rot"):  # WorldAugParams of either package
        assert_same((a.flip_x, a.flip_y, a.noise_rot, a.noise_scale,
                     a.noise_translate), (b.flip_x, b.flip_y, b.noise_rot,
                                          b.noise_scale, b.noise_translate))
    elif a is None or isinstance(a, (str, int, float, bool)):
        assert a == b
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b), (a, b)


# ---------------------------------------------------------------------------
# tiny datasets on disk for the data pipeline and the CLIs, written with
# the port's own writers (`df3d_torch.utils.synth`)

# the narrowed KITTI preset of the runtime tests: tests/
# test_torch_voxelrcnn_train_step.py's grid and proposal counts as `--set`
# overrides of `voxel_rcnn_car_kitti`
# `centerpoint_tiny_smoke` narrowed to the multichip dry run's grid and two
# tasks (tests/test_torch_runtime.py's NUSC_SMALL_SETS)
NUSC_SMALL_SETS = [
    "pc_range=[-16.0, -16.0, -2.4, 16.0, 16.0, 2.4]",
    "voxel_size=[0.5, 0.5, 0.2]", "grid_size=[24, 64, 64]",
    "max_voxels=512", "stage_caps=[512, 256, 128, 64]", "tasks=[1, 2]",
    "max_objs=8", "nms_pre_max_size=32", "nms_post_max_size=4",
    "post_center_range=[-20.0, -20.0, -4.0, 20.0, 20.0, 4.0]"]
KITTI_SMALL_SETS = [
    "pc_range=[0.0, -16.0, -2.4, 32.0, 16.0, 2.4]",
    "voxel_size=[0.5, 0.5, 0.2]", "grid_size=[24, 64, 64]",
    "max_voxels=256", "stage_caps=[256, 192, 128, 96]",
    "train_pre_nms=64", "train_post_nms=16", "test_pre_nms=64",
    "test_post_nms=16", "rcnn.grid_size=3", "rcnn.max_local=32",
    "rcnn.roi_per_image=8"]


def tiny_kitti_samples(rng: np.random.RandomState, n: int,
                       n_points: int = 400, n_boxes: int = 3):
    """n (points (P, 4), car boxes (M, 7)) in KITTI's lidar frame: points
    ahead of the car and some behind it (outside the camera's view), cars
    within the small KITTI grid, in view."""
    out = []
    for _ in range(n):
        pts = np.concatenate([
            rng.uniform(-6.0, 30.0, (n_points, 1)),
            rng.uniform(-14.0, 14.0, (n_points, 1)),
            rng.uniform(-2.2, 1.0, (n_points, 1)),
            rng.rand(n_points, 1)], 1).astype(np.float32)
        boxes = np.concatenate([
            rng.uniform(8.0, 26.0, (n_boxes, 1)),
            rng.uniform(-5.0, 5.0, (n_boxes, 1)),
            rng.uniform(-1.2, -0.6, (n_boxes, 1)),
            rng.uniform(3.5, 4.5, (n_boxes, 1)),
            rng.uniform(1.5, 1.9, (n_boxes, 1)),
            rng.uniform(1.4, 1.7, (n_boxes, 1)),
            rng.uniform(-3.0, 3.0, (n_boxes, 1))], 1).astype(np.float32)
        out.append((pts, boxes))
    return out


def write_tiny_kitti(root, n: int = 4, seed: int = 0, images: bool = False,
                     split: str = "train"):
    """`tiny_kitti_samples` written as a KITTI dataset (`synth.
    write_kitti_dataset`; 375x1242 PNGs with `images`) -> the info pkl."""
    from df3d_torch.utils.synth import write_kitti_dataset

    rng = np.random.RandomState(seed)
    return write_kitti_dataset(root, tiny_kitti_samples(rng, n), split=split,
                               images=images, image_rng=rng)


def tiny_nusc_samples(rng: np.random.RandomState, n: int,
                      n_points: int = 600, n_boxes: int = 6):
    """n (frame (P, 5) with ten sweep lags, 9-dof boxes, class names) over
    the `centerpoint_tiny_smoke` range (+-25.6 m)."""
    from df3d_torch.data.nuscenes_eval import NUSC_CLASSES

    out = []
    for _ in range(n):
        frame = np.concatenate([
            rng.uniform(-25.0, 25.0, (n_points, 2)),
            rng.uniform(-1.8, 1.8, (n_points, 1)), rng.rand(n_points, 1),
            rng.randint(0, 10, (n_points, 1)) * np.float32(0.05)],
            1).astype(np.float32)
        boxes = np.concatenate([
            rng.uniform(-20.0, 20.0, (n_boxes, 2)),
            rng.uniform(-1.0, 0.0, (n_boxes, 1)),
            rng.uniform(1.0, 4.0, (n_boxes, 3)),
            rng.uniform(-3.0, 3.0, (n_boxes, 1)),
            rng.uniform(-1.0, 1.0, (n_boxes, 2))], 1).astype(np.float32)
        names = np.asarray(NUSC_CLASSES)[rng.randint(0, 10, n_boxes)]
        out.append((frame, boxes, names))
    return out


def write_tiny_nuscenes(root, n: int = 4, seed: int = 0, cams: int = 0,
                        image_hw=(45, 80), name: str = "train"):
    """`tiny_nusc_samples` written as a nuScenes dataset (`synth.
    write_nuscenes_dataset`); with `cams`, each sample also gets that many
    random PNG cameras of `image_hw` under `cams` in its info (the rig of
    `synth.camera_rig` as lidar2cam and camera_intrinsics). -> the info
    pkl."""
    import pickle

    from df3d_torch.utils.synth import write_nuscenes_dataset, write_png

    rng = np.random.RandomState(seed)
    path = write_nuscenes_dataset(root, tiny_nusc_samples(rng, n), name)
    if not cams:
        return path
    with open(path, "rb") as f:
        data = pickle.load(f)
    h, w = image_hw
    f_px = 0.8 * w
    intr = np.array([[f_px, 0, w / 2], [0, f_px, h / 2], [0, 0, 1]],
                    np.float32)
    (root / "cams").mkdir(exist_ok=True)
    for i, info in enumerate(data["infos"]):
        info["cams"] = {}
        for c in range(cams):
            yaw = 2 * np.pi * c / cams
            fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
            right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
            rot = np.stack([right, [0.0, 0.0, -1.0], fwd])
            l2c = np.eye(4, dtype=np.float32)
            l2c[:3, :3] = rot
            rel = f"cams/{i:04d}_CAM{c}.png"
            write_png(root / rel, rng.randint(0, 256, (h, w, 3), np.uint8))
            key = "lidar2cam" if c % 2 == 0 else "lidar2cam_matrix"
            info["cams"][f"CAM_{chr(ord('F') - c)}"] = {
                "data_path": rel, key: l2c, "camera_intrinsics": intr}
    with open(path, "wb") as f:
        pickle.dump(data["infos"], f)  # a list, as older infos are
    return path
