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
def replayed_relus(jax_inputs, skip: torch.nn.Module | None = None):
    """Give the port's ReLUs (`torch.relu`, in call order) the decisions
    (x > 0) of the JAX package's ReLUs, whose inputs `recorded_jax_relus`
    gave (an NHWC map stands for the port's NCHW one, and the first of B
    equal rows for the port's one row): where the two
    disagree, the input takes JAX's sign at its own magnitude, and the
    gradient passes through unchanged. The ReLUs inside `skip` (a module
    whose JAX calls are not in `jax_inputs`) are left alone. Yields the
    replayed disagreements, (call, elements, largest |x|) per call that had
    any; raises if a call has no JAX counterpart of its shape."""
    relu, flips, paused = torch.relu, [], []
    calls = iter(enumerate(jax_inputs))
    hooks = [] if skip is None else [
        skip.register_forward_pre_hook(lambda *_: paused.append(True)),
        skip.register_forward_hook(lambda *_: paused.clear())]

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


def record_grads():
    """An optax transform that passes the gradients through and keeps them
    as its state (chain it ahead of the optimizer to read a step's raw
    gradients from `opt_state[0]`)."""
    import optax

    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(np.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def voxelrcnn_stop_gradient_step(model, head, cfg, fused: bool):
    """The JAX package's `make_voxelrcnn_train_step` (aux off) composed from
    its own functions with the proposals' gradient stopped, as pcdet's
    `torch.no_grad()` proposal and proposal-target layers stop it:
    `step(state, batch, rng) -> (state, logs, extra)`, extra holding the
    ReLU inputs of the training forward in call order (`relus`), the
    proposals (`proposals`: rois, scores, mask), the proposal target
    layer's output (`targets`) and its noise (`noise`)."""
    from df3d.models.detectors.voxel_rcnn import (
        assign_rpn_targets, build_anchors, proposal_layer,
        voxel_rcnn_train_losses,
    )
    from df3d.models.heads.voxelrcnn_head import sample_rois_for_training
    from df3d.ops.voxelize import voxelize_batch
    from df3d.train.trainer import _overflow_log

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
            logs["cap_overflow"] = _overflow_log(updates)
            noise = jax.vmap(lambda k: jax.random.uniform(
                k, roi_scores.shape[1:]) * 1e-3)(keys)
            return total, (logs, updates, r_updates,
                           dict(relus=relus, targets=targets, noise=noise,
                                proposals=(rois, roi_scores, roi_mask)))

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


def voxelrcnn_step_run(jmodel, jhead, jcfg, state, step, batch, variables,
                       lr: float, total_steps: int,
                       with_package_step: bool = True) -> dict:
    """One Voxel R-CNN training step both ways, from the same flax
    `variables` (already in the port's `state`) and numpy `batch`: the
    stop-gradient composition (`voxelrcnn_stop_gradient_step`) and, with
    `with_package_step`, the JAX package's own `make_voxelrcnn_train_step`,
    in one jitted program with `adam_onecycle(lr, total_steps)` behind a
    `record_grads` transform; then the port's `step` with JAX's noise
    draws, ReLU decisions and proposals, the port's own proposals and its
    proposal target layer's output recorded.

    The proposals carry no gradient, so the second stage reads them as an
    input, as it reads the noise: the port's second stage takes JAX's, and
    the port's own are held against them (`check_sampled`). The RoIs'
    coordinates reach 30 m, and the first stage's f32 rounding moves them
    by ~1e-5 m, which the RoI grid's offsets and their batch statistics
    turn into gradient gaps of up to 3x the tolerance (seen on the fused
    step).

    -> dict: model, state, logs, grads (by name), new / jlogs / targets /
    proposals (the composition's state, logs, sampled targets and
    proposals), sampled and own_proposals (the port's), flips (the
    replayed ReLUs), before (the state dict ahead of the step), pkg (the
    package step's (state, logs) or None)."""
    import jax.numpy as jnp
    import optax
    import pytest

    from df3d.train.schedules import adam_onecycle
    from df3d.train.trainer import TrainState, make_voxelrcnn_train_step
    from df3d_torch.train import trainer as ttrainer

    tx = optax.chain(record_grads(), adam_onecycle(lr, total_steps))
    jstate = TrainState.create(apply_fn=None, params=variables["params"],
                               tx=tx, batch_stats=variables["batch_stats"])
    fused = "images" in batch
    composed = voxelrcnn_stop_gradient_step(jmodel, jhead, jcfg, fused)
    package = make_voxelrcnn_train_step(jmodel, jhead, jcfg, fused=fused)

    @jax.jit
    def run(state, batch, rng):
        out = {"sg": composed(state, batch, rng)}
        if with_package_step:
            out["pkg"] = package(state, batch, rng)
        return out

    out = run(jstate, {k: jnp.asarray(v) for k, v in batch.items()},
              jax.random.PRNGKey(2))
    out = jax.tree_util.tree_map(np.array, out)
    new, jlogs, extra = out["sg"]

    model = state.model
    relus, skip = extra["relus"], None
    if fused:  # the frozen image branch's ReLUs are not replayed
        skip = model.rpn.image_branch
        relus = relus[_image_branch_relus(jmodel, variables, batch):]
    before = {k: v.clone() for k, v in model.state_dict().items()}
    sample, sampled = ttrainer.sample_rois_for_training, []
    propose, proposed = ttrainer.proposal_layer, []

    def recording(*args):
        sampled.append(sample(*args))
        return sampled[-1]

    def jax_proposals(*args, **kwargs):
        proposed.append(propose(*args, **kwargs))
        return tuple(torch.from_numpy(p) for p in extra["proposals"])

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ttrainer, "sample_rois_for_training", recording)
        mp.setattr(ttrainer, "proposal_layer", jax_proposals)
        with replayed_relus(relus, skip) as flips:
            logs, grads = step.grads(
                state, {k: torch.from_numpy(v) for k, v in batch.items()},
                noise=torch.from_numpy(extra["noise"]))
    grads = dict(zip(state.param_names, [g.clone() for g in grads]))
    state = step.apply(state, list(grads.values()))
    return dict(model=model, state=state, logs=logs, grads=grads, new=new,
                jlogs=jlogs, targets=extra["targets"], sampled=sampled[0],
                proposals=extra["proposals"], own_proposals=proposed[0],
                flips=flips, before=before, pkg=out.get("pkg"))


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
