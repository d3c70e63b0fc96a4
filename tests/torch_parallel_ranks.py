"""Rank workers of the data-parallel tests (tests/test_torch_parallel*.py)
and the six training steps at tiny configs they run.

The tests spawn their ranks with `torch.multiprocessing.spawn` (gloo, CPU,
one thread each, a FileStore under the test's tmp_path); a spawned process
imports this module, so it imports torch and the port only. Each rank
saves what it computed with `torch.save` for the test to compare.

The global batches hold two samples that differ in valid points (so in
valid voxel rows at every stage), in valid gt boxes and so in positives:
a per-rank statistic or normalizer then differs from the global one, and
only global ones give the one-process step on the global batch.

The ranks' statistics sum in another order than the one process's, so
their forwards differ in the last bits, and a ReLU input that close to 0
passes the gradient in one and not in the other, moving every leaf
upstream by a few percent. So the one-process step records its ReLU
decisions and the data-parallel ranks replay them on their rows where
their own differ (`relu_decisions`), counted and bounded by the tests, as
tests/test_torch_fused_train_step.py replays JAX's. For the same reason
the Voxel R-CNN ranks' second stages read the one-process step's
proposals (`proposal_decisions`), after their own are held against them:
the RoIs carry the first stage's rounding, which the RoI grid turns into
gradient gaps of the RCNN head.
"""

from __future__ import annotations

import contextlib
import copy
import os

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from df3d_torch import entry
from df3d_torch.models.detectors.fused import FusedConfig
from df3d_torch.models.detectors.transfusion import TransFusionConfig
from df3d_torch.models.detectors.voxel_rcnn import (
    VoxelRCNNConfig, proposal_layer,
)
from df3d_torch.models.fusion.actr import ACTRConfig
from df3d_torch.models.fusion.msda_module import MSDeformAttnModule
from df3d_torch.models.heads.transfusion_head import TransFusionHeadCfg
from df3d_torch.models.heads.voxelrcnn_head import (
    RoIPoolScaleCfg, VoxelRCNNHeadCfg,
)
from df3d_torch.models.layers import (
    FlaxBatchNorm, FlaxBatchNorm2d, MaskedBatchNorm,
)
from df3d_torch.parallel import ddp
from df3d_torch.train.trainer import DataParallelTrainStep
from df3d_torch.utils.synth import camera_rig, kitti_camera

STEPS = ("centerpoint", "centerpoint_3ddf", "transfusion_l",
         "transfusion_3ddf", "voxel_rcnn", "voxel_rcnn_3ddf")
WORLD = 2
NOISE_SEED = 5


def spawn(fn, tmp_path, *args):
    """Run fn(rank, WORLD, init_method, *args) in `WORLD` new processes,
    which meet through a file under `tmp_path`."""
    mp.spawn(fn, nprocs=WORLD,
             args=(WORLD, f"file://{tmp_path}/store", *args))


@contextlib.contextmanager
def one_thread():
    """torch's intra-op threads at one within the block. The tests run
    beside other test workers on every core, where ops spread over
    threads wait for threads the scheduler has parked (minutes for what
    takes seconds alone); the ranks run on one thread throughout."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _join(rank, world, init_method):
    torch.set_num_threads(1)
    ddp.init_data_parallel(rank, world, init_method=init_method,
                           device="cpu")


@contextlib.contextmanager
def relu_decisions(masks: list, rows: tuple | None = None):
    """Record each `torch.relu` call's decisions (x > 0) in `masks`, in
    call order; or, with `rows` = (rank, world), give each call this
    rank's rows of the recorded decisions (all of them for a call whose
    input is not batched, as the positional embedding's) where its own
    differ: the input
    takes the recorded sign at its own magnitude and the gradient passes
    through unchanged. Yields the replays, (elements, largest |x|) per
    call that had any."""
    relu, flips, recorded = torch.relu, [], iter(masks)

    def patched(x):
        z = x.detach()
        if rows is None:
            masks.append(z > 0)
            return relu(x)
        want = next(recorded)
        if want.shape != z.shape:  # a batched call: this rank's rows
            n = want.shape[0] // rows[1]
            want = want[rows[0] * n:(rows[0] + 1) * n]
        assert want.shape == z.shape, (want.shape, z.shape)
        flip = (z > 0) != want
        if not flip.any():
            return relu(x)
        flips.append((int(flip.sum()), float(z[flip].abs().max())))
        signed = torch.where(want, z.abs(), -z.abs())
        return relu(torch.where(flip, x - z + signed, x))

    torch.relu = patched
    try:
        yield flips
    finally:
        torch.relu = relu


@contextlib.contextmanager
def proposal_decisions(store: list, rows: tuple | None = None):
    """Record each training step's proposals (rois, scores, mask) in
    `store`; or, with `rows` = (rank, world), check this rank's own against
    its rows of the recorded ones (mask equal, rois and scores within
    1e-4 * max + 1e-5) and return the recorded rows."""
    from df3d_torch.train import trainer

    propose, recorded = trainer.proposal_layer, iter(store)

    def patched(*args, **kwargs):
        got = propose(*args, **kwargs)
        if rows is None:
            store.append(got)
            return got
        want = next(recorded)
        n = want[0].shape[0] // rows[1]
        want = tuple(w[rows[0] * n:(rows[0] + 1) * n] for w in want)
        assert torch.equal(got[2], want[2]), "proposal masks differ"
        for g, w in zip(got[:2], want[:2]):
            tol = 1e-4 * w.abs().max().item() + 1e-5
            assert (g - w).abs().max().item() <= tol, "proposals differ"
        return want

    trainer.proposal_layer = patched
    try:
        yield
    finally:
        trainer.proposal_layer = propose


# ---------------------------------------------------------------- configs


def _fused_centerpoint_config():
    """tests/test_torch_fused_slice.py's fused config (two 32x48 cameras,
    one-block DeepLabV3 taps, a tiny ACTRv2)."""
    return FusedConfig(
        image_shape=(32, 48), image_branch="deeplabv3",
        image_layers=(1, 1, 1, 1), n_levels=2, num_cams=2,
        actr=ACTRConfig(d_model=16, n_heads=2, n_points=2, n_levels=2,
                        num_layers=1, dim_feedforward=32, lt_npoint=8,
                        lt_nsample=4, model_name="ACTRv2", q_method="gating",
                        attn_layer="BiGateSum1D_2"),
        use_ifat=True, fusion_downsample=8)


def _transfusion_configs():
    """tests/test_torch_transfusion_slice.py's configs."""
    head = TransFusionHeadCfg(
        num_classes=3, num_proposals=16, hidden_channel=32, num_heads=4,
        ffn_channel=64, small_classes=(2,), bev_size=(8, 8),
        out_size_factor=8, voxel_size=(0.5, 0.5), pc_range=(-16.0, -16.0))
    cfg = TransFusionConfig(
        pc_range=(-16.0, -16.0, -2.4, 16.0, 16.0, 2.4),
        voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64), max_voxels=512,
        num_point_features=4, stage_caps=(1024, 512, 256, 128), head=head)
    actr = ACTRConfig(d_model=16, n_heads=2, n_points=2, n_levels=1,
                      num_layers=2, dim_feedforward=32, lt_npoint=8,
                      lt_nsample=4, model_name="ACTRv2", q_method="sum",
                      attn_layer="BiGateSum1D_2", hybrid=True)
    return cfg, FusedConfig(
        image_shape=(64, 112), image_branch="resnet_fpn",
        image_layers=(1, 1, 1, 1), n_levels=1, num_cams=2, actr=actr,
        use_ifat=True, fusion_downsample=8)


def _kitti_configs():
    """tests/test_torch_voxelrcnn_train_step.py's and
    tests/test_torch_voxelrcnn_fused_train_step.py's configs, the fused
    one's image branch on one-block stages."""
    geom = dict(pc_range=(0.0, -16.0, -2.4, 32.0, 16.0, 2.4),
                voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64),
                max_voxels=256, num_point_features=4,
                stage_caps=(256, 192, 128, 96), train_pre_nms=64,
                train_post_nms=16)
    lidar = VoxelRCNNConfig(**geom, rcnn=VoxelRCNNHeadCfg(
        grid_size=3, scales=(RoIPoolScaleCfg("conv3", 4, 1.6, nsample=4),),
        max_local=32, roi_per_image=8))
    fused = VoxelRCNNConfig(**geom, rcnn=VoxelRCNNHeadCfg(
        grid_size=2, scales=(RoIPoolScaleCfg("conv2", 2, 0.8, nsample=4),),
        max_local=16, roi_per_image=8))
    fcfg = FusedConfig(image_shape=(64, 96), n_levels=2,
                       image_layers=(1, 1, 1, 1), actr=ACTRConfig(
                           d_model=16, n_heads=2, n_points=2, n_levels=2,
                           num_layers=1, dim_feedforward=32, lt_npoint=8,
                           lt_nsample=4))
    return lidar, fused, fcfg


# ---------------------------------------------------------------- batches


def _points(rng, n, f, valid, x=(-15.0, 15.0)):
    """Two samples of n points over the grid; sample i keeps valid[i]."""
    pts = np.concatenate([rng.uniform(*x, (2, n, 1)),
                          rng.uniform(-15, 15, (2, n, 1)),
                          rng.uniform(-1.8, 1.8, (2, n, 1)),
                          rng.uniform(0, 1, (2, n, f - 3))], -1)
    ok = np.arange(n)[None] < np.asarray(valid)[:, None]
    return pts.astype(np.float32), ok


# four boxes (gravity centre, 9-dof) of classes 0, 1, 2, 0; the first sample
# holds all four, the second the first two, moved
BOXES = np.array([[1.0, 2.0, 0.0, 4.0, 2.0, 1.5, 0.3, 0.0, 0.0],
                  [-6.0, -8.0, 0.2, 2.0, 1.0, 1.2, 1.0, 0.5, 0.0],
                  [8.0, 5.0, -0.3, 1.0, 1.0, 1.8, -0.5, 0.0, 0.3],
                  [3.0, -10.0, 0.0, 4.5, 2.0, 1.6, 2.0, 0.0, 0.0]],
                 np.float32)


def _nusc_batch(f, cams=None):
    rng = np.random.RandomState(0)
    points, ok = _points(rng, 2048, f, (2048, 1300))
    boxes = np.stack([BOXES, BOXES + np.float32([1.5, -0.5] + [0] * 7)])
    batch = {"points": points, "points_valid": ok, "gt_boxes": boxes,
             "gt_classes": np.tile(np.int64([0, 1, 2, 0]), (2, 1)),
             "gt_valid": np.array([[1, 1, 1, 1], [1, 1, 0, 0]], bool)}
    if cams is not None:
        nc, hw = cams.num_cams, cams.image_shape
        batch["images"] = rng.randn(2, nc, *hw, 3).astype(np.float32)
        batch["proj"] = np.broadcast_to(camera_rig(nc, hw),
                                        (2, nc, 3, 4)).copy()
    return batch


def _kitti_batch(state, step, fcfg=None):
    """300 points a sample (the second keeps 200), a 64x96 image and
    KITTI's camera scaled to it when fused; gt cars near the first stage's
    proposals 0, 5 and 10 (the second sample's first two), moved and
    turned, the second of them by pi more, so that RoIs reach the
    regression threshold."""
    rng = np.random.RandomState(0)
    points, ok = _points(rng, 300, 4, (300, 200), x=(0.0, 31.0))
    batch = {"points": points, "points_valid": ok}
    if fcfg is not None:
        batch["images"] = rng.randn(2, *fcfg.image_shape, 3).astype(
            np.float32)
        batch["proj"] = np.broadcast_to(kitti_camera(
            fcfg.image_shape[1] / 1280), (2, 3, 4)).copy()
    probe = copy.deepcopy(state.model).train()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        res = step.voxelize(tb)
        preds, _ = probe.rpn(res.features, res.coords,
                             *step.model_inputs(tb))
        rois = proposal_layer(step.cfg, preds, probe.anchors, train=True)[0]
    gts = rois[:, [0, 5, 10]].numpy() + np.float32(
        [0.2, -0.1, 0.05, 0.0, 0.0, 0.0, 0.1])
    gts[:, 1, 6] += np.pi
    batch["gt_boxes"] = np.concatenate(
        [gts, np.zeros((2, 1, 7), np.float32)], 1)
    batch["gt_classes"] = np.zeros((2, 4), np.int64)
    batch["gt_valid"] = np.array([[1, 1, 1, 0], [1, 1, 0, 0]], bool)
    return batch


def build(name: str):
    """(state, step, global numpy batch) of one of `STEPS` on the CPU, from
    seed 0."""
    if name in ("centerpoint", "centerpoint_3ddf"):
        cfg = entry.mesh_cfg()
        if name == "centerpoint":
            state, step = entry.build_centerpoint_trainer(cfg, "cpu")
            return state, step, _nusc_batch(5)
        fcfg = _fused_centerpoint_config()
        state, step = entry.build_centerpoint3ddf_trainer(cfg, fcfg, "cpu")
        return state, step, _nusc_batch(5, fcfg)
    if name.startswith("transfusion"):
        cfg, fcfg = _transfusion_configs()
        if name == "transfusion_l":
            state, step = entry.build_transfusion_trainer(cfg, "cpu")
            return state, step, _nusc_batch(4)
        state, step = entry.build_transfusion3ddf_trainer(cfg, fcfg, "cpu")
        return state, step, _nusc_batch(4, fcfg)
    lidar, fused, fcfg = _kitti_configs()
    if name == "voxel_rcnn":
        state, step = entry.build_voxelrcnn_trainer(lidar, "cpu")
        return state, step, _kitti_batch(state, step)
    state, step = entry.build_voxelrcnn3ddf_trainer(fused, fcfg, "cpu")
    with torch.no_grad():  # flax's initial zeros (see the module docstring)
        for m in state.model.modules():
            if isinstance(m, MSDeformAttnModule):
                m.sampling_offsets.weight.zero_()
                m.attention_weights.weight.zero_()
    return state, step, _kitti_batch(state, step, fcfg)


def step_args(step) -> tuple:
    """A Voxel R-CNN step's generator for the RoI sampler's noise."""
    if isinstance(step, entry.VoxelRCNNTrainStep):
        return (torch.Generator().manual_seed(NOISE_SEED),)
    return ()


def tensors(batch: dict) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in batch.items()}


def record(state, logs, grads) -> dict:
    """What the tests compare: logs, gradients and parameters by name,
    batch statistics, the optimizer's moments."""
    sd = state.model.state_dict()
    return {
        "logs": {k: v.clone() for k, v in logs.items()},
        "grads": {n: g.clone() for n, g in zip(state.param_names, grads)},
        "params": {n: p.detach().clone()
                   for n, p in zip(state.param_names, state.params)},
        "stats": {k: v.clone() for k, v in sd.items()
                  if k.endswith(("running_mean", "running_var"))},
        "mu": {n: m.clone() for n, m in zip(state.param_names,
                                            state.opt_state.mu)},
        "nu": {n: m.clone() for n, m in zip(state.param_names,
                                            state.opt_state.nu)},
        "lr0": float(state.tx.lr(0)), "b1": float(state.tx.b1(0)),
    }


def state_fingerprint(rec: dict) -> torch.Tensor:
    """`ddp._fingerprint` of a record's parameters, batch statistics and
    moments: equal on two ranks exactly when their bits are."""
    return ddp._fingerprint([t for part in ("params", "stats", "mu", "nu")
                             for t in rec[part].values()])


def one_process(state, step, batch: dict, masks: dict) -> dict:
    """The port's one-process step on the global batch of two (`state`
    changes in place); its ReLU decisions and proposals go to `masks`
    ("relu", "proposals")."""
    with relu_decisions(masks["relu"]), \
            proposal_decisions(masks["proposals"]):
        logs, grads = step.grads(state, tensors(batch), *step_args(step))
    step.apply(state, grads)
    return dict(record(state, logs, grads),
                valid_points=torch.from_numpy(batch["points_valid"].sum(1)),
                valid_gts=torch.from_numpy(batch["gt_valid"].sum(1)))


def plain_ddp_grads(step, state, batch, args, world):
    """A plain DDP step's rank: the rank's own statistics and normalizers,
    its gradients and logs averaged over the ranks. Voxel R-CNN's noise is
    the global draw's rows, as the data-parallel step's."""
    kwargs = {}
    if args:
        rank, b = dist.get_rank(), batch["points"].shape[0]
        noise = torch.rand((b * world, step.cfg.train_post_nms),
                           generator=args[0]) * 1e-3
        kwargs["noise"] = noise[rank * b:(rank + 1) * b]
    logs, grads = step.grads(state, batch, **kwargs)
    grads = [g / world for g in ddp.sum_over_ranks(grads)]
    logs = {k: v / world if v.is_floating_point() else v
            for k, v in ddp.sum_over_ranks(logs).items()}
    return logs, grads


def steps_rank(rank, world, init_method, out_dir, names):
    """Rank r first takes the one-process steps of names[r::world] (one
    thread, as the ranks; `{name}_ref.pt`: the record and its decisions).
    Then each named step over the ranks, data parallel (replaying the
    one-process step's ReLU decisions and proposals on its rows) and as
    plain DDP, each from the state broadcast from rank 0. Rank 0 saves
    `{name}_dp0.pt` and `{name}_ddp0.pt` (records, the data-parallel one
    with its replays); rank 1 saves `{name}_dp1.pt`: its replays and
    `state_fingerprint` of its record."""
    _join(rank, world, init_method)
    try:
        built = {}
        for name in names[rank::world]:
            state, step, batch = build(name)
            built[name] = (copy.deepcopy(state), step, batch)
            masks = {"relu": [], "proposals": []}
            ref = one_process(state, step, batch, masks)
            torch.save({"ref": ref, "masks": masks},
                       os.path.join(out_dir, f"{name}_ref.pt"))
        dist.barrier()
        for name in names:
            masks = torch.load(os.path.join(out_dir, f"{name}_ref.pt"))[
                "masks"]
            state, step, batch = built.pop(name, None) or build(name)
            ddp.broadcast_state(state)
            fresh = copy.deepcopy(state)
            mine = tensors(ddp.shard_batch(batch, rank, world))
            for kind in ("dp", "ddp"):
                if kind == "ddp":
                    state = fresh
                flips = []
                if kind == "dp":
                    with relu_decisions(masks["relu"], (rank, world)) as \
                            flips, proposal_decisions(masks["proposals"],
                                                      (rank, world)):
                        logs, grads = DataParallelTrainStep(step).grads(
                            state, mine, *step_args(step))
                else:
                    logs, grads = plain_ddp_grads(step, state, mine,
                                                  step_args(step), world)
                step.apply(state, grads)
                out = dict(record(state, logs, grads), flips=flips)
                if rank:
                    if kind == "ddp":
                        continue
                    out = {"flips": flips,
                           "fingerprint": state_fingerprint(out)}
                torch.save(out,
                           os.path.join(out_dir, f"{name}_{kind}{rank}.pt"))
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------- norms, global sum


def norm_inputs():
    """Inputs of the unit tests, two samples: (x (2, 40, 6), mask (2, 40)
    with 31 and 9 valid rows, bev (2, 5, 4, 3) NCHW, seq (2, 7, 5)) and
    the upstream gradients of each norm's output."""
    rng = np.random.RandomState(3)

    def t(*shape, scale=1.0, shift=0.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale + shift).astype(np.float32))

    mask = torch.from_numpy(np.arange(40)[None] < np.array([[31], [9]]))
    return {"x": t(2, 40, 6, scale=2.0, shift=1.5), "mask": mask,
            "bev": t(2, 5, 4, 3, shift=-0.7), "seq": t(2, 7, 5, scale=0.5),
            "dx": t(2, 40, 6), "dbev": t(2, 5, 4, 3), "dseq": t(2, 7, 5)}


def norms_forward_backward(inp: dict, rows: slice) -> dict:
    """The three training norms on `rows` of `norm_inputs()` (seeded
    affine parameters), each output against its upstream gradient:
    outputs, input and parameter gradients, running statistics. Under
    `ddp.data_parallel` the statistics are global."""
    torch.manual_seed(0)
    mods = {"masked": MaskedBatchNorm(6), "flax": FlaxBatchNorm(5, 1e-3),
            "flax2d": FlaxBatchNorm2d(5, 1e-5)}
    out = {}
    for key, m in mods.items():
        with torch.no_grad():
            m.weight.uniform_(0.5, 1.5)
            m.bias.uniform_(-0.5, 0.5)
        m.train()
        if key == "masked":
            x = inp["x"][rows].clone().requires_grad_(True)
            y = m(x, inp["mask"][rows])
            dy = inp["dx"][rows]
        elif key == "flax":
            x = inp["seq"][rows].clone().requires_grad_(True)
            y, dy = m(x), inp["dseq"][rows]
        else:
            x = inp["bev"][rows].clone().requires_grad_(True)
            y, dy = m(x), inp["dbev"][rows]
        # a loss that also reads the output's global mean, so the backward
        # crosses ranks through a normalizer as well as the statistics
        loss = ((y * dy).sum()
                + ddp.global_sum(y.sum()) ** 2 / (1e3 * ddp.world_size()))
        gx, gw, gb = torch.autograd.grad(loss, (x, m.weight, m.bias))
        out[key] = {"y": y.detach(), "dx": gx, "dweight": gw, "dbias": gb,
                    "running_mean": m.running_mean.clone(),
                    "running_var": m.running_var.clone()}
    return out


def global_sum_case(x_rows: torch.Tensor, detach: bool = False):
    """(value, gradient) of this rank's share of f(x) = sum(x * s) + s^2,
    s = the sum of x^3 over the global batch: sum(x_r * s) + s^2 / world.
    `ddp.global_sum` carries every rank's share back to x_r; with
    `detach`, a plain all-reduce gives s's value and only the local
    term's gradient."""
    x = x_rows.clone().requires_grad_(True)
    part = x.pow(3).sum()
    if detach:
        total = part.detach().clone()
        dist.all_reduce(total)
        s = part + (total - part.detach())
    else:
        s = ddp.global_sum(part)
    f = (x * s).sum() + s ** 2 / ddp.world_size()
    (g,) = torch.autograd.grad(f, x)
    return f.detach(), g


def units_rank(rank, world, init_method, out_dir):
    """The unit cases on this rank's rows, under `ddp.data_parallel`, and
    `broadcast_state` of a state drawn from seed `rank`."""
    _join(rank, world, init_method)
    try:
        inp, rows = norm_inputs(), slice(rank, rank + 1)
        with ddp.data_parallel():
            norms = norms_forward_backward(inp, rows)
            x = torch.from_numpy(np.random.RandomState(4).randn(
                2, 3).astype(np.float32))[rows]
            value, grad = global_sum_case(x)
            _, plain_grad = global_sum_case(x, detach=True)
        state, _ = entry.build_centerpoint_trainer(entry.mesh_cfg(), "cpu",
                                                   seed=rank)
        ddp.broadcast_state(state)
        torch.save({"norms": norms, "value": value, "grad": grad,
                    "plain_grad": plain_grad,
                    "state": record(state, {}, state.params)},
                   os.path.join(out_dir, f"units{rank}.pt"))
    finally:
        dist.destroy_process_group()


def flax_state_rank(rank, world, init_method, out_dir, cfg_kwargs,
                    variables, batch, lr_max, total_steps):
    """A CenterPoint step over the ranks from flax variables
    (`weights.train_state_from_flax`) on a global numpy batch, replaying
    the ReLU decisions `relus.pt` on its rows; saves rank 0's logs,
    gradients by name, state dict and both ranks' replays as
    `flax_state.pt`."""
    from df3d_torch.models.detectors.centerpoint import (
        CenterPoint, CenterPointConfig,
    )
    from df3d_torch.train.trainer import make_centerpoint_train_step
    from df3d_torch.weights import train_state_from_flax

    _join(rank, world, init_method)
    try:
        cfg = CenterPointConfig(**cfg_kwargs)
        state = train_state_from_flax(
            CenterPoint(cfg), variables["params"], variables["batch_stats"],
            entry.adam_onecycle(lr_max, total_steps))
        step = DataParallelTrainStep(make_centerpoint_train_step(cfg))
        masks = torch.load(os.path.join(out_dir, "relus.pt"))
        with relu_decisions(masks, (rank, world)) as flips:
            logs, grads = step.grads(
                state, tensors(ddp.shard_batch(batch, rank, world)))
        step.step.apply(state, grads)
        all_flips = [None] * world
        dist.all_gather_object(all_flips, flips)
        if rank == 0:
            names = [n for n, _ in state.model.named_parameters()]
            torch.save({"logs": logs, "grads": dict(zip(names, grads)),
                        "state_dict": state.model.state_dict(),
                        "flips": all_flips},
                       os.path.join(out_dir, "flax_state.pt"))
    finally:
        dist.destroy_process_group()
