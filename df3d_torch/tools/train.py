"""The training CLI (port of the JAX package's tools/train.py): any preset
of the registry, LiDAR-only or fused, from a dataset on disk or from
random data.

    python -m df3d_torch.tools.train --preset centerpoint_nusc \\
        --data-root /data/nuscenes --info-path infos_train.pkl \\
        --work-dir work_dirs/cp --epochs 20
    python -m df3d_torch.tools.train --preset centerpoint_tiny_smoke \\
        --synthetic --device cpu --epochs 1 --steps-per-epoch 2

The model is built by `models.build.build_detector` (the test CLI builds
its checkpoints' template the same way), the batches by
`data.pipeline.PrefetchLoader` and `make_batch`, and the `train.loop.
Runner` takes the steps, logs, checkpoints each epoch under
`work_dir/ckpt` and resumes from the newest checkpoint there. No
augmentation is applied, as the JAX CLI applies none. Training runs on
the card unless `--device cpu` (with no card, the default raises).
Voxel R-CNN's step draws its RoI sampler noise on the CPU from a
generator seeded with the step count, so a resumed run, and a run on
another device, draws what an unbroken run draws.

Data parallel, as the JAX CLI shards each global batch over every local
device: one rank per visible card by default, `--nprocs N` ranks
otherwise (`parallel.launch`: N cards over NCCL, or ranks sharing the
cards over gloo; gloo CPU processes with `--device cpu`), each taking
`train.trainer.DataParallelTrainStep` on its shard. `--batch-size` stays
the global batch: rank r loads with `shard_id=r, num_shards=N` and batch
B / N, so the ranks' samples at step k are the one-process batch k, and
takes rows r, r + N, ... of the global batch's RoI noise. Every rank
resumes from the newest checkpoint; rank 0 alone writes checkpoints,
logs and events, and runs `--eval-after`.

    python -m df3d_torch.tools.train --preset centerpoint_nusc \
        --data-root /data/nuscenes --info-path infos_train.pkl --nprocs 2
"""

from __future__ import annotations

import argparse
import itertools
import json
import pathlib
import sys

import numpy as np
import torch

from df3d_torch import entry
from df3d_torch.config import apply_preset_overrides, get_preset
from df3d_torch.data.images import finalize_camera_sample
from df3d_torch.data.pipeline import PrefetchLoader, make_batch
from df3d_torch.models.build import build_detector
from df3d_torch.parallel import ddp, launch
from df3d_torch.train.loop import Runner
from df3d_torch.train.schedules import adam_onecycle
from df3d_torch.train.trainer import DataParallelTrainStep

# the RoI sampler's noise of step s is drawn from a generator seeded with
# (7 << 32) + s, the counterpart of the JAX CLI's fold_in(PRNGKey(7), step)
ROI_NOISE_KEY = 7


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m df3d_torch.tools.train")
    p.add_argument("--preset", required=True)
    p.add_argument("--data-root", default=None)
    p.add_argument("--info-path", default=None)
    p.add_argument("--work-dir", default="work_dirs/default")
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--max-points", type=int, default=260_000)
    p.add_argument("--max-gt", type=int, default=500)
    p.add_argument("--synthetic", action="store_true",
                   help="train on random data (smoke runs without datasets)")
    p.add_argument("--synthetic-points", type=int, default=20_000)
    p.add_argument("--image-shape", type=int, nargs=2, default=None,
                   help="fused presets: camera image (H, W)")
    p.add_argument("--steps-per-epoch", type=int, default=100,
                   help="the schedule's steps per epoch, and --synthetic's")
    p.add_argument("--set", nargs="*", default=[], dest="overrides")
    p.add_argument("--cbgs", action="store_true",
                   help="class-balanced resampling (mmdet3d CBGSDataset); "
                        "the duplicate set is redrawn every epoch")
    p.add_argument("--aux-loss", action="store_true",
                   help="fused presets: add the aux image-FG segmentation "
                        "and voxel/camera consistency losses")
    p.add_argument("--eval-after", type=int, default=0,
                   help="after training, evaluate the last N checkpoints "
                        "with the test CLI")
    p.add_argument("--val-info-path", default=None,
                   help="info pkl of the post-train eval (default: "
                        "--info-path)")
    p.add_argument("--log-interval", type=int, default=50,
                   help="log every N steps (the Runner's default)")
    p.add_argument("--device", default=None,
                   help="torch device; default the card (raises without "
                        "one); 'cpu' runs the plain PyTorch path")
    p.add_argument("--nprocs", type=int, default=None,
                   help="data-parallel ranks (default: one per visible "
                        "card; one with --device cpu)")
    return p.parse_args(argv)


def make_synthetic_dataset(num_features, n=64, num_classes=10,
                           num_points=20_000, num_cams=0, image_shape=None):
    """Random samples, sample i drawn from RandomState(i) as the JAX CLI
    draws them."""

    class Synth:
        class_names = tuple(str(i) for i in range(num_classes))

        def __len__(self):
            return n

        def __getitem__(self, i):
            rng = np.random.RandomState(i)
            pts = np.concatenate(
                [rng.uniform(-50, 50, (num_points, 2)),
                 rng.uniform(-4, 2, (num_points, 1)),
                 rng.uniform(0, 1, (num_points, num_features - 3))], axis=-1,
            ).astype(np.float32)
            m = rng.randint(1, 20)
            boxes = np.concatenate(
                [rng.uniform(-50, 50, (m, 2)), rng.uniform(-2, 0, (m, 1)),
                 rng.uniform(1, 5, (m, 3)), rng.uniform(-3, 3, (m, 1)),
                 rng.uniform(-2, 2, (m, 2))], axis=-1,
            ).astype(np.float32)
            out = {"points": pts, "gt_boxes": boxes,
                   "gt_classes": rng.randint(0, num_classes, m).astype(
                       np.int32)}
            if num_cams:
                h, w = image_shape
                out["images"] = rng.rand(num_cams, h, w, 3).astype(np.float32)
                out["proj"] = np.tile(
                    np.array([[w, -w, 0, w * 2.0], [0, -h / 3, -w, h * 2.0],
                              [1, 0, 0, 0]], np.float32),
                    (num_cams, 1, 1))
            return out

    return Synth()


def roi_noise(step: int, batch: int, rois: int) -> torch.Tensor:
    """The RoI sampler's tie-breaking noise of training step `step`, (batch,
    rois) uniform in [0, 1e-3), drawn on the CPU so that every device and
    a resumed run draw the same."""
    g = torch.Generator().manual_seed((ROI_NOISE_KEY << 32) + step)
    return torch.rand((batch, rois), generator=g) * 1e-3


def build_model_and_step(args, preset, device=None, rank: int = 0,
                         world: int = 1):
    """-> (state, train_step, lidar_cfg, fused_extra): the preset's model
    from `build_detector` (seed 0) with AdamW and OneCycle over the run's
    epochs x steps per epoch, and `train_step(state, batch) -> (state,
    logs)`; fused_extra (cameras, image shape) or None. With `world` > 1
    the step is `DataParallelTrainStep` over the default process group,
    `batch` rank `rank`'s shard."""
    total_steps = max(args.epochs * args.steps_per_epoch, 1)
    aux = getattr(args, "aux_loss", False)
    built = build_detector(preset, adam_onecycle(args.lr, total_steps),
                           image_shape=args.image_shape,
                           with_aux_seg=aux,
                           device=device)
    base = built.step
    if aux and built.fused:
        base.set_aux(True, built.image_shape, base.aux_seg_weight,
                     base.aux_consistency_weight)
    extra = (built.num_cams, built.image_shape) if built.fused else None
    grads = base.grads if world == 1 else DataParallelTrainStep(base).grads
    if built.family != "voxelrcnn":
        if world == 1:
            return built.state, base, built.lidar_cfg, extra

        def step(state, batch):
            logs, g = grads(state, batch)
            return base.apply(state, g), logs

        return built.state, step, built.lidar_cfg, extra

    squeeze = built.fused and built.num_cams == 1
    rois = built.lidar_cfg.train_post_nms

    def step(state, batch):
        if squeeze and batch["images"].dim() == 5:
            batch = dict(batch, images=batch["images"][:, 0],
                         proj=batch["proj"][:, 0])
        points = batch["points"]
        # the global batch's noise; this rank holds rows rank, rank + world..
        noise = roi_noise(state.step, points.shape[0] * world,
                          rois)[rank::world].to(points.device)
        logs, g = grads(state, batch, noise=noise)
        return base.apply(state, g), logs

    return built.state, step, built.lidar_cfg, extra


def build_dataset(args, fused_extra, lidar_cfg):
    """-> (dataset, max_points) of the run: random samples, a KITTI or a
    nuScenes info pkl (with --cbgs, class-balanced)."""
    if args.synthetic:
        return make_synthetic_dataset(
            lidar_cfg.num_point_features,
            n=args.steps_per_epoch * args.batch_size,
            num_points=args.synthetic_points,
            num_cams=fused_extra[0] if fused_extra else 0,
            image_shape=fused_extra[1] if fused_extra else None,
        ), args.synthetic_points
    if args.preset.endswith("_kitti"):
        from df3d_torch.data.kitti import KittiDataset

        return KittiDataset(
            args.data_root, args.info_path, load_images=bool(fused_extra),
            image_shape=fused_extra[1] if fused_extra else (384, 1280),
        ), args.max_points
    from df3d_torch.data.nuscenes import CBGSWrapper, NuScenesDataset

    dataset = NuScenesDataset(
        args.data_root, args.info_path, load_images=bool(fused_extra),
        image_shape=fused_extra[1] if fused_extra else (448, 800))
    if args.cbgs:
        dataset = CBGSWrapper(dataset)
    return dataset, args.max_points


def make_collate(fused_extra, max_points: int, max_gt: int,
                 num_features: int, with_samples: bool = False):
    """samples -> a padded numpy batch (`make_batch`), with the fused
    presets' images (B, n_cam, H, W, 3) and proj (B, n_cam, 3, 4); a KITTI
    sample's raw image is resized and normalized here, after any
    augmentation. `with_samples`: -> (batch, samples)."""

    def collate(samples):
        if fused_extra:
            samples = [finalize_camera_sample(s, fused_extra[1])
                       if "image" in s and "images" not in s else s
                       for s in samples]
        batch = make_batch(samples, max_points, max_gt, num_features)
        if fused_extra:
            batch["images"] = np.stack([s["images"] for s in samples])
            batch["proj"] = np.stack([s["proj"] for s in samples])
        return (batch, samples) if with_samples else batch

    return collate


def to_device(batch: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def main(argv=None, hooks=()):
    """Train as the flags say -> the `Runner` after its run (`hooks`:
    `train.loop.Hook`s to register), or None when ranks ran in processes
    of their own (`--nprocs` > 1; `hooks` then go to every rank, so they
    must pickle)."""
    argv = sys.argv[1:] if argv is None else list(argv)
    args = parse_args(argv)
    device = entry.resolve_device(args.device)
    world = args.nprocs or (torch.cuda.device_count()
                            if device.type == "cuda" else 1)
    if world > 1:
        if args.batch_size % world:
            raise ValueError(f"--batch-size {args.batch_size} does not "
                             f"divide over {world} ranks")
        launch.spawn(_rank_main, world, argv, tuple(hooks))
        return None
    return _train(args, device, hooks)


def _rank_main(rank, world, init_method, argv, hooks):
    """One rank of a data-parallel run of the CLI."""
    args = parse_args(argv)
    devices, backend = launch.rank_devices(world, args.device)
    if devices[rank] == "cpu":
        torch.set_num_threads(1)
    device = ddp.init_data_parallel(rank, world, backend=backend,
                                    init_method=init_method,
                                    device=devices[rank])
    try:
        _train(args, device, hooks, rank, world)
    finally:
        torch.distributed.destroy_process_group()


def _train(args, device, hooks=(), rank: int = 0, world: int = 1):
    preset = get_preset(args.preset)
    if args.overrides:
        preset = apply_preset_overrides(preset, args.overrides)
    state, train_step, lidar_cfg, fused_extra = build_model_and_step(
        args, preset, device, rank, world)
    if world > 1:
        ddp.broadcast_state(state)
    dataset, max_points = build_dataset(args, fused_extra, lidar_cfg)
    # gt padding must not exceed the model's target-assignment capacity
    max_gt = min(args.max_gt, getattr(lidar_cfg, "max_objs", args.max_gt))
    loader = PrefetchLoader(
        dataset, args.batch_size // world, shard_id=rank, num_shards=world,
        collate=make_collate(fused_extra, max_points, max_gt,
                             lidar_cfg.num_point_features))
    # every rank takes the one-process run's number of steps an epoch
    steps = len(dataset) // args.batch_size

    runner = Runner(train_step, state, args.work_dir, args.epochs,
                    log_interval=args.log_interval, main_process=rank == 0)
    for hook in hooks:
        runner.register_hook(hook)

    def batches():
        loader.epoch = runner.epoch  # a resumed run goes on in order
        for batch in itertools.islice(loader, steps):
            yield to_device(batch, device)

    runner.run(batches)
    if rank == 0 and args.eval_after > 0 and not args.synthetic:
        evaluate_last_checkpoints(args, preset)
    return runner


def evaluate_last_checkpoints(args, preset) -> list[pathlib.Path]:
    """The newest `--eval-after` checkpoints through the test CLI's
    `evaluate_once` (pcdet's post-train repeat_eval_ckpt): one
    work_dir/eval/step_N.json each."""
    from df3d_torch.tools import test as test_cli
    from df3d_torch.train.checkpoint import list_checkpoints

    ckpt_dir = pathlib.Path(args.work_dir) / "ckpt"
    eval_dir = pathlib.Path(args.work_dir) / "eval"
    eval_dir.mkdir(parents=True, exist_ok=True)
    ckpts = list_checkpoints(ckpt_dir)[-args.eval_after:]
    if not ckpts:
        print("eval-after: no checkpoints found", flush=True)
        return []
    outs = []
    for step, path in ckpts:
        out = eval_dir / f"step_{step}.json"
        eval_args = argparse.Namespace(
            preset=args.preset, data_root=args.data_root,
            info_path=args.val_info_path or args.info_path,
            ckpt=str(ckpt_dir), batch_size=1, max_points=args.max_points,
            image_shape=args.image_shape, out=str(out), tta=None,
            overrides=args.overrides, watch=False, max_waiting_mins=0,
            aux_loss=getattr(args, "aux_loss", False),
            serving_profile="exact", device=args.device)
        test_cli.evaluate_once(eval_args, preset, ckpt_dir, ckpt_path=path)
        print(f"eval-after step {step}: "
              + json.dumps(json.loads(out.read_text()))[:400], flush=True)
        outs.append(out)
    return outs


if __name__ == "__main__":
    main()
