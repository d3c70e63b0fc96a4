"""The evaluation CLI (port of the JAX package's tools/test.py): a
checkpoint of the train CLI on a dataset on disk.

  * centerpoint_* and transfusion_* presets -> nuScenes mAP and NDS;
  * voxel_rcnn_* presets -> KITTI 3D, BEV and 2D AP, AOS, and the recall
    of the proposals and of the final boxes at IoU 0.3, 0.5 and 0.7.

    python -m df3d_torch.tools.test --preset centerpoint_nusc \\
        --data-root /data/nuscenes --info-path infos_val.pkl \\
        --ckpt work_dirs/cp/ckpt [--watch] [--tta double_flip] \\
        [--serving-profile tpu_v5e]

The checkpoint is restored into the model `models.build.build_detector`
builds for training (the train CLI's template), which then serves in eval
mode in the named profile (`serving.apply_profile`). `--tta double_flip`
evaluates CenterPoint with det3d's double-flip TTA
(`train.trainer.make_centerpoint_eval_step`). The loop bodies are those of
`train.evaluate`. `--watch` polls the checkpoint directory as pcdet's
repeat_eval_ckpt does. Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import time

from df3d_torch import entry
from df3d_torch.config import apply_preset_overrides, get_preset
from df3d_torch.data.pipeline import PrefetchLoader
from df3d_torch.models.build import build_detector
from df3d_torch.serving import PROFILES, apply_profile
from df3d_torch.tools.train import make_collate, to_device
from df3d_torch.train.checkpoint import restore_checkpoint, restore_latest
from df3d_torch.train.evaluate import (
    kitti_metrics, kitti_records, nuscenes_metrics, nuscenes_records,
)
from df3d_torch.train.schedules import adam_onecycle
from df3d_torch.train.trainer import make_centerpoint_eval_step


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m df3d_torch.tools.test")
    p.add_argument("--preset", required=True)
    p.add_argument("--data-root", default=None)
    p.add_argument("--info-path", default=None)
    p.add_argument("--ckpt", required=True)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--max-points", type=int, default=260_000)
    p.add_argument("--image-shape", type=int, nargs=2, default=None)
    p.add_argument("--aux-loss", action="store_true",
                   help="the checkpoint was trained with --aux-loss (its "
                        "model carries the aux head)")
    p.add_argument("--out", default=None)
    p.add_argument("--tta", choices=["double_flip"], default=None,
                   help="test-time augmentation (det3d double flip)")
    p.add_argument("--set", nargs="*", default=[], dest="overrides")
    p.add_argument("--watch", action="store_true")
    p.add_argument("--max-waiting-mins", type=int, default=30)
    p.add_argument("--serving-profile", default="exact",
                   choices=tuple(PROFILES),
                   help="numerics profile (serving.py): 'exact' is f32 "
                        "throughout; 'tpu_v5e' runs the sparse-conv bodies "
                        "from 32 input channels in bf16")
    p.add_argument("--device", default=None,
                   help="torch device; default the card (raises without "
                        "one); 'cpu' runs the plain PyTorch path")
    return p.parse_args(argv)


def build_eval(args, preset, device=None):
    """-> (state, eval_step, lidar_cfg, family, fused_extra): the train
    CLI's model and optimizer state (to restore a checkpoint into) and
    `eval_step(batch) -> detections` on that model in eval mode, in
    `--serving-profile` (`--tta` is CenterPoint's, as in the JAX CLI)."""
    built = build_detector(preset, adam_onecycle(1e-3, 1),
                           image_shape=args.image_shape,
                           with_aux_seg=getattr(args, "aux_loss", False),
                           device=device)
    fused_extra = ((built.num_cams, built.image_shape) if built.fused
                   else None)
    state, cfg = built.state, built.lidar_cfg
    cams = ("images", "proj") if built.fused else ()

    if built.family == "centerpoint":
        step = make_centerpoint_eval_step(state.model, cfg, tta=args.tta,
                                          fused=built.fused)
    elif built.family == "transfusion":
        infer = (entry.infer_transfusion_fused if built.fused
                 else entry.infer_transfusion)

        def step(batch):
            return infer(state.model, cfg, batch["points"],
                         batch["points_valid"], *(batch[k] for k in cams))[0]
    else:
        def step(batch):
            return entry.infer_voxelrcnn(
                state.model.rpn, state.model.rcnn, cfg, batch["points"],
                batch["points_valid"], *(batch[k] for k in cams))[0]

    state.model.eval()
    apply_profile(state.model, getattr(args, "serving_profile", "exact"))
    return state, step, cfg, built.family, fused_extra


def build_dataset(args, fused_extra):
    """-> (dataset, is_kitti) of the eval split (no training FOV crop)."""
    if args.preset.endswith("_kitti"):
        from df3d_torch.data.kitti import KittiDataset

        return KittiDataset(
            args.data_root, args.info_path, training=False,
            load_images=bool(fused_extra),
            image_shape=fused_extra[1] if fused_extra else (384, 1280),
        ), True
    from df3d_torch.data.nuscenes import NuScenesDataset

    return NuScenesDataset(
        args.data_root, args.info_path, load_images=bool(fused_extra),
        image_shape=fused_extra[1] if fused_extra else (448, 800)), False


def evaluate_once(args, preset, state_dir, ckpt_path=None):
    """Evaluate the newest checkpoint of `state_dir` (or `ckpt_path`):
    prints the scalar metrics as one JSON line, writes every metric to
    `--out` when given -> the checkpoint's step. Raises SystemExit when
    there is no checkpoint."""
    device = entry.resolve_device(getattr(args, "device", None))
    state, eval_step, cfg, family, fused_extra = build_eval(args, preset,
                                                            device)
    if ckpt_path is not None:
        restored, step_no = restore_checkpoint(ckpt_path, state)
    else:
        restored, step_no = restore_latest(state_dir, state)
    if restored is None:
        raise SystemExit(f"no checkpoint in {state_dir}")

    dataset, is_kitti = build_dataset(args, fused_extra)
    collate = make_collate(fused_extra, args.max_points, 500,
                           cfg.num_point_features, with_samples=True)

    def squeezed(item):
        batch, samples = item
        if fused_extra and fused_extra[0] == 1:  # one camera: (B, H, W, 3)
            batch = dict(batch, images=batch["images"][:, 0],
                         proj=batch["proj"][:, 0])
        return batch, samples

    loader = PrefetchLoader(dataset, args.batch_size, shuffle=False,
                            drop_last=False,
                            collate=lambda s: squeezed(collate(s)))
    if is_kitti:
        metrics = _eval_kitti_loop(eval_step, loader, dataset, device)
    else:
        metrics = _eval_nusc_loop(eval_step, loader, device)
    metrics["step"] = step_no
    print(json.dumps(
        {k: v for k, v in metrics.items()
         if isinstance(v, (int, float, str))} | {"preset": args.preset},
        default=float), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(metrics, f, indent=2, default=float)
    return step_no


def _eval_nusc_loop(eval_step, loader, device) -> dict:
    gt_frames, det_frames = [], []
    for batch, _ in loader:
        out = eval_step(to_device(batch, device))
        gts, dets = nuscenes_records(out, batch)
        gt_frames += gts
        det_frames += dets
    return nuscenes_metrics(gt_frames, det_frames)


def _eval_kitti_loop(eval_step, loader, dataset, device) -> dict:
    class_names = tuple(dataset.class_names)
    gt_annos, det_annos, recall = [], [], {}
    for batch, samples in loader:
        out = eval_step(to_device(batch, device))
        gts, dets = kitti_records(out, samples, class_names, recall)
        gt_annos += gts
        det_annos += dets
    return kitti_metrics(gt_annos, det_annos, recall, class_names)


def main(argv=None):
    args = parse_args(argv)
    entry.resolve_device(args.device)
    preset = get_preset(args.preset)
    if args.overrides:
        preset = apply_preset_overrides(preset, args.overrides)
    ckpt_dir = pathlib.Path(args.ckpt)
    last_step = -1
    waited = 0
    while True:
        try:
            step = evaluate_once(args, preset, ckpt_dir)
            if step == last_step and not args.watch:
                break
            last_step = step
        except SystemExit:
            if not args.watch:
                raise
        if not args.watch:
            break
        time.sleep(60)
        waited += 1
        if waited > args.max_waiting_mins:
            break
    return last_step


if __name__ == "__main__":
    main()
