"""Single-frame inference demo (port of the JAX package's tools/demo.py,
the counterpart of VoxelRCNN's tools/demo.py).

    python -m df3d_torch.tools.demo --preset centerpoint_nusc \\
        --bin points.bin [--ckpt work_dirs/cp/ckpt] [--num-features 4]

Reads a float32 .bin point cloud (`--num-features` columns, padded with
zero columns up to the preset's point features), runs the preset's eval
step on it and prints the detections at or above `--score-thresh` in the
JAX demo's format. The presets are those the JAX demo serves, the
LiDAR-only CenterPoint family (`centerpoint_nusc`,
`centerpoint_tiny_smoke`); any other raises. The weights are the newest
checkpoint of the train CLI's `--ckpt` directory, or drawn from seed 0
when none is given. Runs on the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from df3d_torch import entry
from df3d_torch.config import get_preset
from df3d_torch.models.build import build_detector
from df3d_torch.models.detectors.centerpoint import CenterPointConfig
from df3d_torch.train.checkpoint import restore_latest
from df3d_torch.train.schedules import adam_onecycle
from df3d_torch.train.trainer import make_centerpoint_eval_step


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m df3d_torch.tools.demo")
    p.add_argument("--preset", required=True)
    p.add_argument("--bin", required=True)
    p.add_argument("--num-features", type=int, default=None)
    p.add_argument("--ckpt", default=None,
                   help="the train CLI's checkpoint directory")
    p.add_argument("--score-thresh", type=float, default=0.3)
    p.add_argument("--device", default=None,
                   help="torch device; default the card (raises without "
                        "one); 'cpu' runs the plain PyTorch path")
    return p.parse_args(argv)


def load_points(path, num_features: int, model_features: int) -> np.ndarray:
    """A float32 .bin of `num_features` columns -> (N, model_features),
    zero columns appended where the file has fewer."""
    pts = np.fromfile(path, dtype=np.float32).reshape(-1, num_features)
    if num_features < model_features:
        pts = np.concatenate(
            [pts, np.zeros((len(pts), model_features - num_features),
                           np.float32)], axis=1)
    return pts


def main(argv=None) -> dict:
    """Run the demo -> the eval step's detections of the frame on the CPU
    (boxes, scores, labels, valid: the frame's row of each)."""
    args = parse_args(argv)
    device = entry.resolve_device(args.device)
    preset = get_preset(args.preset)
    if not isinstance(preset, CenterPointConfig):
        raise ValueError(
            f"the demo serves the LiDAR-only CenterPoint presets "
            f"(centerpoint_nusc, centerpoint_tiny_smoke), not "
            f"{args.preset!r}")
    cfg = preset
    pts = load_points(args.bin, args.num_features or cfg.num_point_features,
                      cfg.num_point_features)
    print(f"loaded {len(pts)} points from {args.bin}")

    state = build_detector(cfg, adam_onecycle(1e-3, 1), device=device).state
    if args.ckpt:
        restored, step = restore_latest(args.ckpt, state)
        if restored is None:
            raise SystemExit(f"no checkpoint in {args.ckpt}")
        print(f"restored checkpoint step {step}")
    state.model.eval()
    batch = {"points": torch.from_numpy(pts[None]).to(device),
             "points_valid": torch.ones((1, len(pts)), dtype=torch.bool,
                                        device=device)}
    out = make_centerpoint_eval_step(state.model, cfg)(batch)
    det = {k: out[k][0].cpu().numpy()
           for k in ("boxes", "scores", "labels", "valid")}
    keep = det["valid"] & (det["scores"] >= args.score_thresh)
    print(f"{keep.sum()} detections (score >= {args.score_thresh}):")
    for b, s, l in zip(det["boxes"][keep], det["scores"][keep],
                       det["labels"][keep]):
        print(f"  cls={l} score={s:.3f} box={np.round(b, 2).tolist()}")
    return det


if __name__ == "__main__":
    main()
