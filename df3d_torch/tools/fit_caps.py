"""Fit the sparse backbone's per-stage caps to measured occupancy (port of
the JAX package's tools/fit_caps.py).

Strided sparse convs dilate the active set (spconv's SparseConv3d), and
the static stage caps drop what overflows them, so caps that are guesses
put accuracy at risk. This tool voxelizes frames at 1.5x the preset's
`max_voxels`, builds the three strided convs' plans over them
(`ops.sparse.build_conv_plan`, each stage's `true_occ`: its output sites
before any cap) and prints, per stage, the occupancy's maximum, mean and
percentile and the cap fitted to it (the percentile times `--headroom`,
rounded up to a multiple of 1024), as the JAX tool prints them.

    python -m df3d_torch.tools.fit_caps --preset centerpoint_nusc \\
        --data-root /data/nuscenes --info-path infos_train.pkl --frames 200
    python -m df3d_torch.tools.fit_caps --preset centerpoint_nusc \\
        --synthetic --frames 16

Frames come from a KITTI (a `*_kitti` preset) or nuScenes info pkl, or,
with `--synthetic`, from the ray-cast generator (`utils.synth.
make_raycast_frame`, frame i from RandomState(i)). The plans are built on
the card unless `--device cpu`.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from df3d_torch import entry
from df3d_torch.config import get_preset
from df3d_torch.ops.sparse import SparseTensor, build_conv_plan
from df3d_torch.ops.voxelize import voxelize_batch

# the strided convs' z padding (SpMiddleResNetFHD's down2, down3, down4)
KZ_PADS = (1, 1, (0, 1, 1))


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m df3d_torch.tools.fit_caps")
    p.add_argument("--preset", required=True)
    p.add_argument("--data-root", default=None)
    p.add_argument("--info-path", default=None)
    p.add_argument("--synthetic", action="store_true",
                   help="ray-cast frames (no dataset needed)")
    p.add_argument("--frames", type=int, default=100)
    p.add_argument("--pctl", type=float, default=99.0)
    p.add_argument("--headroom", type=float, default=1.05,
                   help="multiplier on the fitted percentile")
    p.add_argument("--max-points", type=int, default=260_000)
    p.add_argument("--device", default=None,
                   help="torch device; default the card (raises without "
                        "one); 'cpu' builds the plans on the CPU")
    return p.parse_args(argv)


def synthetic_frame(seed: int, n_points: int, extra_features: int):
    """Frame `seed` of `--synthetic`."""
    from df3d_torch.utils.synth import make_raycast_frame

    return make_raycast_frame(np.random.RandomState(seed), n_points,
                              extra_features=extra_features)


def stage_occupancy(cfg, points: np.ndarray, max_points: int,
                    device) -> np.ndarray:
    """One frame's (4,) int64 occupancy: the voxels at 1.5x `max_voxels`,
    then each strided conv's output sites before any cap, each stage
    planned over the previous one's sites."""
    probe_cap = cfg.max_voxels + cfg.max_voxels // 2
    pts = np.asarray(points, np.float32)[:max_points]
    buf = torch.zeros((1, max_points, pts.shape[1]), dtype=torch.float32)
    buf[0, :len(pts)] = torch.from_numpy(pts)
    valid = torch.zeros((1, max_points), dtype=torch.bool)
    valid[0, :len(pts)] = True
    res = voxelize_batch(buf.to(device), valid.to(device), cfg.voxel_size,
                         cfg.pc_range, cfg.grid_size, probe_cap,
                         cfg.max_points_per_voxel)
    rows = torch.zeros((1, probe_cap, 1), device=device)  # coords only
    st = SparseTensor(rows, res.coords, cfg.sparse_shape)
    occs = [st.valid.sum()]
    for pad in KZ_PADS:
        plan = build_conv_plan(st, 3, 2, pad, max_out=probe_cap)
        occs.append(plan.true_occ[0])
        st = SparseTensor(rows, plan.out_coords, plan.out_spatial_shape)
    return torch.stack(occs).cpu().numpy().astype(np.int64)


def fit(per_stage: np.ndarray, pctl: float, headroom: float) -> dict:
    """(frames, 4) occupancies -> the JSON the tool prints."""
    fitted = []
    for s in range(per_stage.shape[1]):
        v = per_stage[:, s]
        p = float(np.percentile(v, pctl))
        fitted.append({
            "stage": s + 1, "max": int(v.max()), "mean": float(v.mean()),
            f"p{pctl:g}": p,
            "fitted_cap": int(np.ceil(p * headroom / 1024) * 1024)})
    return {"frames": int(per_stage.shape[0]),
            "stage_caps": [f["fitted_cap"] for f in fitted],
            "detail": fitted}


def main(argv=None) -> dict:
    """Measure and fit as the flags say; prints the JSON -> it, with the
    per-frame occupancies under "per_frame" (not printed)."""
    args = parse_args(argv)
    device = entry.resolve_device(args.device)
    preset = get_preset(args.preset)
    cfg = preset["lidar"] if isinstance(preset, dict) else preset

    if args.synthetic:
        frames = (synthetic_frame(i, args.max_points,
                                  cfg.num_point_features - 3)
                  for i in range(args.frames))
    else:
        if args.preset.endswith("_kitti"):
            from df3d_torch.data.kitti import KittiDataset

            ds = KittiDataset(args.data_root, args.info_path)
        else:
            from df3d_torch.data.nuscenes import NuScenesDataset

            ds = NuScenesDataset(args.data_root, args.info_path)
        frames = (ds[i]["points"] for i in range(min(args.frames, len(ds))))

    with torch.no_grad():
        per_stage = np.stack([stage_occupancy(cfg, pts, args.max_points,
                                              device) for pts in frames])
    out = fit(per_stage, args.pctl, args.headroom)
    print(json.dumps(out, indent=2))
    return dict(out, per_frame=per_stage)


if __name__ == "__main__":
    main()
