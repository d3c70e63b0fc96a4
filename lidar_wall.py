#!/usr/bin/env python3
"""Wall time of the port's LiDAR serving path alone, in one checkout.

    python3 lidar_wall.py [TREE]

TREE is the root of a checkout of the repo (default: the one holding this
script); its `df3d_torch` is imported and its kernels are built into its
build/. Run on a machine with a CUDA card (an H100) and the CUDA toolkit.
It builds the configuration of chip_smoke.py's main path (nuScenes,
0.075 m voxels, stage caps 102400/73728/27648/10240, seeded random
weights, three 260k-point ray-cast frames), runs one warm-up pass over the
frames, then REPS repetitions of FRAMES frames of `infer`, each timed on
the host clock around work that ends in torch.cuda.synchronize(), and
prints each repetition's mean, median, min and per-frame times. Nothing
else runs in the process, so two trees timed in turns in one call compare
the path alone. Exits non-zero without a CUDA device.
"""

import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

STAGE_CAPS = (102_400, 73_728, 27_648, 10_240)
NUM_POINTS = 260_000
REPS = 3
FRAMES = 10


def main():
    if not torch.cuda.is_available():
        print("lidar_wall: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    tree = Path(sys.argv[1] if len(sys.argv) > 1 else
                Path(__file__).resolve().parent).resolve()
    sys.path.insert(0, str(tree))
    os.chdir(tree)
    from df3d_torch.entry import build_centerpoint, infer
    from df3d_torch.models.detectors.centerpoint import CenterPointConfig
    from df3d_torch.ops import build
    from df3d_torch.utils.synth import make_raycast_frame

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    build.build_all()
    cfg = CenterPointConfig(max_voxels=STAGE_CAPS[0], stage_caps=STAGE_CAPS)
    model = build_centerpoint(cfg, "cuda", seed=0)
    inputs = []
    for i in range(3):
        frame = make_raycast_frame(np.random.RandomState(100 + i), NUM_POINTS)
        pts = torch.from_numpy(frame[None]).cuda()
        inputs.append((pts, torch.ones(pts.shape[:2], dtype=torch.bool,
                                       device="cuda")))
    for args in inputs:
        infer(model, cfg, *args)
    torch.cuda.synchronize()
    for rep in range(REPS):
        ms = []
        for i in range(FRAMES):
            t0 = time.perf_counter()
            infer(model, cfg, *inputs[i % len(inputs)])
            torch.cuda.synchronize()
            ms.append(1e3 * (time.perf_counter() - t0))
        print(f"{tree.name} rep {rep}: ms/frame mean {np.mean(ms):.3f} median "
              f"{np.median(ms):.3f} min {np.min(ms):.3f}; per frame "
              f"{[round(x, 3) for x in ms]}", flush=True)
    print(f"card: {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
