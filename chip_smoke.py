#!/usr/bin/env python3
"""Drive the PyTorch port's CenterPoint serving path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (an H100;
the kernels are built for sm_90a) and the CUDA toolkit. Phases, in order;
any failure raises and the process exits non-zero:

1. card: the card's name and power limit (nvidia-smi).
2. build: every CUDA source under df3d_torch/csrc/, one nvcc each, all
   started together, into build/df3d_torch/.
3. small input: the port's full path on the card (kernels) against the same
   path on the CPU (plain PyTorch versions), same weights and points, on a
   small config: heatmaps to atol = rtol = 1e-3, same kept boxes.
4. kernels: one full-width nuScenes frame (260k ray-cast points, 0.075 m
   voxels, stage caps 102400/73728/27648/10240); the inputs of every K1
   launch of one forward are captured and each kernel output is held
   against the plain version: max|kernel - plain| <= 1e-4 * max|plain| +
   1e-5 (f32, other summation order). Per launch: kernel and plain times
   (CUDA events), the bound, the non-miss (tap, row) pairs.
5. main path: `infer` on full-width frames, warm-up then timed frames, with
   every kernel's launch count set to 0 just before and read just after;
   K1 must launch 16 times per frame. Prints ms/frame, a per-stage split,
   cap overflows, kept boxes and peak memory.

TF32 is off for matmuls and cuDNN convs: the port serves in f32 (the JAX
package's "exact" profile) and the comparisons need full f32. cuDNN picks
its conv algorithms by timing them (cudnn.benchmark).

The last two lines of stdout are one JSON object on the kernels (times from
this run, bound from this run's inputs) and the result line
{"ok": true, "device": {...}}. With no CUDA device, or outside a checkout,
the script exits non-zero without them.
"""

import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

REALISTIC_STAGE_CAPS = (102_400, 73_728, 27_648, 10_240)
NUM_POINTS = 260_000
TIMED_FRAMES = 10
K1_PER_FRAME = 16


def log(*args):
    print(*args, flush=True)


def check(ok, message):
    """Raise when a result is wrong; unlike `assert`, runs under -O too."""
    if not ok:
        raise RuntimeError(message)


def cuda_ms(fn, reps):
    """Mean device time of fn() over `reps` back-to-back calls, after one
    warm-up call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def card_line():
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.strip()


def phase_small_input(dev):
    """Kernels on the card vs plain versions on the CPU, whole path."""
    from df3d_torch.entry import build_centerpoint, infer, random_points, small_cfg
    from df3d_torch.ops.voxelize import voxelize_batch

    cfg = small_cfg()
    pts = torch.from_numpy(random_points(np.random.RandomState(0), 1, 2000))
    valid = torch.ones(pts.shape[:2], dtype=torch.bool)
    cpu = build_centerpoint(cfg, "cpu", seed=0)
    gpu = build_centerpoint(cfg, dev, seed=0)
    out = {}
    for name, model, d in (("cpu", cpu, "cpu"), ("gpu", gpu, dev)):
        p, v = pts.to(d), valid.to(d)
        with torch.no_grad():
            res = voxelize_batch(p, v, cfg.voxel_size, cfg.pc_range,
                                 cfg.grid_size, cfg.max_voxels,
                                 cfg.max_points_per_voxel)
            preds, _, _ = model(res.features, res.coords)
            det, _ = infer(model, cfg, p, v)
        out[name] = (res.coords.cpu(), [{k: t.cpu() for k, t in pr.items()}
                                        for pr in preds],
                     {k: t.cpu() for k, t in det.items()})
    (c_coords, c_preds, c_det), (g_coords, g_preds, g_det) = \
        out["cpu"], out["gpu"]
    check(torch.equal(c_coords, g_coords), "voxel coords differ")
    worst = 0.0
    for cp, gp in zip(c_preds, g_preds):
        for k in cp:
            check(torch.isfinite(gp[k]).all(), f"non-finite {k}")
            torch.testing.assert_close(gp[k], cp[k], atol=1e-3, rtol=1e-3)
            worst = max(worst, (gp[k] - cp[k]).abs().max().item())
    check(torch.equal(c_det["valid"], g_det["valid"]), "kept sets differ")
    m = c_det["valid"]
    check(torch.equal(c_det["labels"][m], g_det["labels"][m]),
          "kept labels differ")
    torch.testing.assert_close(g_det["boxes"][m], c_det["boxes"][m],
                               atol=1e-3, rtol=1e-3)
    log(f"small input: card vs CPU plain path agree: max head-map diff "
        f"{worst:.3g}, {int(m.sum())} kept boxes equal")


def full_width_frames(n):
    from df3d_torch.utils.synth import make_raycast_frame

    return [make_raycast_frame(np.random.RandomState(100 + i), NUM_POINTS)
            for i in range(n)]


def phase_k1(model, cfg, frame, dev):
    """Capture every K1 launch of one forward; hold each against the plain
    version and time both."""
    from df3d_torch.entry import infer
    from df3d_torch.ops import sparse_conv_kernel as K

    captured = []
    launch = K.sparse_conv_cuda

    def recording(features, gather_idx, weights):
        captured.append((features.clone(), gather_idx.clone(),
                         weights.clone()))
        return launch(features, gather_idx, weights)

    pts = torch.from_numpy(frame[None]).to(dev)
    valid = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    K.sparse_conv_cuda = recording
    try:
        infer(model, cfg, pts, valid)
    finally:
        K.sparse_conv_cuda = launch
    torch.cuda.synchronize()
    check(len(captured) == K1_PER_FRAME,
          f"expected {K1_PER_FRAME} K1 launches per frame, saw {len(captured)}")

    rows, max_err = [], 0.0
    log("K1 per launch (tolerance: max|kernel - plain| <= 1e-4*max|plain| "
        "+ 1e-5):")
    log("  #  N_in    N_out  K  Cin Cout  pairs(non-miss)  kernel_ms  "
        "plain_ms  bound_ms  bound_by  ceiling_GFLOP  max_abs_err")
    for i, (f, idx, w) in enumerate(captured):
        b, n_in, cin = f.shape
        k, _, cout = w.shape
        n_out = idx.shape[1] // k
        out = launch(f, idx, w)
        ref = K.sparse_conv_plain(f, idx, w)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item() + 1e-5
        check(torch.isfinite(out).all(), f"launch {i}: non-finite output")
        check(err <= tol, f"launch {i}: max abs err {err} > {tol}")
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: launch(f, idx, w), 20)
        plain_ms = cuda_ms(lambda: K.sparse_conv_plain(f, idx, w), 5)
        pairs = int(((idx >= 0) & (idx < n_in)).sum().item())
        flops = 2.0 * pairs * cin * cout
        nbytes = 4.0 * (idx.numel() + f.numel() + w.numel() + b * n_out * cout)
        t_ops, t_bytes = flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        bound_ms = 1e3 * max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        ceiling = 2.0 * k * b * n_out * cin * cout / 1e9
        rows.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         t_ops=t_ops, t_bytes=t_bytes, flops=flops,
                         ceiling=ceiling))
        log(f"  {i:<2d} {n_in:<7d} {n_out:<6d} {k:<2d} {cin:<4d} {cout:<4d} "
            f"{pairs:<16d} {ms:<10.4f} {plain_ms:<9.4f} {bound_ms:<9.5f} "
            f"{bound_by:<9} {ceiling:<14.3f} {err:.3g}")
    total = {key: sum(r[key] for r in rows) for key in rows[0]}
    log(f"K1 per frame: {len(rows)} launches, kernel {total['ms']:.4f} ms, "
        f"plain {total['plain_ms']:.4f} ms, bound {total['bound_ms']:.5f} ms "
        f"({total['flops'] / 1e9:.3f} GFLOP of non-miss pairs; ceiling over "
        f"every capped row {total['ceiling']:.3f} GFLOP)")
    return dict(
        name="sparse_conv_gather_gemm", route="cuda",
        source="df3d_torch/csrc/sparse_conv.cu",
        replaces="df3d/ops/pallas/sparse_conv_kernel.py:42",
        max_abs_err=max_err, ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"],
        bound_by=("operations" if total["t_ops"] >= total["t_bytes"]
                  else "bytes"),
        library_ms=None)


def stage_split(model, cfg, pts, valid):
    """Host-clock split of one frame by stage, synchronising between."""
    from df3d_torch.models.detectors.centerpoint import centerpoint_predict
    from df3d_torch.ops.sparse import SparseTensor
    from df3d_torch.ops.voxelize import voxelize_batch

    times, t = {}, time.perf_counter()

    def mark(name):
        nonlocal t
        torch.cuda.synchronize()
        now = time.perf_counter()
        times[name] = 1e3 * (now - t)
        t = now

    with torch.no_grad():
        res = voxelize_batch(pts, valid, cfg.voxel_size, cfg.pc_range,
                             cfg.grid_size, cfg.max_voxels,
                             cfg.max_points_per_voxel)
        mark("voxelize")
        st = SparseTensor(res.features, res.coords, cfg.sparse_shape)
        caps = tuple(min(c, cfg.max_voxels) for c in cfg.stage_caps)
        bev, _, _ = model.backbone(st, caps)
        mark("backbone_3d")
        x = model.neck(bev)
        mark("neck")
        preds = model.head(x)
        mark("head")
        centerpoint_predict(cfg, preds)
        mark("decode_nms")
    return times


def profile_frame(model, cfg, pts, valid):
    """One frame under torch.profiler: device-busy share of the wall time
    and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    from df3d_torch.entry import infer

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        infer(model, cfg, pts, valid)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages()
               if str(e.device_type).endswith("CUDA")]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    log(f"profile (one frame): wall {wall_ms:.3f} ms, device kernels "
        f"{busy_ms:.3f} ms, device idle share "
        f"{max(0.0, 1 - busy_ms / wall_ms):.3f}")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:15]:
        log(f"  {e.self_device_time_total / 1e3:9.3f} ms  x{e.count:<5d} "
            f"{e.key[:100]}")


def phase_main_path(model, cfg, frames, dev):
    from df3d_torch.entry import infer
    from df3d_torch.ops import sparse_conv_kernel as K

    inputs = [(torch.from_numpy(f[None]).to(dev),
               torch.ones(1, len(f), dtype=torch.bool, device=dev))
              for f in frames]
    for pts, valid in inputs:  # warm-up
        infer(model, cfg, pts, valid)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    K.launches = 0
    per_frame, dets = [], []
    for i in range(TIMED_FRAMES):
        pts, valid = inputs[i % len(inputs)]
        t0 = time.perf_counter()
        det, overflow = infer(model, cfg, pts, valid)
        torch.cuda.synchronize()
        per_frame.append(1e3 * (time.perf_counter() - t0))
        dets.append((det, overflow))
    launches = K.launches
    peak = torch.cuda.max_memory_allocated()

    check(launches == K1_PER_FRAME * TIMED_FRAMES,
          f"K1 launched {launches} times in {TIMED_FRAMES} frames")
    for det, overflow in dets:
        for key, t in det.items():
            if t.is_floating_point():
                check(torch.isfinite(t).all(), f"non-finite {key}")
        shape = (1, len(cfg.tasks) * cfg.nms_post_max_size, 9)
        check(tuple(det["boxes"].shape) == shape,
              f"boxes {tuple(det['boxes'].shape)}, expected {shape}")
    log(f"main path: {TIMED_FRAMES} frames, ms/frame mean "
        f"{np.mean(per_frame):.3f} median {np.median(per_frame):.3f} "
        f"min {np.min(per_frame):.3f}; per frame "
        f"{[round(x, 3) for x in per_frame]}")
    log(f"main path: K1 launches {launches} ({launches // TIMED_FRAMES} per "
        f"frame); peak memory {peak / 2**30:.3f} GiB")
    for i, (det, overflow) in enumerate(dets[:len(inputs)]):
        log(f"frame {i}: kept boxes {int(det['valid'].sum())}; cap overflow "
            + ", ".join(f"{k}={int(v.sum())}" for k, v in overflow.items()))
    split = stage_split(model, cfg, *inputs[0])
    log("stage split (ms, host clock, synchronised): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    profile_frame(model, cfg, *inputs[0])
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from df3d_torch.models.detectors.centerpoint import CenterPointConfig
    from df3d_torch.entry import build_centerpoint
    from df3d_torch.ops import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the frame shapes are static, so cuDNN can time its f32 algorithms once
    # in the warm-up; its default pick for the 180x180 BEV convs is an FFT
    # algorithm that spends ~90 ms a frame in tens of thousands of gemv calls
    torch.backends.cudnn.benchmark = True
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; TF32 off (matmul and cuDNN), "
        f"cudnn.benchmark on")

    t0 = time.perf_counter()
    libs = build.build_all()
    log(f"build: {', '.join(libs)} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc: " + ", ".join(f"{k} {v:.2f} s" for k, v in
                               build.build_seconds.items()) + ")")
    for name, text in build.build_log.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    phase_small_input(dev)

    cfg = CenterPointConfig(max_voxels=REALISTIC_STAGE_CAPS[0],
                            stage_caps=REALISTIC_STAGE_CAPS)
    model = build_centerpoint(cfg, dev, seed=0)
    frames = full_width_frames(3)
    k1 = phase_k1(model, cfg, frames[0], dev)
    k1["launches"] = phase_main_path(model, cfg, frames, dev)

    log(f"card: {card}")
    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
