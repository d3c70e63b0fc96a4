#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths on one CUDA card: CenterPoint
(LiDAR only) and CenterPoint + 3D-DF (six cameras + LiDAR).

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (an H100;
the kernels are built for sm_90a) and the CUDA toolkit. Phases, in order;
any failure raises and the process exits non-zero:

1. card: the card's name and power limit (nvidia-smi).
2. build: every CUDA source under df3d_torch/csrc/, one nvcc each, all
   started together, into build/df3d_torch/.
3. small input: the port's full path on the card (kernels) against the same
   path on the CPU (plain PyTorch versions), same weights and points, on a
   small config: heatmaps to atol = rtol = 1e-3, same kept boxes, voxel
   coords and cap overflows.
4. kernels: one full-width nuScenes frame (260k ray-cast points, 0.075 m
   voxels, stage caps 102400/73728/27648/10240); the inputs of every K1
   launch of one forward are captured and each kernel output is held
   against the plain version: max|kernel - plain| <= 1e-4 * max|plain| +
   1e-5 (f32, other summation order), and a repeat launch against the
   first, bit for bit; so are small inputs at K1's edge cases. Per launch:
   the hit (tap, row) pairs, the (64-row tile, tap) pairs with a hit and
   the rows the product runs on under v1's rule and v2's compaction; the
   stream time of back-to-back wrapper calls (CUDA events, as for K2) and,
   beside it, the kernel's device time (events, calls queued while the
   card spins); the plain version's time; the tensor-core bound (3 x FLOP
   as TF32, which K1 runs on) and the f32 CUDA-core bound.
5. main path: `infer` on full-width frames, warm-up then timed frames, with
   every kernel's launch count set to 0 just before and read just after;
   K1 must launch 16 times per frame and K2 not at all. Prints ms/frame, a
   per-stage split, cap overflows, kept boxes and peak memory.
6. small fused input: the camera+LiDAR path (`infer_fused`) on the card
   against the same path on the CPU, same weights, points, images and
   camera rig, on a small config: head maps to atol = rtol = 1e-3, same
   kept boxes, same voxel coords and cap overflows.
7. K2: one full-width fused frame (the `centerpoint_3ddf_nusc` preset: six
   448x800 cameras, DeepLabV3 ResNet-50 taps, ACTRv2 at d_model 128, the
   stage caps above); the inputs of every K2 launch are captured and each
   output is held against the plain version with the tolerance of phase
   4, as are small inputs at K2's edge cases; kernel and plain times (CUDA
   events) and the bound. The frame must launch K2 once and K1 16 times.
8. fused main path: `infer_fused` on full-width frames (260k ray-cast
   points, six random normalized images, the nuScenes-like rig of
   `utils.synth.camera_rig`), warm-up then timed frames, launch counts set
   to 0 around the loop. Prints ms/frame, peak memory, the share of the
   stage-4 voxels each camera sees, a host-clock stage split and a
   one-frame profile.

TF32 is off for matmuls and cuDNN convs: the port serves in f32 (the JAX
package's "exact" profile) and the comparisons need full f32. cuDNN picks
its conv algorithms by timing them (cudnn.benchmark).

Each timed path prints a host-clock stage split (`df3d_torch.utils.stages`)
and a one-frame profile. The last two lines of stdout are one JSON object
on the kernels (times from this run, bounds from this run's inputs,
launches from the timed runs of both paths, also given by path; K1 also
gives its device time and its f32 CUDA-core bound) and the result line
{"ok": true, "device": {...}}. With no CUDA device, or outside a checkout,
the script exits non-zero without them.
"""

import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12

REALISTIC_STAGE_CAPS = (102_400, 73_728, 27_648, 10_240)
NUM_POINTS = 260_000
TIMED_FRAMES = 10
FUSED_TIMED_FRAMES = 5
K1_PER_FRAME = 16
K1_TILE_ROWS = 64
K2_PER_FUSED_FRAME = 1
# a K2 output element costs ~14 FLOP of corner arithmetic per sample and
# head (shared by its D channels) plus a multiply-add per in-bounds corner
K2_FLOP_PER_SAMPLE = 14


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


def device_ms(fn, reps):
    """Mean device time of fn() over `reps` back-to-back calls, after one
    warm-up call: the card first spins ~10 ms (torch.cuda._sleep) while the
    host queues the calls, so the events time the card alone, whatever the
    host takes per call."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
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


def card_vs_cpu(label, build, cfg, inputs, infer_fn, dev):
    """The path with its kernels on the card against the same path with the
    plain versions on the CPU: same weights (`build(device)`) and inputs
    (CPU tensors: points, valid, then the fused path's images and proj).
    Voxel coords, cap overflows and kept boxes equal; head maps to atol =
    rtol = 1e-3."""
    from df3d_torch.ops.voxelize import voxelize_batch

    out = []
    for d in ("cpu", dev):
        model = build(d)
        args = [t.to(d) for t in inputs]
        with torch.no_grad():
            res = voxelize_batch(args[0], args[1], cfg.voxel_size,
                                 cfg.pc_range, cfg.grid_size, cfg.max_voxels,
                                 cfg.max_points_per_voxel)
            preds, _, _ = model(res.features, res.coords, *args[2:])
            det, overflow = infer_fn(model, cfg, *args)
        out.append((res.coords.cpu(),
                    [{k: t.cpu() for k, t in p.items()} for p in preds],
                    {k: t.cpu() for k, t in det.items()},
                    {k: t.cpu() for k, t in overflow.items()}))
    (c_coords, c_preds, c_det, c_ov), (g_coords, g_preds, g_det, g_ov) = out
    check(torch.equal(c_coords, g_coords), f"{label}: voxel coords differ")
    for k in c_ov:
        check(torch.equal(c_ov[k], g_ov[k]), f"{label}: {k} differs")
    worst = 0.0
    for cp, gp in zip(c_preds, g_preds):
        for k in cp:
            check(torch.isfinite(gp[k]).all(), f"{label}: non-finite {k}")
            torch.testing.assert_close(gp[k], cp[k], atol=1e-3, rtol=1e-3)
            worst = max(worst, (gp[k] - cp[k]).abs().max().item())
    check(torch.equal(c_det["valid"], g_det["valid"]),
          f"{label}: kept sets differ")
    m = c_det["valid"]
    check(torch.equal(c_det["labels"][m], g_det["labels"][m]),
          f"{label}: kept labels differ")
    torch.testing.assert_close(g_det["boxes"][m], c_det["boxes"][m],
                               atol=1e-3, rtol=1e-3)
    log(f"{label}: card vs CPU plain path agree: max head-map diff "
        f"{worst:.3g}, {int(m.sum())} kept boxes equal, cap overflow "
        + ", ".join(f"{k}={int(v.sum())}" for k, v in c_ov.items()))


def phase_small_input(dev):
    from df3d_torch.entry import (
        build_centerpoint, infer, random_points, small_cfg,
    )

    cfg = small_cfg()
    pts = torch.from_numpy(random_points(np.random.RandomState(0), 1, 2000))
    valid = torch.ones(pts.shape[:2], dtype=torch.bool)
    card_vs_cpu("small input", lambda d: build_centerpoint(cfg, d, seed=0),
                cfg, [pts, valid], infer, dev)


def full_width_frames(n):
    from df3d_torch.utils.synth import make_raycast_frame

    return [make_raycast_frame(np.random.RandomState(100 + i), NUM_POINTS)
            for i in range(n)]


def k1_work(idx, n_in, k):
    """What one K1 launch executes, from its plan: hit (tap, row) pairs,
    (64-row tile, tap) pairs with a hit, and the rows the product runs on
    under v1's rule (all 64 rows of such a pair) and under v2's (the hits
    compacted into chunks of 8)."""
    b, n_out = idx.shape[0], idx.shape[1] // k
    hit = ((idx >= 0) & (idx < n_in)).view(b, k, n_out).int()
    hit = torch.nn.functional.pad(hit, (0, (-n_out) % K1_TILE_ROWS))
    per = hit.view(b, k, -1, K1_TILE_ROWS).sum(-1)
    tile_taps = int((per > 0).sum().item())
    return dict(pairs=int(per.sum().item()), tile_taps=tile_taps,
                v1_rows=K1_TILE_ROWS * tile_taps,
                v2_rows=8 * int(((per + 7) // 8).sum().item()))


def k1_check(label, launch, plain, f, idx, w):
    """One K1 launch against the plain version, and a second launch that
    must give the same bits. Returns (output, plain output, max abs err)."""
    out = launch(f, idx, w)
    again = launch(f, idx, w)
    ref = plain(f, idx, w)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item() if out.numel() else 0.0
    tol = 1e-4 * (ref.abs().max().item() if ref.numel() else 0.0) + 1e-5
    check(torch.isfinite(out).all(), f"{label}: non-finite output")
    check(err <= tol, f"{label}: max abs err {err} > {tol}")
    check(torch.equal(out, again), f"{label}: a repeat launch differs")
    return out, ref, err


def k1_edge_cases(launch, plain):
    """K1 against its plain version where the v2 design breaks first: Cin
    5 (padded to 8, 4-byte row copies) and 12 (padded to 16), Cin 72, 96
    and 128 (the widest instantiations, at each column-block width), Cout 6
    (4-byte W copies), Cout 8 and 12 (a partial m16 slice), Cout 128 (two
    column blocks), N_out not a multiple of the 64-row tile, N_out > N_in +
    1, an all-miss plan, a tile with a single hit (row, tap), and B = 2
    with different occupancies. Each repeat launch must give the same
    bits."""
    g = torch.Generator(device="cuda").manual_seed(4)
    # (B, N_in, N_out, K, Cin, Cout, hit share per sample)
    cases = [(1, 300, 300, 27, 5, 16, (0.3,)),
             (1, 300, 257, 27, 12, 8, (0.3,)),
             (1, 200, 130, 27, 16, 12, (0.5,)),
             (1, 300, 200, 27, 32, 6, (0.3,)),
             (1, 500, 200, 27, 64, 128, (0.3,)),
             (1, 300, 200, 27, 128, 16, (0.3,)),
             (1, 300, 190, 27, 96, 32, (0.3,)),
             (1, 400, 200, 3, 72, 128, (0.6,)),
             (1, 50, 300, 27, 32, 32, (0.2,)),
             (1, 100, 100, 27, 16, 16, (0.0,)),
             (1, 100, 100, 27, 32, 64, ("single",)),
             (2, 400, 333, 27, 32, 64, (0.05, 0.6))]
    for b, n_in, n_out, k, cin, cout, shares in cases:
        f = torch.randn(b, n_in, cin, device="cuda", generator=g)
        w = torch.randn(k, cin, cout, device="cuda", generator=g) * 0.3
        rows = torch.randint(0, n_in, (b, k * n_out), device="cuda",
                             generator=g, dtype=torch.int32)
        idx = torch.full_like(rows, n_in)
        for i, share in enumerate(shares):
            if share == "single":  # one hit: row 70 (second tile), tap 5
                idx[i, 5 * n_out + 70] = rows[i, 0]
            else:
                keep = torch.rand(k * n_out, device="cuda", generator=g)
                idx[i] = torch.where(keep < share, rows[i], idx[i])
        label = (f"K1 edge case B={b} N_in={n_in} N_out={n_out} Cin={cin} "
                 f"Cout={cout} hits={shares}")
        out, _, _ = k1_check(label, launch, plain, f, idx, w)
        if shares == (0.0,):
            check(not out.any(), f"{label}: an all-miss plan gave non-zeros")
    log("K1 edge cases (Cin 5, 12, 72, 96 and 128, Cout 6, 8, 12 and 128, "
        "N_out not a multiple of 64, N_out > N_in + 1, all-miss, a single "
        "hit, B = 2 with different occupancies): agree with the plain "
        "version, and repeat launches give the same bits")


def phase_k1(model, cfg, frame, dev):
    """Capture every K1 launch of one forward; hold each against the plain
    version (and a repeat launch against the first, bit for bit) and time
    both."""
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

    k1_edge_cases(launch, K.sparse_conv_plain)
    rows, max_err = [], 0.0
    log("K1 per launch (tolerance: max|kernel - plain| <= 1e-4*max|plain| "
        "+ 1e-5; a repeat launch equals the first bit for bit). Rows run: "
        "v1 = 64 per (tile, tap) with a hit, v2 = hits in chunks of 8; "
        "bound = 3 x FLOP as TF32 on the tensor cores, f32_bound = FLOP on "
        "the f32 CUDA cores:")
    log("  kernel_ms is the stream time of back-to-back wrapper calls (CUDA "
        "events); device_ms queues the same calls behind a spin, so it "
        "times the card alone where the host is slower than the card")
    log("  #  N_in    N_out  K  Cin Cout  hit_pairs  tile_taps  v1_rows   "
        "v2_rows   kernel_ms  device_ms plain_ms  bound_ms  bound_by   "
        "f32_bound_ms max_abs_err")
    for i, (f, idx, w) in enumerate(captured):
        b, n_in, cin = f.shape
        k, _, cout = w.shape
        n_out = idx.shape[1] // k
        _, _, err = k1_check(f"launch {i}", launch, K.sparse_conv_plain, f,
                             idx, w)
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: launch(f, idx, w), 20)
        dev_ms = device_ms(lambda: launch(f, idx, w), 20)
        plain_ms = cuda_ms(lambda: K.sparse_conv_plain(f, idx, w), 5)
        work = k1_work(idx, n_in, k)
        flops = 2.0 * work["pairs"] * cin * cout
        nbytes = 4.0 * (idx.numel() + f.numel() + w.numel() + b * n_out * cout)
        # K1 runs its products on the tensor cores as 3xTF32
        t_ops, t_bytes = 3 * flops / TF32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        bound_ms = 1e3 * max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        f32_bound_ms = 1e3 * max(flops / FP32_FLOP_PER_S, t_bytes)
        rows.append(dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, f32_bound_ms=f32_bound_ms,
                         t_ops=t_ops, t_bytes=t_bytes, flops=flops, **work))
        log(f"  {i:<2d} {n_in:<7d} {n_out:<6d} {k:<2d} {cin:<4d} {cout:<4d} "
            f"{work['pairs']:<10d} {work['tile_taps']:<10d} "
            f"{work['v1_rows']:<9d} {work['v2_rows']:<9d} {ms:<10.4f} "
            f"{dev_ms:<9.4f} {plain_ms:<9.4f} {bound_ms:<9.5f} {bound_by:<10} "
            f"{f32_bound_ms:<12.5f} {err:.3g}")
    total = {key: sum(r[key] for r in rows) for key in rows[0]}
    log(f"K1 per frame: {len(rows)} launches, kernel {total['ms']:.4f} ms "
        f"(device time {total['device_ms']:.4f} ms), "
        f"plain {total['plain_ms']:.4f} ms, bound {total['bound_ms']:.5f} ms, "
        f"f32 bound {total['f32_bound_ms']:.5f} ms "
        f"({total['flops'] / 1e9:.3f} GFLOP in {total['pairs']} hit pairs; "
        f"rows run v1 "
        f"{total['v1_rows']} ({total['v1_rows'] / total['pairs']:.3f}x the "
        f"hits), v2 {total['v2_rows']} "
        f"({total['v2_rows'] / total['pairs']:.3f}x))")
    return dict(
        name="sparse_conv_gather_gemm", route="cuda",
        source="df3d_torch/csrc/sparse_conv.cu",
        replaces="df3d/ops/pallas/sparse_conv_kernel.py:42",
        max_abs_err=max_err, ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"],
        bound_by=("operations" if total["t_ops"] >= total["t_bytes"]
                  else "bytes"),
        library_ms=None, device_ms=total["device_ms"],
        f32_bound_ms=total["f32_bound_ms"])


def profile_frame(run_frame):
    """One frame, `run_frame()`, under torch.profiler: device-busy share of
    the wall time and the kernels that take the most device time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run_frame()
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


def timed_path(label, run, cfg, inputs, n_frames, per_frame):
    """`run(*inputs[i])` on full-width frames: one warm-up pass over the
    inputs, then `n_frames` timed frames with every kernel's launch count
    set to 0 just before and read just after; `per_frame` maps each kernel
    module to the launches a frame must make. Prints ms/frame, launches,
    peak memory, overflows and kept boxes, then a host-clock stage split
    and a one-frame profile of inputs[0]. Returns the launch counts."""
    from df3d_torch.utils import stages

    for args in inputs:
        run(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    for kernel in per_frame:
        kernel.launches = 0
    per_frame_ms, dets = [], []
    for i in range(n_frames):
        t0 = time.perf_counter()
        det, overflow = run(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
        per_frame_ms.append(1e3 * (time.perf_counter() - t0))
        dets.append((det, overflow))
    launches = {k: k.launches for k in per_frame}
    peak = torch.cuda.max_memory_allocated()

    for kernel, want in per_frame.items():
        check(launches[kernel] == want * n_frames,
              f"{label}: {kernel.SOURCE} launched {launches[kernel]} times "
              f"in {n_frames} frames, expected {want} per frame")
    for det, _ in dets:
        for key, t in det.items():
            if t.is_floating_point():
                check(torch.isfinite(t).all(), f"{label}: non-finite {key}")
        shape = (1, len(cfg.tasks) * cfg.nms_post_max_size, 9)
        check(tuple(det["boxes"].shape) == shape,
              f"{label}: boxes {tuple(det['boxes'].shape)}, expected {shape}")
    log(f"{label}: {n_frames} frames, ms/frame mean "
        f"{np.mean(per_frame_ms):.3f} median {np.median(per_frame_ms):.3f} "
        f"min {np.min(per_frame_ms):.3f}; per frame "
        f"{[round(x, 3) for x in per_frame_ms]}")
    log(f"{label}: launches "
        + ", ".join(f"{k.SOURCE} {v} ({v // n_frames} per frame)"
                    for k, v in launches.items())
        + f"; peak memory {peak / 2**30:.3f} GiB")
    for i, (det, overflow) in enumerate(dets[:len(inputs)]):
        log(f"{label} frame {i}: kept boxes {int(det['valid'].sum())}; cap "
            "overflow " + ", ".join(f"{k}={int(v.sum())}"
                                    for k, v in overflow.items()))
    with torch.no_grad(), stages.recording() as split:
        run(*inputs[0])
    log(f"{label} stage split (ms, host clock, synchronised): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    profile_frame(lambda: run(*inputs[0]))
    return launches


def phase_main_path(model, cfg, frames, dev):
    from df3d_torch.entry import infer
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1

    inputs = [(torch.from_numpy(f[None]).to(dev),
               torch.ones(1, len(f), dtype=torch.bool, device=dev))
              for f in frames]
    return timed_path("main path", lambda *a: infer(model, cfg, *a), cfg,
                      inputs, TIMED_FRAMES, {K1: K1_PER_FRAME, K2: 0})


def fused_inputs(frame, num_cams, image_shape, dev, seed):
    """(points, valid, images, proj) on `dev` for one fused frame: the
    lidar frame, random normalized images and the nuScenes-like rig."""
    from df3d_torch.utils.synth import camera_rig

    g = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randn(1, num_cams, *image_shape, 3, generator=g,
                         device=dev)
    proj = torch.from_numpy(camera_rig(num_cams, image_shape)[None]).to(dev)
    pts = torch.from_numpy(frame[None]).to(dev)
    valid = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    return pts, valid, images, proj


def small_fused_configs():
    from df3d_torch.entry import centerpoint_3ddf_nusc, fused_config, small_cfg

    preset = centerpoint_3ddf_nusc()
    actr = dataclasses.replace(preset["actr"], lt_npoint=64)
    return small_cfg(), fused_config(preset, image_shape=(64, 112),
                                     image_layers=(1, 1, 1, 1), num_cams=2,
                                     actr=actr)


def phase_small_fused(dev):
    from df3d_torch.entry import (
        build_centerpoint3ddf, infer_fused, random_points,
    )

    cfg, fcfg = small_fused_configs()
    frame = random_points(np.random.RandomState(1), 1, 2000)[0]
    card_vs_cpu("small fused input",
                lambda d: build_centerpoint3ddf(cfg, fcfg, d, seed=0), cfg,
                list(fused_inputs(frame, fcfg.num_cams, fcfg.image_shape,
                                  "cpu", 0)), infer_fused, dev)


def full_fused_configs():
    from df3d_torch.entry import centerpoint_3ddf_nusc, fused_config

    preset = centerpoint_3ddf_nusc()
    cfg = dataclasses.replace(preset["lidar"],
                              max_voxels=REALISTIC_STAGE_CAPS[0],
                              stage_caps=REALISTIC_STAGE_CAPS)
    return cfg, fused_config(preset)


def k2_edge_cases(launch, plain):
    """K2 against its plain version where a kernel breaks first: Q not a
    multiple of the block, head_dim other than 16, locations in [-0.2,
    1.2], samples on the last pixel centre (x = W-1, y = H-1), at -0.5 px,
    and far off the map."""
    g = torch.Generator(device="cuda").manual_seed(3)
    shapes = ((6, 9), (3, 5))
    for b, q, nh, d, p in ((2, 10, 2, 8, 4), (1, 1000, 8, 16, 4),
                           (3, 77, 3, 5, 2)):
        value = torch.randn(b, 69, nh, d, device="cuda", generator=g)
        locs = torch.rand(b, q, nh, 2, p, 2, device="cuda",
                          generator=g) * 1.4 - 0.2
        for lid, (h, w) in enumerate(shapes):
            locs[:, 0, :, lid, 0] = torch.tensor([(w - 0.5) / w,
                                                  (h - 0.5) / h])
        locs[:, 1, :, :, 0] = 0.0
        locs[:, 2, :, :, 0] = torch.tensor([-1e6, 1e7])
        attn = torch.rand(b, q, nh, 2, p, device="cuda", generator=g)
        out, ref = launch(value, shapes, locs, attn), plain(value, shapes,
                                                            locs, attn)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item() + 1e-5
        check(err <= tol, f"K2 edge case B={b} Q={q} nH={nh} D={d} P={p}: "
              f"max abs err {err} > {tol}")
    log("K2 edge cases (Q not a multiple of the block, D != 16, locations "
        "in [-0.2, 1.2], the last pixel centre, far off the map): agree "
        "with the plain version")


def phase_k2(model, cfg, inputs):
    """Capture every K2 launch of one fused frame (and count K1's); hold
    each K2 output against the plain version and time both."""
    from df3d_torch.entry import infer_fused
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1

    captured = []
    launch = K2.msda_cuda

    def recording(value, shapes, locs, attn):
        captured.append((value.clone(), tuple(shapes), locs.clone(),
                         attn.clone()))
        return launch(value, shapes, locs, attn)

    K1.launches = 0
    K2.msda_cuda = recording
    try:
        infer_fused(model, cfg, *inputs)
    finally:
        K2.msda_cuda = launch
    torch.cuda.synchronize()
    check(len(captured) == K2_PER_FUSED_FRAME,
          f"expected {K2_PER_FUSED_FRAME} K2 launch per fused frame, saw "
          f"{len(captured)}")
    check(K1.launches == K1_PER_FRAME,
          f"expected {K1_PER_FRAME} K1 launches per fused frame, saw "
          f"{K1.launches}")

    k2_edge_cases(launch, K2.msda_plain)
    rows, max_err = [], 0.0
    log("K2 per launch (tolerance: max|kernel - plain| <= 1e-4*max|plain| "
        "+ 1e-5):")
    for i, (value, shapes, locs, attn) in enumerate(captured):
        b, len_v, nh, d = value.shape
        q, nl, npnt = locs.shape[1], locs.shape[3], locs.shape[4]
        out = launch(value, shapes, locs, attn)
        ref = K2.msda_plain(value, shapes, locs, attn)
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        tol = 1e-4 * ref.abs().max().item() + 1e-5
        check(torch.isfinite(out).all(), f"K2 launch {i}: non-finite output")
        check(err <= tol, f"K2 launch {i}: max abs err {err} > {tol}")
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: launch(value, shapes, locs, attn), 20)
        plain_ms = cuda_ms(lambda: K2.msda_plain(value, shapes, locs, attn),
                           5)
        # the in-bounds corners this frame's locations need
        corners = 0
        for lid, (h, w) in enumerate(shapes):
            px = locs[:, :, :, lid, :, 0] * w - 0.5
            py = locs[:, :, :, lid, :, 1] * h - 0.5
            x0, y0 = torch.floor(px), torch.floor(py)
            for cx in (x0, x0 + 1):
                for cy in (y0, y0 + 1):
                    corners += int(((cx >= 0) & (cx < w) & (cy >= 0)
                                    & (cy < h)).sum().item())
        samples = b * q * nh * nl * npnt
        flops = float(K2_FLOP_PER_SAMPLE * samples + 2 * d * corners)
        nbytes = 4.0 * (value.numel() + locs.numel() + attn.numel()
                        + out.numel())
        t_ops, t_bytes = flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        bound_ms = 1e3 * max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        rows.append(dict(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                         t_ops=t_ops, t_bytes=t_bytes))
        log(f"  #{i}: value {tuple(value.shape)}, locations "
            f"{tuple(locs.shape)}, levels {list(shapes)}; in-bounds corners "
            f"{corners} of {4 * samples} ({corners / (4 * samples):.3f}); "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP; kernel "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.5f} ms "
            f"({bound_by}); max abs err {err:.3g} (tol {tol:.3g})")
    total = {key: sum(r[key] for r in rows) for key in rows[0]}
    return dict(
        name="msda_sampling", route="cuda", source="df3d_torch/csrc/msda.cu",
        replaces="df3d/ops/pallas/msda_kernel.py:31",
        max_abs_err=max_err, ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"],
        bound_by=("operations" if total["t_ops"] >= total["t_bytes"]
                  else "bytes"),
        library_ms=None)


def phase_fused_main_path(model, cfg, fcfg, frames, dev):
    from df3d_torch.entry import infer_fused
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1

    inputs = [fused_inputs(f, fcfg.num_cams, fcfg.image_shape, dev, 10 + i)
              for i, f in enumerate(frames)]
    launches = timed_path(
        "fused main path", lambda *a: infer_fused(model, cfg, *a), cfg,
        inputs, FUSED_TIMED_FRAMES, {K1: K1_PER_FRAME,
                                     K2: K2_PER_FUSED_FRAME})

    # which stage-4 voxels each camera sees (ACTR's query mask)
    seen = []
    handle = model.detector.backbone.fusion_hook.actr.register_forward_hook(
        lambda mod, inp, out: seen.append(inp[4]))
    infer_fused(model, cfg, *inputs[0])
    handle.remove()
    mask = seen[0].view(fcfg.num_cams, -1)
    log(f"queries: {mask.shape[1]} stage-4 rows per camera, "
        f"{fcfg.num_cams * mask.shape[1]} in all; share each camera sees "
        f"(of the rows): {[round(v, 4) for v in mask.float().mean(1).tolist()]}"
        f"; rows seen by any camera {int(mask.any(0).sum())}")
    return launches


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from df3d_torch.models.detectors.centerpoint import CenterPointConfig
    from df3d_torch.entry import build_centerpoint, build_centerpoint3ddf
    from df3d_torch.ops import build
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1

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
    lidar = phase_main_path(model, cfg, frames, dev)
    del model

    phase_small_fused(dev)
    fcfg_l, fcfg = full_fused_configs()
    fmodel = build_centerpoint3ddf(fcfg_l, fcfg, dev, seed=0)
    k2 = phase_k2(fmodel, fcfg_l, fused_inputs(frames[0], fcfg.num_cams,
                                               fcfg.image_shape, dev, 10))
    fused = phase_fused_main_path(fmodel, fcfg_l, fcfg, frames, dev)
    # each path's timed run, counts set to 0 just before it and read just
    # after; "launches" sums the paths
    for entry, kernel in ((k1, K1), (k2, K2)):
        entry["launches_by_path"] = {"lidar": lidar[kernel],
                                     "fused": fused[kernel]}
        entry["launches"] = lidar[kernel] + fused[kernel]

    log(f"card: {card}")
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
