#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths on one CUDA card: CenterPoint
(LiDAR only), CenterPoint + 3D-DF (six cameras + LiDAR), TransFusion-L
(LiDAR only) and TransFusion + 3D-DF (six cameras + LiDAR); then the
training steps of the same four models; then KITTI's Voxel R-CNN and
Voxel R-CNN + 3D-DF (one camera + LiDAR) serving paths and training
steps; then the training steps data parallel.

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
   coords and cap overflows; the card replays the CPU's pre-NMS top-k and
   NMS decisions only at near ties (`centerpoint_decisions`, within 1e-4,
   at most 4 entries), counted.
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
   kept boxes, same voxel coords and cap overflows, near ties replayed as
   in phase 3.
7. K2: one full-width fused frame (the `centerpoint_3ddf_nusc` preset: six
   448x800 cameras, DeepLabV3 ResNet-50 taps, ACTRv2 at d_model 128, the
   stage caps above); the inputs of every K2 launch are captured, each
   launch must take the kernel's warp path on the tensors the path passes,
   and its output is held against the plain version with the tolerance of
   phase 4 and a repeat launch against the first, bit for bit; so are
   small inputs at K2's edge cases, on both of the kernel's paths (the
   warp path at L = 3 and L = 1). Per launch: the stream time of
   back-to-back wrapper calls and the device time (as for K1), the plain
   version's time, the general path's device time on the same inputs (the
   value table copied to an address the warp path does not take), the
   bound (the locations, weights and output once and the (camera, pixel,
   head) value rows that in-bounds corners touch) and, beside it, the
   bound with the whole value table read. The frame must launch K2 once
   and K1 16 times.
8. fused main path: `infer_fused` on full-width frames (260k ray-cast
   points, six random normalized images, the nuScenes-like rig of
   `utils.synth.camera_rig`), warm-up then timed frames, launch counts set
   to 0 around the loop. Prints ms/frame, peak memory, the share of the
   stage-4 voxels each camera sees, a host-clock stage split and a
   one-frame profile.
9. small TransFusion-L input: `infer_transfusion` on the card against the
   CPU on a small config: dense heatmap to atol = rtol = 1e-3, equal query
   labels and query positions, every branch, boxes and scores to 1e-3,
   equal voxel coords and cap overflows; the card replays the CPU's query
   top-k only at near ties (`transfusion_decisions`, within 1e-4, at most
   4 slots), counted.
10. TransFusion-L (the `transfusion_l_nusc` preset, the stage caps above):
   every K1 launch of one full-width frame against the plain version, as
   in phase 4 (no edge cases again), then `infer_transfusion` on
   full-width frames as phase 5 does: K1 16 launches per frame, K2 none.
11. small TransFusion + 3D-DF input: `infer_transfusion_fused` on the card
   against the CPU, 2 cameras of 64x112 (FPN levels that do not halve
   exactly), one-block ResNet stages, tolerances of phase 9.
12. K2 at the `transfusion_3ddf_nusc` preset's shapes (six 448x800
   cameras, ResNet-50 + FPN, ACTRv2 of two layers on FPN level P2, 112x200
   at 256 channels): both launches of one full-width frame, each on the
   warp path (L = 1) and held against the plain version as in phase 7.
   The frame must launch K2 twice and K1 16 times.
13. TransFusion + 3D-DF main path: `infer_transfusion_fused` on full-width
   frames as phase 8 does: K1 16 and K2 2 launches per frame.
14. small train step: one step of `entry.build_centerpoint_trainer` on the
   card against the same step on the CPU (the JAX package's multichip
   dry-run config at batch 2, its gt layout, the same weights and points):
   loss, every gradient leaf, the parameters and batch statistics after the
   step and the cap overflow (tolerances in `phase_small_train`: K1 runs
   3xTF32 on the card, the plain version f32 on the CPU).
15. K1 in the backward, at full width (`CenterPointConfig()`, batch 4, four
   260k-point ray-cast frames with their scenes' 79 object boxes): every K1
   launch of one step, its forward's 16 and its backward's 15 (the sparse
   convs' input gradients: the same plan with flipped, transposed taps, or
   the transposed plan), against the plain version with phase 4's
   tolerance and a repeat launch bit for bit; each conv's input gradient on
   the card against torch autograd of the plain version; per backward
   launch Cin, Cout, hit pairs, times and bound; each conv's dW time.
16. train path: the trainer at full width, batch 4, on that fixed batch:
   warm-up steps, then timed steps with K1's counts set to 0 just before and
   read just after (16 forward and 15 backward launches a step, K2 none);
   every loss finite and falling below the first step's within 5 steps, no
   cap overflow; ms/step, a host-clock split, peak memory, a one-step
   profile. It starts from phase 15's state, whose running statistics that
   phase's forward moved once.
17. small fused train step: one step of `entry.build_centerpoint3ddf_trainer`
   on the card against the same step on the CPU (tests/
   test_torch_fused_slice.py's config at batch 2, phase 14's points and gt
   layout, the same weights, images and rig), as phase 14: tight with
   cuDNN off and the plain versions of K1 and K2, then by L2 with the
   kernels; the card replays the CPU's ReLU decisions where its own
   disagree (at most 4 such inputs, each within 1e-4 of 0;
   `phase_small_fused_train`), and the frozen image branch stays
   unchanged on both.
18. K2 at full width in training (`centerpoint_3ddf_nusc` with
   `CenterPointConfig()`'s training caps, batch 4 x six 448x800 cameras,
   phase 15's frames and boxes, random normalized images, the rig): the
   inputs of one step's K2 forward launch are captured, and it must take
   the warp path and agree with the plain version as in phase 7 (and bit
   for bit on a repeat launch); the inputs and incoming gradient of the
   step's K2 backward launch are captured; dvalue, dloc and dattn are held against autograd of the plain
   version (max|err| <= 1e-4 * max|ref| + 1e-5 each), a repeat launch
   gives the same dloc and dattn bits and dvalue (f32 atomics) within the
   tolerance; so do small inputs at its edge cases on both paths (corners
   off the map and on its last row and column, exact integer pixel
   positions, L 1 and 3, D 8, zero weights, a zero cotangent). Prints the
   launch's back-to-back and device time, the plain version's time and
   the bound (bytes of g, dloc, dattn and dvalue once, and of the
   locations and weights of the queries with g != 0 and the value rows
   their in-bounds corners touch).
19. fused train path: that trainer at full width, batch 4, on that fixed
   batch: warm-up steps, then timed steps with every kernel's counts set
   to 0 just before and read just after (K1 16 forward and 15 backward, K2
   1 forward and 1 backward launches a step); every loss finite and
   falling below the first step's within 5 steps, no row dropped by a cap,
   the frozen image branch unchanged; ms/step, a host-clock split, peak
   memory, a one-step profile. It starts from phase 18's state.
20. small TransFusion-L train step: one step of
   `entry.build_transfusion_trainer` on the card against the same step on
   the CPU (tests/test_torch_transfusion_slice.py's config at batch 2, four
   boxes of three classes a sample), as phase 17: the card replays the
   CPU's ReLU decisions, queries (top-k) and Hungarian matches where its own
   differ, each a near tie, counted and bounded
   (`small_step_card_vs_cpu`).
21. TransFusion-L training at full width (`transfusion_l_nusc`'s
   `TransFusionConfig()` with its training caps, batch 4, phase 15's
   frames and boxes): every K1 launch of one step, forward (16) and
   backward (15), as phase 15; then timed steps as phase 16 (K1 16 + 15 a step, K2 none, at least
   one query matched each step, the split with its `assign` stage).
22. small TransFusion + 3D-DF train step: as phase 20 on the fused config
   of that test (2 cameras of 64x112, ResNet + FPN, two ACTR layers on one
   level), K2 2 forward and 2 backward launches.
23. TransFusion + 3D-DF training at full width (`transfusion_3ddf_nusc`
   with `TransFusionConfig()`'s training caps, batch 4 x six 448x800
   cameras, 24 value tables at one level, 112x200): both K2 forward
   launches of one step against the plain version and both K2 backward
   launches (one each per ACTR layer) against autograd of the plain
   version, and the edge cases (the L = 1 warp-path ones among them), as in
   phase 18; then timed steps as phase 19 (K1 16 + 15, K2 2 + 2 a step).
24. small KITTI inputs: `infer_voxelrcnn` and `infer_voxelrcnn_fused` on
   the card against the CPU (tests/test_torch_voxelrcnn_slice.py's tiny
   config, the fused one with the preset's ACTRv2 on one 96x320 camera):
   voxel coords, cap overflows, roi_mask and valid equal; RPN maps, RoIs,
   RCNN cls and reg, boxes and scores to atol = rtol = 1e-3; the card
   replays the CPU's NMS and RoI-neighbour decisions only at near ties
   (`voxelrcnn_decisions`, within 1e-4, at most 4 calls), counted.
25. KITTI frames (`utils.synth.make_kitti_frame`: one 64-beam sweep cut to
   the front camera's view, ~20k points): each frame's voxels against
   max_voxels and each stage's rows against its cap, with the rows the
   caps drop; every K1 launch of one `voxel_rcnn_car_kitti` frame (12:
   Cin 4 to 64, 27 taps, and `conv_out`'s 3) against the plain version as
   in phase 4.
26. Voxel R-CNN main path: `infer_voxelrcnn` on full-width frames as phase
   5 does: K1 12 launches a frame, K2 none.
27. K2 at `voxel_rcnn_3ddf_kitti`'s shapes (one 384x1280 camera, the
   DeepLabV3 taps at 96x320, 48x160 and 48x160, d_model 64 with 8 heads
   of 8): its edge cases at nH 8, D 8, then the frame's launch, which must
   take the general path (the warp path takes only 128 channels), held
   against the plain version as in phase 7.
28. Voxel R-CNN + 3D-DF main path: `infer_voxelrcnn_fused` on full-width
   frames as phase 8 does (the camera of `utils.synth.kitti_camera`): K1
   12 and K2 1 launches a frame; the share of stage-4 rows the camera
   sees.
29. small KITTI train steps: one step of `entry.build_voxelrcnn_trainer`
   and one of `build_voxelrcnn3ddf_trainer` on the card against the same
   step on the CPU (the configs of tests/test_torch_voxelrcnn_train_step.py
   and tests/test_torch_voxelrcnn_fused_train_step.py at batch 2, gts near
   the first stage's proposals, the same RoI sampler noise), as phase 20:
   tight with the plain versions and cuDNN off, by L2 with the kernels;
   the card replays the CPU's ReLU, NMS and neighbour decisions at near
   ties and takes the CPU's proposals (no gradient flows through them)
   after holding its own against them (`kitti_train_decisions`); every
   log, gradient leaf, batch statistic and updated parameter compared.
30. K1 at the Voxel R-CNN training step's shapes (`voxel_rcnn_car_kitti`,
   batch 2 of `utils.synth.make_kitti_sample`: phase 25's frames with
   their cars): every K1 launch of one step, its forward's 12 and its
   backward's 11 input gradients (`conv_out`'s over its transposed plan
   among them), against the plain version and a repeat launch as in phase
   15, each timed with its bound.
31. Voxel R-CNN train path: that trainer on that fixed batch, as phase 16:
   K1 12 + 11 launches a step, K2 none; ms/step, the split (with
   rpn_targets, proposal, roi_sample and roi_head), a one-step profile,
   peak memory, losses falling; the caps' dropped rows printed (down2's
   cap drops rows on these frames, ROADMAP section 3).
32. K2 at the Voxel R-CNN + 3D-DF step's shapes (`voxel_rcnn_3ddf_kitti`,
   batch 2, a random 384x1280 image a sample): the step's forward and
   backward launch, each on the general path (nH 8, D 8), against the
   plain version and its autograd as in phase 18, KITTI's backward edge
   cases, times and bounds.
33. Voxel R-CNN + 3D-DF train path: that trainer, as phase 19: K1 12 + 11,
   K2 1 + 1 launches a step.
34. small data-parallel steps: each of the six small steps (phases 14,
   17, 20, 22 and 29's configs and batches, the second sample's points and
   gt boxes cut so that the samples differ) over 2 ranks that share the
   card over gloo, one sample each (`train.trainer.DataParallelTrainStep`,
   spawned processes), against the one-process batch-2 step on the card:
   the ranks replay its decisions at near ties as the small phases do,
   are held by those phases' tolerances for the kernels' run, and end
   with the same bits.
35. data-parallel fused step at full width: `centerpoint_3ddf_nusc` at
   batch 4 (phase 18's batch and weights) as 2 ranks x 2 samples sharing
   the card, against the one-process batch-4 step run first and freed:
   every gradient leaf, updated parameter, batch statistic and log by
   relative L2; each rank launches K1 16 + 15 and K2 1 + 1 in its step
   (counts set to 0 just before and read just after), and rank 0 holds
   every launch of its step against the plain version (phases 15 and 18's
   helpers); per rank ms/step, the split with its `allreduce` stage, the
   gradient bytes all-reduced and peak memory. Two ranks on one card are
   not a two-card measurement.
36. `entry.dryrun_multichip` over every card (one rank each, NCCL): a
   CenterPoint and a CenterPoint + 3D-DF step, finite losses.

TF32 is off for matmuls and cuDNN convs: the port serves in f32 (the JAX
package's "exact" profile) and the comparisons need full f32. cuDNN picks
its conv algorithms by timing them (cudnn.benchmark).

Each timed path prints a host-clock stage split (`df3d_torch.utils.stages`)
and a one-frame profile. The last two lines of stdout are one JSON object
on the kernels (times from this run, bounds from this run's inputs,
launches from the timed runs of the four serving and four training paths,
also given by path; both give their device time, K1 its f32 CUDA-core
bound, K2 its whole-table bound and general-path time; the top-level
numbers are those of the CenterPoint paths, under "transfusion" those of
the TransFusion ones, under K1's "train" its CenterPoint training
launches, backward times and dW's time, and under K2's "train" its
CenterPoint + 3D-DF training launches and its backward's times and bound;
"transfusion"'s "train" the same for the TransFusion training steps,
"kitti" those of the KITTI paths, phases 25 and 27, "kitti"'s "train"
those of the KITTI training steps, phases 30 and 32, and "dp" phase 35's
launches per rank and rank 0's kernel numbers) and the result line
{"ok": true, "device": {...}}. With no CUDA device, or outside a checkout,
the script exits non-zero without them.
"""

import contextlib
import dataclasses
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

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
K2_PER_TRANSFUSION_FUSED_FRAME = 2  # one per ACTR layer
# training: batch, steps, and K1's input-gradient launches a step (every
# sparse conv but conv_input, whose input, the voxel features, needs none)
TRAIN_BATCH = 4
TRAIN_WARMUP_STEPS = 2
TRAIN_TIMED_STEPS = 5
K1_BWD_PER_STEP = 15
SCENE_CLASSES = (0,) * 52 + (1,) * 9 + (8,) * 18
# a K2 output element costs ~14 FLOP of corner arithmetic per sample and
# head (shared by its D channels) plus a multiply-add per in-bounds corner
K2_FLOP_PER_SAMPLE = 14
# K2's backward: ~30 FLOP per sample (corner weights, dattn, dloc) and per
# in-bounds corner and channel a multiply-add for g . v and a multiply and
# an add for dvalue
K2_BWD_FLOP_PER_SAMPLE = 30


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


def to_cpu(tree):
    """The tensors of nested dicts and lists, on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def run_card_and_cpu(label, build, cfg, inputs, infer_fn, dev,
                     decisions=None):
    """The path with its kernels on the card and the same path with the
    plain versions on the CPU: same weights (`build(device)`) and inputs
    (CPU tensors: points, valid, then the fused path's images and proj).
    With `decisions` (`transfusion_decisions`), the CPU run records the
    path's decisions and the card run replays them at near ties: at most
    4 entries differ, each a tie within 1e-4 on the card, counted.
    Checks that voxel coords and cap overflows are equal; returns (CPU
    run, card run), each (head predictions, detections, overflows) on the
    CPU, and the replays."""
    from df3d_torch.ops.voxelize import voxelize_batch

    out, store, replays = [], [], []
    for d, replay in (("cpu", False), (dev, True)):
        model = build(d)
        args = [t.to(d) for t in inputs]
        decided = (decisions(store, replay) if decisions
                   else contextlib.nullcontext([]))
        with torch.no_grad(), decided as replays:
            res = voxelize_batch(args[0], args[1], cfg.voxel_size,
                                 cfg.pc_range, cfg.grid_size, cfg.max_voxels,
                                 cfg.max_points_per_voxel)
            preds, _, _ = model(res.features, res.coords, *args[2:])
            det, overflow = infer_fn(model, cfg, *args)
        out.append(to_cpu((res.coords, preds, det, overflow)))
    (c_coords, *cpu), (g_coords, *card) = out
    check(sum(n for _, n, _ in replays) <= 4
          and all(gap < 1e-4 for *_, gap in replays),
          f"{label}: more than 4 decisions differ from the CPU's, or one is "
          f"no tie within 1e-4: {replays}")
    check(torch.equal(c_coords, g_coords), f"{label}: voxel coords differ")
    for k in cpu[2]:
        check(torch.equal(cpu[2][k], card[2][k]), f"{label}: {k} differs")
    return cpu, card, replays


def card_vs_cpu(label, build, cfg, inputs, infer_fn, dev):
    """CenterPoint's paths, card against CPU (`run_card_and_cpu`): voxel
    coords, cap overflows and kept boxes equal; head maps to atol = rtol =
    1e-3. The card replays the CPU's pre-NMS top-k and NMS decisions where
    its own differ, each a near tie within 1e-4, at most 4 entries
    (`centerpoint_decisions`), counted."""
    (c_preds, c_det, c_ov), (g_preds, g_det, _), replays = run_card_and_cpu(
        label, build, cfg, inputs, infer_fn, dev, centerpoint_decisions)
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
        f"{worst:.3g}, {int(m.sum())} kept boxes equal (decision replays "
        f"{replays}), cap overflow "
        + ", ".join(f"{k}={int(v.sum())}" for k, v in c_ov.items()))


def transfusion_card_vs_cpu(label, build, cfg, inputs, infer_fn, dev):
    """TransFusion's paths, card against CPU (`run_card_and_cpu`): voxel
    coords, cap overflows, query labels, query positions and decoded labels
    equal; the dense heatmap, every branch, boxes and scores to atol = rtol
    = 1e-3. Two heatmap scores within the card's rounding of each other
    can swap in the query top-k, which then moves every query after them:
    the card replays the CPU's queries where its own differ, each a near
    tie within 1e-4, at most 4 slots (`transfusion_decisions`), counted."""
    (c_preds, c_det, c_ov), (g_preds, g_det, _), replays = run_card_and_cpu(
        label, build, cfg, inputs, infer_fn, dev, transfusion_decisions)
    for k in ("query_labels", "query_pos_xy"):
        check(torch.equal(c_preds[k], g_preds[k]), f"{label}: {k} differ")
    check(torch.equal(c_det["labels"], g_det["labels"]),
          f"{label}: decoded labels differ")
    worst = 0.0
    for tree_c, tree_g in ((c_preds, g_preds), (c_det, g_det)):
        for k, t in tree_c.items():
            if not t.is_floating_point():
                continue
            check(torch.isfinite(tree_g[k]).all(), f"{label}: non-finite {k}")
            torch.testing.assert_close(tree_g[k], t, atol=1e-3, rtol=1e-3)
            worst = max(worst, (tree_g[k] - t).abs().max().item())
    log(f"{label}: card vs CPU plain path agree: {c_preds['query_labels'].numel()}"
        f" query labels and positions equal (top-k replays {replays}), "
        f"max diff of the heatmap, "
        f"branches, boxes and scores {worst:.3g}, cap overflow "
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


def capture_k1(model, cfg, frame, dev, infer_fn=None):
    """The (features, gather_idx, weights) of every K1 launch of one
    `infer_fn` (default `entry.infer`) of `frame`, cloned as the wrapper was
    given them."""
    from df3d_torch.entry import infer
    from df3d_torch.ops import sparse_conv_kernel as K

    infer_fn = infer_fn or infer

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
        infer_fn(model, cfg, pts, valid)
    finally:
        K.sparse_conv_cuda = launch
    torch.cuda.synchronize()
    return captured


def phase_k1(model, cfg, frame, dev, infer_fn=None, edge_cases=True,
             per_frame=K1_PER_FRAME):
    """Capture every K1 launch of one forward (`infer_fn`, default
    `entry.infer`; `per_frame` of them); hold each against the plain
    version (and a repeat launch against the first, bit for bit) and time
    both. With `edge_cases`, K1's edge cases first."""
    from df3d_torch.ops import sparse_conv_kernel as K

    captured = capture_k1(model, cfg, frame, dev, infer_fn)
    launch = K.sparse_conv_cuda
    check(len(captured) == per_frame,
          f"expected {per_frame} K1 launches per frame, saw {len(captured)}")

    if edge_cases:
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


def timed_path(label, run, n_boxes, inputs, n_frames, per_frame,
               box_dim=9):
    """`run(*inputs[i])` on full-width frames: one warm-up pass over the
    inputs, then `n_frames` timed frames with every kernel's launch count
    set to 0 just before and read just after; `per_frame` maps each kernel
    module to the launches a frame must make, and each frame's detections
    must hold `n_boxes` finite boxes. Prints ms/frame, launches, peak
    memory, overflows and kept boxes (those marked valid where the decode
    marks them), then a host-clock stage split and a one-frame profile of
    inputs[0]. Boxes are `box_dim` wide. Returns the launch counts."""
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
        shape = (1, n_boxes, box_dim)
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
        kept = int(det["valid"].sum()) if "valid" in det else n_boxes
        log(f"{label} frame {i}: kept boxes {kept}; cap "
            "overflow " + ", ".join(f"{k}={int(v.sum())}"
                                    for k, v in overflow.items()))
    with torch.no_grad(), stages.recording() as split:
        run(*inputs[0])
    log(f"{label} stage split (ms, host clock, synchronised): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    profile_frame(lambda: run(*inputs[0]))
    return launches


def phase_main_path(label, model, cfg, frames, dev, infer_fn, n_boxes):
    """`timed_path` of a LiDAR-only path (`infer_fn`): K1 16 launches per
    frame, K2 none."""
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1

    inputs = [(torch.from_numpy(f[None]).to(dev),
               torch.ones(1, len(f), dtype=torch.bool, device=dev))
              for f in frames]
    return timed_path(label, lambda *a: infer_fn(model, cfg, *a), n_boxes,
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


K2_LEVELS = ((6, 9), (3, 5), (4, 7))
K2_LEVELS_8 = ((6, 9), (3, 5), (4, 7), (2, 3), (5, 5), (1, 1), (7, 2),
               (3, 3))


def k2_inputs(g, b, q, nh, d, shapes, p, off_map=(), value_offset=0):
    """Seeded K2 inputs on the card: locations in [-0.2, 1.2] and, at
    every level, point 0 of query 0 on the last pixel centre (x = W-1, y =
    H-1), of query 1 at -0.5 px and of query 2 far off the map; every
    sample of the queries in `off_map` far off the map. With
    `value_offset` the value table starts that many floats into its
    storage (a pointer the warp path does not take)."""
    len_v = sum(h * w for h, w in shapes)
    storage = torch.randn(value_offset + b * len_v * nh * d, device="cuda",
                          generator=g)
    value = storage[value_offset:].view(b, len_v, nh, d)
    locs = torch.rand(b, q, nh, len(shapes), p, 2, device="cuda",
                      generator=g) * 1.4 - 0.2
    for lid, (h, w) in enumerate(shapes):
        locs[:, 0, :, lid, 0] = torch.tensor([(w - 0.5) / w, (h - 0.5) / h])
    locs[:, 1 % q, :, :, 0] = 0.0
    locs[:, 2 % q, :, :, 0] = torch.tensor([-1e6, 1e7])
    for i in off_map:
        locs[:, i] = torch.tensor([-1e6, 1e7])
    attn = torch.rand(b, q, nh, len(shapes), p, device="cuda", generator=g)
    return value, locs, attn


def k2_check(label, launch, plain, value, shapes, locs, attn):
    """One K2 launch against the plain version, and a second launch that
    must give the same bits. Returns (output, plain output, max abs err,
    tolerance)."""
    out = launch(value, shapes, locs, attn)
    again = launch(value, shapes, locs, attn)
    ref = plain(value, shapes, locs, attn)
    torch.cuda.synchronize()
    err = (out - ref).abs().max().item()
    tol = 1e-4 * ref.abs().max().item() + 1e-5
    check(torch.isfinite(out).all(), f"{label}: non-finite output")
    check(err <= tol, f"{label}: max abs err {err} > {tol}")
    check(torch.equal(out, again), f"{label}: a repeat launch differs")
    return out, ref, err, tol


# (B, Q, nH, D, levels, P, off-map queries, value offset, warp path)
K2_EDGE_CASES = (
    [(2, 37, 8, 16, K2_LEVELS, 4, (9,), 0, True),
     (1, 1, 8, 16, K2_LEVELS, 4, (), 0, True),
     (6, 20, 8, 16, K2_LEVELS, 4, (11,), 0, True),
     (2, 37, 8, 16, K2_LEVELS[:1], 4, (9,), 0, True),
     (6, 20, 8, 16, K2_LEVELS[2:], 4, (11,), 0, True),
     (2, 37, 8, 16, K2_LEVELS, 4, (9,), 1, False),
     (2, 37, 8, 16, K2_LEVELS[:1], 4, (9,), 1, False),
     (2, 10, 2, 8, K2_LEVELS[:2], 4, (), 0, False),
     (1, 1000, 8, 16, K2_LEVELS[:2], 4, (), 0, False),
     (3, 77, 3, 5, K2_LEVELS[:2], 2, (), 0, False),
     (1, 50, 4, 8, K2_LEVELS[:1], 1, (5,), 0, False),
     (2, 33, 2, 8, K2_LEVELS_8, 2, (), 0, False)],
    "warp path at L = 3 and L = 1: a small map, Q = 37 and 1, B = 6, an "
    "off-map query inside a block; general path: unaligned tables at L = 3 "
    "and 1, D 5 and 8, nH 2 and 3, L 1, 2 and 8, P 1 and 2")
# KITTI's head shape: nH 8, D 8 (64 channels, which the warp path refuses)
K2_KITTI_EDGE_CASES = (
    [(1, 37, 8, 8, K2_LEVELS, 4, (9,), 0, False),
     (1, 1, 8, 8, K2_LEVELS, 4, (), 0, False),
     (2, 1000, 8, 8, K2_LEVELS, 4, (), 0, False),
     (1, 37, 8, 8, K2_LEVELS[:1], 4, (9,), 0, False),
     (1, 37, 8, 8, K2_LEVELS, 4, (9,), 1, False)],
    "KITTI's nH 8, D 8 on the general path: L 3 and 1, Q 37, 1 and 1000, "
    "B 2, an unaligned table, an off-map query")


def k2_edge_cases(launch, plain, warp_path, cases=K2_EDGE_CASES):
    """K2 against its plain version on `cases`, a (list of (B, Q, nH, D,
    levels, P, off-map queries, value offset, warp path), summary) pair;
    the default is both of the kernel's paths. Warp path (nH 8, D 16, P 4;
    L 3 and L 1): a small map, Q not a multiple of the 8 queries a block
    holds, Q = 1, B = 6, and a wholly off-map query between two visible
    ones in one block (its output must be exactly 0). General path: the
    same shapes with an unaligned value table; D 5 and 8, nH 2 and 3, L 1,
    2 and 8, P 1 and 2. Every case also puts samples on the last pixel
    centre, at -0.5 px and far off the map. Each repeat launch must give
    the same bits."""
    g = torch.Generator(device="cuda").manual_seed(3)
    cases, summary = cases
    for b, q, nh, d, shapes, p, off_map, offset, warp in cases:
        value, locs, attn = k2_inputs(g, b, q, nh, d, shapes, p, off_map,
                                      offset)
        label = (f"K2 edge case B={b} Q={q} nH={nh} D={d} L={len(shapes)} "
                 f"P={p} off-map queries {off_map} value offset {offset}")
        check(warp_path(value, shapes, locs) == warp,
              f"{label}: expected the {'warp' if warp else 'general'} path")
        out, _, _, _ = k2_check(label, launch, plain, value, shapes, locs,
                                attn)
        for i in off_map:
            check(not out[:, i].any(), f"{label}: off-map query {i} is not 0")
    log(f"K2 edge cases ({summary}; samples on the last pixel centre, at "
        "-0.5 px and far off the map): agree with the plain version, and "
        "repeat launches give the same bits")


def unaligned_copy(value):
    """`value`'s numbers in storage that starts 4 bytes past a 16-byte
    boundary: the same function on the kernel's general path."""
    storage = torch.empty(value.numel() + 1, device=value.device,
                          dtype=value.dtype)
    out = storage[1:].view(value.shape)
    out.copy_(value)
    return out


def k2_touched_rows(value, shapes, locs):
    """The in-bounds corners of these locations and the distinct (camera,
    pixel, head) value rows they touch."""
    b, len_v, nh, _ = value.shape
    cam = torch.arange(b, device=value.device).view(b, 1, 1, 1)
    head = torch.arange(nh, device=value.device).view(1, 1, nh, 1)
    keys, start = [], 0
    for lid, (h, w) in enumerate(shapes):
        x0 = torch.floor(locs[:, :, :, lid, :, 0] * w - 0.5)
        y0 = torch.floor(locs[:, :, :, lid, :, 1] * h - 0.5)
        for cx in (x0, x0 + 1):
            for cy in (y0, y0 + 1):
                inb = (cx >= 0) & (cx < w) & (cy >= 0) & (cy < h)
                pix = start + (cy.clamp(0, h - 1) * w
                               + cx.clamp(0, w - 1)).long()
                keys.append(((cam * len_v + pix) * nh + head)[inb])
        start += h * w
    keys = torch.cat(keys)
    return keys.numel(), int(torch.unique(keys).numel())


def k2_fwd_bound(value, shapes, locs, attn, out):
    """K2 forward's bound: the locations, weights and output once and the
    value rows the in-bounds corners touch once (beside it, the whole value
    table), FLOP at the f32 peak. -> dict of the bound, the table bound,
    both times, corners, touched rows, bytes and FLOP."""
    b, _, nh, d = value.shape
    q, nl, npnt = locs.shape[1], locs.shape[3], locs.shape[4]
    corners, touched = k2_touched_rows(value, shapes, locs)
    samples = b * q * nh * nl * npnt
    flops = float(K2_FLOP_PER_SAMPLE * samples + 2 * d * corners)
    side = 4.0 * (locs.numel() + attn.numel() + out.numel())
    nbytes = side + 4.0 * touched * d
    table_bytes = side + 4.0 * value.numel()
    t_ops, t_bytes = flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(bound_ms=1e3 * max(t_ops, t_bytes),
                table_bound_ms=1e3 * max(t_ops, table_bytes / HBM_BYTES_PER_S),
                t_ops=t_ops, t_bytes=t_bytes, corners=corners,
                touched_rows=touched, samples=samples, nbytes=nbytes,
                table_bytes=table_bytes, flops=flops)


def capture_k2(model, cfg, inputs, infer_fn=None):
    """Every K2 launch of one `infer_fn` (default `entry.infer_fused`) of
    `inputs`: the wrapper's (value, shapes, locations, weights), cloned,
    and whether the kernel takes its warp path on the tensors the path
    passed (asked before the clone, which is always aligned)."""
    from df3d_torch.entry import infer_fused
    from df3d_torch.ops import msda_kernel as K2

    infer_fn = infer_fn or infer_fused
    captured = []
    launch = K2.msda_cuda

    def recording(value, shapes, locs, attn):
        captured.append((value.clone(), tuple(shapes), locs.clone(),
                         attn.clone(), K2.warp_path(value, shapes, locs)))
        return launch(value, shapes, locs, attn)

    K2.msda_cuda = recording
    try:
        infer_fn(model, cfg, *inputs)
    finally:
        K2.msda_cuda = launch
    torch.cuda.synchronize()
    return captured


def phase_k2(model, cfg, inputs, infer_fn, per_frame, edge_cases=True,
             warp=True, k1_per_frame=K1_PER_FRAME):
    """Capture every K2 launch of one fused frame (`infer_fn`; `per_frame`
    of them, and K1's `k1_per_frame` counted), each on the warp path (or,
    with `warp` False, on the general path); with `edge_cases`, K2's edge
    cases; hold each K2 output against the plain version and time it, the
    plain version and the general path on the same inputs."""
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1

    K1.launches = 0
    captured = capture_k2(model, cfg, inputs, infer_fn)
    launch = K2.msda_cuda
    check(len(captured) == per_frame,
          f"expected {per_frame} K2 launches per fused frame, saw "
          f"{len(captured)}")
    check(K1.launches == k1_per_frame,
          f"expected {k1_per_frame} K1 launches per fused frame, saw "
          f"{K1.launches}")
    for i, (*_, on_warp) in enumerate(captured):
        check(on_warp == warp,
              f"K2 launch {i}: the main path's tensors took the "
              f"{'warp' if on_warp else 'general'} path")

    if edge_cases:
        k2_edge_cases(launch, K2.msda_plain, K2.warp_path)
    rows, max_err = [], 0.0
    log("K2 per launch (tolerance: max|kernel - plain| <= 1e-4*max|plain| "
        "+ 1e-5; a repeat launch equals the first bit for bit). kernel = "
        "stream time of back-to-back wrapper calls, device = the same calls "
        "queued behind a spin (CUDA events), general = device time of the "
        "same launch on the general path; bound = locations and weights "
        "read and the output written once, and the value rows that in-bounds "
        "corners touch read once; table bound = the same with the whole "
        "value table:")
    for i, (value, shapes, locs, attn, _) in enumerate(captured):
        b, len_v, nh, _ = value.shape
        out, _, err, tol = k2_check(f"K2 launch {i}", launch, K2.msda_plain,
                                    value, shapes, locs, attn)
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: launch(value, shapes, locs, attn), 20)
        dev_ms = device_ms(lambda: launch(value, shapes, locs, attn), 20)
        plain_ms = cuda_ms(lambda: K2.msda_plain(value, shapes, locs, attn),
                           5)
        general = unaligned_copy(value)
        check(not K2.warp_path(general, shapes, locs),
              f"K2 launch {i}: the unaligned copy took the warp path")
        k2_check(f"K2 launch {i} on the general path", launch, K2.msda_plain,
                 general, shapes, locs, attn)
        general_ms = device_ms(lambda: launch(general, shapes, locs, attn),
                               20)
        del general
        # the in-bounds corners this frame's locations need, and the rows
        fb = k2_fwd_bound(value, shapes, locs, attn, out)
        corners, touched, samples = (fb["corners"], fb["touched_rows"],
                                     fb["samples"])
        nbytes, table_bytes = fb["nbytes"], fb["table_bytes"]
        flops = fb["flops"]
        t_ops, t_bytes = fb["t_ops"], fb["t_bytes"]
        bound_ms, table_ms = fb["bound_ms"], fb["table_bound_ms"]
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        rows.append(dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         general_ms=general_ms, bound_ms=bound_ms,
                         table_bound_ms=table_ms, touched_rows=touched,
                         t_ops=t_ops, t_bytes=t_bytes))
        log(f"  #{i}: value {tuple(value.shape)}, locations "
            f"{tuple(locs.shape)}, levels {list(shapes)}; in-bounds corners "
            f"{corners} of {4 * samples} ({corners / (4 * samples):.3f}); "
            f"touched rows {touched} of {b * len_v * nh} "
            f"({touched / (b * len_v * nh):.3f}); {nbytes / 1e6:.1f} MB "
            f"({table_bytes / 1e6:.1f} MB with the whole table), "
            f"{flops / 1e9:.3f} GFLOP; kernel {ms:.4f} ms, device "
            f"{dev_ms:.4f} ms, general {general_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
            f"table bound {table_ms:.5f} ms; max abs err {err:.3g} "
            f"(tol {tol:.3g})")
    total = {key: sum(r[key] for r in rows) for key in rows[0]}
    return dict(
        name="msda_sampling", route="cuda", source="df3d_torch/csrc/msda.cu",
        replaces="df3d/ops/pallas/msda_kernel.py:31",
        max_abs_err=max_err, ms=total["ms"], plain_ms=total["plain_ms"],
        bound_ms=total["bound_ms"],
        bound_by=("operations" if total["t_ops"] >= total["t_bytes"]
                  else "bytes"),
        library_ms=None, device_ms=total["device_ms"],
        table_bound_ms=total["table_bound_ms"],
        general_ms=total["general_ms"],
        touched_rows=total["touched_rows"])


def phase_fused_main_path(label, model, cfg, fcfg, frames, dev, infer_fn,
                          n_boxes, k2_per_frame):
    """`timed_path` of a camera+LiDAR path (`infer_fn`), then the share of
    the stride-8 voxels each camera sees."""
    from df3d_torch.models.fusion.hooks import MultiCamACTRFusionHook
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1

    inputs = [fused_inputs(f, fcfg.num_cams, fcfg.image_shape, dev, 10 + i)
              for i, f in enumerate(frames)]
    launches = timed_path(
        label, lambda *a: infer_fn(model, cfg, *a), n_boxes, inputs,
        FUSED_TIMED_FRAMES, {K1: K1_PER_FRAME, K2: k2_per_frame})

    # which stage-4 voxels each camera sees (ACTR's query mask)
    seen = []
    hook = next(m for m in model.modules()
                if isinstance(m, MultiCamACTRFusionHook))
    handle = hook.actr.register_forward_hook(
        lambda mod, inp, out: seen.append(inp[4]))
    infer_fn(model, cfg, *inputs[0])
    handle.remove()
    mask = seen[0].view(fcfg.num_cams, -1)
    log(f"{label} queries: {mask.shape[1]} stage-4 rows per camera, "
        f"{fcfg.num_cams * mask.shape[1]} in all; share each camera sees "
        f"(of the rows): {[round(v, 4) for v in mask.float().mean(1).tolist()]}"
        f"; rows seen by any camera {int(mask.any(0).sum())}")
    return launches


def small_transfusion_config():
    """TransFusion-L on `entry.small_cfg()`'s grid, at the preset's head
    widths (10 classes, 200 proposals, hidden 128, 8 heads) on its 16x16
    BEV map."""
    from df3d_torch.entry import small_cfg, transfusion_l_nusc

    c = small_cfg()
    base = transfusion_l_nusc()
    head = dataclasses.replace(
        base.head, bev_size=(c.grid_size[1] // 8, c.grid_size[2] // 8),
        voxel_size=c.voxel_size[:2], pc_range=c.pc_range[:2])
    return dataclasses.replace(
        base, pc_range=c.pc_range, voxel_size=c.voxel_size,
        grid_size=c.grid_size, max_voxels=c.max_voxels,
        stage_caps=c.stage_caps, head=head)


def phase_small_transfusion(dev):
    from df3d_torch.entry import (
        build_transfusion, infer_transfusion, random_points,
    )

    cfg = small_transfusion_config()
    pts = torch.from_numpy(random_points(np.random.RandomState(2), 1, 2000))
    valid = torch.ones(pts.shape[:2], dtype=torch.bool)
    transfusion_card_vs_cpu(
        "small TransFusion-L input",
        lambda d: build_transfusion(cfg, d, seed=0), cfg, [pts, valid],
        infer_transfusion, dev)


def phase_small_transfusion_fused(dev):
    from df3d_torch.entry import (
        build_transfusion3ddf, fused_config, infer_transfusion_fused,
        random_points, transfusion_3ddf_nusc,
    )

    cfg = small_transfusion_config()
    preset = transfusion_3ddf_nusc()
    fcfg = fused_config(preset, image_shape=(64, 112),
                        image_layers=(1, 1, 1, 1), num_cams=2,
                        actr=dataclasses.replace(preset["actr"],
                                                 lt_npoint=64))
    frame = random_points(np.random.RandomState(3), 1, 2000)[0]
    transfusion_card_vs_cpu(
        "small TransFusion + 3D-DF input",
        lambda d: build_transfusion3ddf(cfg, fcfg, d, seed=0), cfg,
        list(fused_inputs(frame, fcfg.num_cams, fcfg.image_shape, "cpu", 0)),
        infer_transfusion_fused, dev)


def full_transfusion_configs():
    """(TransFusion-L, its FusedConfig) of the `transfusion_3ddf_nusc`
    preset at the stage caps above (bench.py's for this model)."""
    from df3d_torch.entry import fused_config, transfusion_3ddf_nusc

    preset = transfusion_3ddf_nusc()
    cfg = dataclasses.replace(preset["lidar"],
                              max_voxels=REALISTIC_STAGE_CAPS[0],
                              stage_caps=REALISTIC_STAGE_CAPS)
    return cfg, fused_config(preset)


def scene_boxes(seed):
    """The object boxes (x, y, z, dx, dy, dz, yaw, vx, vy) of the scene that
    `make_raycast_frame(RandomState(seed))` casts (it draws its scene
    first): 52 cars, 9 trucks, 18 pedestrians, as nuScenes classes 0, 1
    and 8."""
    from df3d_torch.utils.synth import _scene

    c, dims, yaw, vel = _scene(np.random.RandomState(seed))
    n = len(SCENE_CLASSES)
    return np.concatenate([c[:n], dims[:n], yaw[:n, None], vel[:n]],
                          -1).astype(np.float32)


def train_batch(points, boxes, classes, dev):
    """The training step's batch on `dev` from numpy points (B, P, F),
    boxes (B, M, 9) and global classes (B, M), every box valid."""
    b, m = classes.shape
    return {"points": torch.from_numpy(points).to(dev),
            "points_valid": torch.ones(points.shape[:2], dtype=torch.bool,
                                       device=dev),
            "gt_boxes": torch.from_numpy(boxes).to(dev),
            "gt_classes": torch.from_numpy(classes).to(dev),
            "gt_valid": torch.ones(b, m, dtype=torch.bool, device=dev)}


def phase_small_train(dev):
    """One training step on the card against the same step on the CPU: the
    multichip dry-run's config at batch 2, its gt layout (four equal boxes
    of class 0 per sample), 4096 points per sample over the grid, the same
    seeded weights. Twice on the card: first with cuDNN off and the sparse
    convs' plain version, which round as the CPU does, so the rest of the
    step on the card is held tight; then as the path runs, with K1 and
    cuDNN.

    Tolerances, both runs: loss and per-task losses rtol 1e-4, cap
    overflow equal, batch statistics after the step 1e-4 * max|cpu| + 1e-6.
    First run: every gradient leaf 1e-4 * max|cpu| + 1e-5; updated
    parameters 1e-4 * max|cpu| + 1e-6 plus lr * |u(g + t) - u(g - t)|,
    where Adam's first step u(g) = g / (|g| + eps) jumps by 2 at g = 0 (t
    the gradient's tolerance, clipped as g is). Second run: every gradient
    leaf ||card - cpu|| <= 5e-2 ||cpu|| + 1e-5 sqrt(n) (L2 over the leaf)
    and updated parameters as in the first run, with t the measured L2 gap
    between the leaf's clipped gradients on the card and on the CPU (it
    bounds every element's gap). At random weights the step's gradients
    jump with the last bits of the forward pass (in
    tests/test_torch_train_step.py's `test_dry_run_spread`, one ulp more on
    every point's intensity moves the JAX step's own gradient leaves by up
    to 2.9e-2 of their max), and K1's 3xTF32 (operands split into two TF32
    halves, ~22 bits) and cuDNN's f32 algorithms each round apart from the
    CPU's f32. Phase 15 holds every K1 launch of the backward at phase 4's
    tolerance."""
    from df3d_torch.entry import build_centerpoint_trainer, mesh_cfg
    from df3d_torch.ops import sparse as S
    from df3d_torch.ops import sparse_conv_kernel as K

    cfg = mesh_cfg()
    batch, _ = small_train_arrays(2)

    def run(d):
        state, step = build_centerpoint_trainer(cfg, d, seed=0)
        logs, grads = step.grads(state, train_batch(*batch, d))
        grads = [g.cpu() for g in grads]
        state = step.apply(state, [g.to(d) for g in grads])
        names = [n for n, _ in state.model.named_parameters()]
        return (to_cpu(logs), dict(zip(names, grads)),
                to_cpu(state.model.state_dict()), float(state.tx.lr(0)))

    cpu = run("cpu")
    body = S._conv_body
    S._conv_body = lambda f, idx, w, dx=False: K.sparse_conv_plain(f, idx, w)
    torch.backends.cudnn.enabled = False
    try:
        card_plain = run(dev)
    finally:
        S._conv_body = body
        torch.backends.cudnn.enabled = True
    compare_train_step("small train step, plain sparse convs, no cuDNN",
                       cpu, card_plain, strict=True)
    compare_train_step("small train step, K1 and cuDNN", cpu, run(dev),
                       strict=False)


def compare_train_step(label, ref, got, strict):
    """Hold one step's (logs, gradients, state dict) against the
    reference's, with `phase_small_train`'s tolerances for its first run
    (`strict`) or its second, and print how far the gradient leaves are
    from it."""
    from df3d_torch.train.schedules import global_norm

    (c_logs, c_grads, c_sd, lr0), (g_logs, g_grads, g_sd, _) = ref, got
    check(int(c_logs["cap_overflow"]) == int(g_logs["cap_overflow"]),
          f"{label}: cap overflow differs")
    for k, v in c_logs.items():
        check(bool(torch.isfinite(g_logs[k]).all()), f"{label}: {k}")
        torch.testing.assert_close(g_logs[k].double(), v.double(), rtol=1e-4,
                                   atol=0)
    clip = min(1.0, 10.0 / float(global_norm(list(c_grads.values()))))
    g_clip = min(1.0, 10.0 / float(global_norm(list(g_grads.values()))))

    def adam_first(x):  # Adam's first update direction for a gradient x
        return x / (x.abs() + 1e-8)

    rel, l2, over = [], [], []
    for name, c in c_grads.items():
        g, scale = g_grads[name], c.abs().max().item()
        err = (g - c).abs().max().item()
        rel.append((err / max(scale, 1e-30), name))
        l2_err, l2_ref = (g - c).norm().item(), c.norm().item()
        l2.append(l2_err / max(l2_ref, 1e-30))
        ref_p, cg = c_sd[name], c * clip
        if strict:
            tol = 1e-4 * scale + 1e-5
            bad = err > tol
            t = tol * clip
        else:
            tol = 5e-2 * l2_ref + 1e-5 * c.numel() ** 0.5
            bad = l2_err > tol
            t = (g * g_clip - cg).norm().item()
        atol = (1e-4 * ref_p.abs().max() + 1e-6
                + lr0 * (adam_first(cg + t) - adam_first(cg - t)).abs())
        if bad:
            over.append(f"gradient {name} off by {err} (L2 {l2_err}), "
                        f"tolerance {tol}")
        if not bool(((g_sd[name] - ref_p).abs() <= atol).all()):
            over.append(f"updated {name}")
    for k, r in c_sd.items():
        if k.endswith(("running_mean", "running_var")):
            tol = 1e-4 * r.abs().max().item() + 1e-6
            err = (g_sd[k] - r).abs().max().item()
            if err > tol:
                over.append(f"{k} off by {err} > {tol}")
    rel.sort(reverse=True)
    log(f"{label}: over the gradient leaves, max|card - CPU| / max|CPU| "
        f"median {np.median([r for r, _ in rel]):.3g}, largest "
        + ", ".join(f"{n} {r:.3g}" for r, n in rel[:3])
        + f" (a bias ahead of a BatchNorm has a gradient of rounding noise);"
        f" L2 relative median {np.median(l2):.3g}, largest {max(l2):.3g}")
    check(not over, f"{label}: " + "; ".join(over[:10]))
    log(f"{label}: agree with the CPU: loss {g_logs['loss'].item():.6f} (CPU "
        f"{c_logs['loss'].item():.6f}), cap overflow "
        f"{int(c_logs['cap_overflow'])}, {len(c_grads)} gradient leaves, "
        "updated parameters and batch statistics")


@functools.lru_cache(maxsize=None)
def training_frame(seed):
    """`utils.synth.make_raycast_frame(RandomState(seed), NUM_POINTS)`,
    cast once a run (~10 s a frame on the host) for the five phases that
    train on it."""
    from df3d_torch.utils.synth import make_raycast_frame

    return make_raycast_frame(np.random.RandomState(seed), NUM_POINTS)


def full_train_batch(dev):
    """Four ray-cast frames (seeds 0-3, 260k points) with each scene's 79
    object boxes, as a training batch on `dev`."""
    seeds = range(TRAIN_BATCH)
    points = np.stack([training_frame(s) for s in seeds])
    boxes = np.stack([scene_boxes(s) for s in seeds])
    classes = np.tile(np.asarray(SCENE_CLASSES, np.int64), (TRAIN_BATCH, 1))
    return train_batch(points, boxes, classes, dev)


def full_train_setup(dev, transfusion=False):
    """CenterPoint at the `centerpoint_nusc` preset's full width and caps
    (or TransFusion-L at `transfusion_l_nusc`'s), its trainer from seed 0,
    and `full_train_batch`."""
    from df3d_torch.entry import (
        build_centerpoint_trainer, build_transfusion_trainer,
        transfusion_l_nusc,
    )
    from df3d_torch.models.detectors.centerpoint import CenterPointConfig

    if transfusion:
        cfg = transfusion_l_nusc()
        state, step = build_transfusion_trainer(cfg, dev, seed=0)
    else:
        cfg = CenterPointConfig()
        state, step = build_centerpoint_trainer(cfg, dev, seed=0)
    return cfg, state, step, full_train_batch(dev)


def k1_launch_times(launch, f, idx, w):
    """One K1 launch's back-to-back and device time, the plain version's
    time and the bound (3 x FLOP as TF32, or the bytes: each input read and
    the output written once)."""
    from df3d_torch.ops import sparse_conv_kernel as K

    b, n_in, cin = f.shape
    k, _, cout = w.shape
    n_out = idx.shape[1] // k
    ms = cuda_ms(lambda: launch(f, idx, w), 10)
    dev_ms = device_ms(lambda: launch(f, idx, w), 10)
    plain_ms = cuda_ms(lambda: K.sparse_conv_plain(f, idx, w), 3)
    pairs = k1_work(idx, n_in, k)["pairs"]
    flops = 2.0 * pairs * cin * cout
    nbytes = 4.0 * (idx.numel() + f.numel() + w.numel() + b * n_out * cout)
    t_ops, t_bytes = 3 * flops / TF32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
    return dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                bound_ms=1e3 * max(t_ops, t_bytes), t_ops=t_ops,
                t_bytes=t_bytes, pairs=pairs)


def phase_train_k1(state, step, batch, per_step=K1_PER_FRAME,
                   bwd_per_step=K1_BWD_PER_STEP, step_args=(),
                   time_forward=False):
    """Every K1 launch of one full-width backward (the input gradients)
    against the plain version and a repeat launch (phase 4's tolerance, bit
    for bit); each sparse conv's input gradient on the card against torch
    autograd of `sparse_conv_plain` (a scatter through index_select's
    backward: it checks the flipped weights and the transposed plans), and
    each conv's dW time; the step's `per_step` forward launches are held
    the same way first (and, with `time_forward`, timed with their bound).
    `step.grads(state, batch, *step_args)` runs the step; it must launch
    K1 `bwd_per_step` times in its backward. Returns K1's numbers for the
    kernels line."""
    from df3d_torch.ops import sparse as S
    from df3d_torch.ops import sparse_conv_kernel as K

    records, captured, forward = [], [], []
    backward, launch = S._SparseConv.backward, K.sparse_conv_cuda_dx
    fwd_launch = K.sparse_conv_cuda

    def recording_backward(ctx, dy):
        features, weights = ctx.saved_tensors
        records.append((features, weights, ctx.plan, dy.clone(),
                        ctx.needs_input_grad[0]))
        return backward(ctx, dy)

    def recording_launch(features, gather_idx, weights):
        captured.append((features.clone(), gather_idx.clone(),
                         weights.clone()))
        return launch(features, gather_idx, weights)

    def recording_forward(features, gather_idx, weights):
        forward.append((features.clone(), gather_idx.clone(),
                        weights.clone()))
        return fwd_launch(features, gather_idx, weights)

    S._SparseConv.backward = staticmethod(recording_backward)
    K.sparse_conv_cuda_dx = recording_launch
    K.sparse_conv_cuda = recording_forward
    try:
        step.grads(state, batch, *step_args)
    finally:
        S._SparseConv.backward = backward
        K.sparse_conv_cuda_dx = launch
        K.sparse_conv_cuda = fwd_launch
    torch.cuda.synchronize()
    records.reverse()  # forward order: conv_input first
    check(len(forward) == per_step,
          f"expected {per_step} K1 launches in the forward, saw "
          f"{len(forward)}")
    check(len(records) == per_step,
          f"expected {per_step} sparse conv backwards, saw {len(records)}")
    check(len(captured) == bwd_per_step,
          f"expected {bwd_per_step} K1 launches in the backward, saw "
          f"{len(captured)}")
    fwd_err, fwd_rows = 0.0, []
    for i, (f, idx, w) in enumerate(forward):
        _, _, err = k1_check(f"forward launch {i}", fwd_launch,
                             K.sparse_conv_plain, f, idx, w)
        fwd_err = max(fwd_err, err)
        if time_forward:
            fwd_rows.append(k1_launch_times(fwd_launch, f, idx, w))
    log(f"K1 in the forward of the step: {len(forward)} launches agree with "
        f"the plain version (max abs err {fwd_err:.3g}), repeat launches "
        "give the same bits")
    fwd = {}
    if fwd_rows:
        ft = {key: sum(r[key] for r in fwd_rows) for key in fwd_rows[0]}
        fwd = dict(fwd_ms=ft["ms"], fwd_device_ms=ft["device_ms"],
                   fwd_plain_ms=ft["plain_ms"], fwd_bound_ms=ft["bound_ms"],
                   fwd_bound_by=("operations" if ft["t_ops"] >= ft["t_bytes"]
                                 else "bytes"))
        log(f"K1 forward per step: {len(fwd_rows)} launches, kernel "
            f"{ft['ms']:.4f} ms (device {ft['device_ms']:.4f} ms), plain "
            f"{ft['plain_ms']:.4f} ms, bound {ft['bound_ms']:.5f} ms "
            f"({ft['pairs']} hit pairs)")
    del forward

    log("K1 in the backward (input gradients of one full-width step; "
        "tolerance of phase 4, repeat launches bit for bit; bound as in "
        "phase 4):")
    log("  #  Cin  Cout N_in     N_out    hit_pairs  kernel_ms  device_ms "
        "plain_ms  bound_ms  bound_by   max_abs_err")
    rows, max_err = [], 0.0
    for i, (f, idx, w) in enumerate(captured):
        _, n_in, cin = f.shape
        k, _, cout = w.shape
        n_out = idx.shape[1] // k
        _, _, err = k1_check(f"backward launch {i}", launch,
                             K.sparse_conv_plain, f, idx, w)
        max_err = max(max_err, err)
        r = k1_launch_times(launch, f, idx, w)
        rows.append(r)
        bound_by = "operations" if r["t_ops"] >= r["t_bytes"] else "bytes"
        log(f"  {i:<2d} {cin:<4d} {cout:<4d} {n_in:<8d} {n_out:<8d} "
            f"{r['pairs']:<10d} {r['ms']:<10.4f} {r['device_ms']:<9.4f} "
            f"{r['plain_ms']:<9.4f} {r['bound_ms']:<9.5f} {bound_by:<10} "
            f"{err:.3g}")
    total = {key: sum(r[key] for r in rows) for key in rows[0]}

    log("sparse conv input gradient, card (K1) vs autograd of the plain "
        "version, and dW (re-gather + one product over all rows) per conv:")
    dw_total, dx_worst = 0.0, 0.0
    for i, (f, w, plan, dy, needs_dx) in enumerate(records):
        n_in, cin, cout = f.shape[1], w.shape[1], w.shape[2]
        kind = "subm" if plan.symmetric else "strided"
        dw_ms = cuda_ms(lambda: S.weight_grad(f, plan.gather_idx, dy), 5)
        dw_total += dw_ms
        line = (f"  conv {i:<2d} {kind:<7} {cin:>3d}->{cout:<3d} N_in {n_in}:"
                f" dW {dw_ms:.4f} ms")
        if needs_dx:
            x = f.detach().clone().requires_grad_(True)
            S.apply_sparse_conv(x, plan, w.detach()).backward(dy)
            ref = f.detach().clone().requires_grad_(True)
            K.sparse_conv_plain(ref, plan.gather_idx, w.detach()).backward(dy)
            err = (x.grad - ref.grad).abs().max().item()
            tol = 1e-4 * ref.grad.abs().max().item() + 1e-5
            check(err <= tol, f"conv {i}: dx off by {err} > {tol}")
            dx_worst = max(dx_worst, err)
            line += f"; dx max abs err {err:.3g} (tol {tol:.3g})"
        log(line)
    log(f"K1 backward per step: {len(rows)} launches, kernel "
        f"{total['ms']:.4f} ms (device {total['device_ms']:.4f} ms), plain "
        f"{total['plain_ms']:.4f} ms, bound {total['bound_ms']:.5f} ms; dW "
        f"{dw_total:.4f} ms over {len(records)} convs; worst dx error "
        f"{dx_worst:.3g}")
    return dict(bwd_ms=total["ms"], bwd_device_ms=total["device_ms"],
                bwd_plain_ms=total["plain_ms"], bwd_bound_ms=total["bound_ms"],
                bwd_bound_by=("operations" if total["t_ops"] >= total["t_bytes"]
                              else "bytes"),
                bwd_max_abs_err=max(max_err, fwd_err), dw_ms=dw_total, **fwd)


def phase_train_path(state, step, batch, label="train path", step_args=(),
                     k1_counts=(K1_PER_FRAME, K1_BWD_PER_STEP),
                     caps_drop=False):
    """The trainer entry point at full width: warm-up steps, then timed
    steps, `step(state, batch, *step_args)`, with K1's counts set to 0 just
    before and read just after (`k1_counts`: 16 forward and 15 backward
    launches a step on the nuScenes paths, 12 and 11 on KITTI's); every
    loss finite, the loss falling below the first step's within 5 steps on
    this fixed batch, no cap overflow (unless `caps_drop`: KITTI's caps drop
    rows by design, ROADMAP section 3, and the count is printed), and a
    TransFusion step's queries matched to at least one box each step.
    Prints ms/step, a host-clock split of one step (a TransFusion step's
    with its `assign` stage, Voxel R-CNN's with its two stages), peak
    memory and a one-step profile."""
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1
    from df3d_torch.utils import stages

    losses = []

    def one_step():
        nonlocal state
        state, logs = step(state, batch, *step_args)
        losses.append(logs["loss"].item())
        check(caps_drop or int(logs["cap_overflow"]) == 0,
              f"{label} step {len(losses)}: cap overflow "
              f"{int(logs['cap_overflow'])}")
        check(int(logs.get("tf_matched", 1)) >= 1,
              f"{label} step {len(losses)}: no query matched a box")
        return logs

    for _ in range(TRAIN_WARMUP_STEPS):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K1.launches = K1.bwd_launches = K2.launches = K2.bwd_launches = 0
    per_step = []
    for _ in range(TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        one_step()
        torch.cuda.synchronize()
        per_step.append(1e3 * (time.perf_counter() - t0))
    fwd, bwd, k2 = K1.launches, K1.bwd_launches, K2.launches
    peak = torch.cuda.max_memory_allocated()
    check(fwd == k1_counts[0] * TRAIN_TIMED_STEPS,
          f"{label}: K1 forward launched {fwd} times in "
          f"{TRAIN_TIMED_STEPS} steps, expected {k1_counts[0]} a step")
    check(bwd == k1_counts[1] * TRAIN_TIMED_STEPS,
          f"{label}: K1 backward launched {bwd} times in "
          f"{TRAIN_TIMED_STEPS} steps, expected {k1_counts[1]} a step")
    check(k2 == 0 and K2.bwd_launches == 0,
          f"{label}: K2 launched {k2} + {K2.bwd_launches} times")
    with stages.recording() as split:
        logs = one_step()
    profile_frame(one_step)
    check(all(np.isfinite(losses)), f"{label}: losses {losses}")
    check(min(losses[1:5]) < losses[0],
          f"{label}: the loss did not fall below {losses[0]} in 5 steps")
    forward = sum(split.get(k, 0.0) for k in ("backbone_3d", "neck", "head",
                                              "rpn", "roi_head"))
    log(f"{label}: batch {batch['points'].shape[0]}, {TRAIN_TIMED_STEPS} "
        "timed steps "
        f"after {TRAIN_WARMUP_STEPS}, ms/step mean {np.mean(per_step):.3f} "
        f"median {np.median(per_step):.3f} min {np.min(per_step):.3f}; per "
        f"step {[round(x, 3) for x in per_step]}")
    log(f"{label}: K1 launches per step {fwd // TRAIN_TIMED_STEPS} forward"
        f", {bwd // TRAIN_TIMED_STEPS} backward; peak memory "
        f"{peak / 2**30:.3f} GiB")
    log(f"{label} step split (ms, host clock, synchronised): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; forward (backbone_3d, neck, head or rpn, roi_head) "
        f"{forward:.3f}")
    log(f"{label} losses by step: {[round(x, 5) for x in losses]}; last "
        "step: " + ", ".join(f"{k} {float(v):.4f}" for k, v in logs.items()))
    return {"train_fwd": fwd, "train_bwd": bwd}


@contextlib.contextmanager
def relu_decisions(masks, replay):
    """Patch `torch.relu` (every ReLU of the port's models): record each
    call's decisions (x > 0) in `masks`, in call order; or, with `replay`,
    give each call the recorded decision where its own disagrees, the
    value there taking the recorded sign at its own magnitude and the
    gradient passed through unchanged. Yields the replayed disagreements,
    (elements, largest |x|) per call that had any."""
    relu, flips = torch.relu, []
    recorded = iter(masks)

    def patched(x):
        z = x.detach()
        if not replay:
            masks.append((z > 0).cpu())
            return relu(x)
        want = next(recorded).to(x.device)
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


def small_fused_train_configs():
    """tests/test_torch_fused_slice.py's config: the multichip dry-run's
    LiDAR config, 2 cameras of 32x48, DeepLabV3 taps on one-block ResNet
    stages, a tiny ACTRv2 (d_model 16, 2 heads, 2 levels, 2 points, LT of 8
    centres)."""
    from df3d_torch.entry import mesh_cfg
    from df3d_torch.models.detectors.fused import FusedConfig
    from df3d_torch.models.fusion.actr import ACTRConfig

    actr = ACTRConfig(d_model=16, n_heads=2, n_points=2, n_levels=2,
                      num_layers=1, dim_feedforward=32, lt_npoint=8,
                      lt_nsample=4, model_name="ACTRv2", q_method="gating",
                      attn_layer="BiGateSum1D_2")
    return mesh_cfg(), FusedConfig(
        image_shape=(32, 48), image_branch="deeplabv3",
        image_layers=(1, 1, 1, 1), n_levels=2, num_cams=2, actr=actr,
        use_ifat=True, fusion_downsample=8)


def fused_train_batch(points, boxes, classes, images, proj, dev):
    """`train_batch` plus the cameras: images (B, n_cam, H, W, 3) and proj
    (B, n_cam, 3, 4), numpy, on `dev`."""
    batch = train_batch(points, boxes, classes, dev)
    batch["images"] = torch.from_numpy(images).to(dev)
    batch["proj"] = torch.from_numpy(proj).to(dev)
    return batch


@contextlib.contextmanager
def transfusion_decisions(store, replay):
    """Patch TransFusion's head: record the queries' top-k indices and the
    Hungarian matches of each call in `store`, in call order; or, with
    `replay`, give each call the recorded indices or matches where its own
    differ. A replay is a near tie on this device: the top-k scores, or
    the batch's summed assignment costs, of the two choices lie within
    `gap` of each other (the caller bounds it). Yields the replays,
    (kind, entries that differ, gap) per call that had any."""
    from df3d_torch.models.heads import transfusion_head as H

    top_k, match, replays = H.top_k_stable, H.hungarian_match, []
    recorded = iter(store)

    def recording_top_k(x, k):
        vals, idx = top_k(x, k)
        if not replay:
            store.append(idx.cpu())
            return vals, idx
        want = next(recorded).to(idx.device)
        if torch.equal(want, idx):
            return vals, idx
        chosen = x.gather(1, want)
        replays.append(("top-k", int((want != idx).sum()),
                        float((chosen - vals).abs().max())))
        return chosen, want

    def recording_match(cost, valid):
        got = match(cost, valid)
        if not replay:
            store.append(got.cpu())
            return got
        want = next(recorded).to(got.device)
        if torch.equal(want, got):
            return got

        def total(m):
            c = cost.gather(2, m.clamp_min(0)[..., None])[..., 0]
            return (c * (m >= 0)).sum()
        replays.append(("assignment", int((want != got).sum()),
                        float((total(want) - total(got)).abs())))
        return want

    H.top_k_stable, H.hungarian_match = recording_top_k, recording_match
    try:
        yield replays
    finally:
        H.top_k_stable, H.hungarian_match = top_k, match


@contextlib.contextmanager
def centerpoint_decisions(store, replay):
    """Patch CenterPoint's decoding: record each call's pre-NMS top-k
    indices and rotated-NMS outputs in `store`, in call order; or, with
    `replay`, give each call the recorded ones where its own differ, as
    `transfusion_decisions` does for the top-k (the card's scores at the
    recorded indices) and `voxelrcnn_decisions` for the NMS (`_nms_gap`).
    Yields the replays, (kind, entries that differ, gap) per call that had
    any."""
    from df3d_torch.models.heads import center_head as H

    top_k, nms, replays = H.top_k_stable, H.nms_bev, []
    recorded = iter(store)

    def recording_top_k(x, k):
        vals, idx = top_k(x, k)
        if not replay:
            store.append(idx.cpu())
            return vals, idx
        want = next(recorded).to(idx.device)
        if torch.equal(want, idx):
            return vals, idx
        chosen = x.gather(-1, want)
        replays.append(("top-k", int((want != idx).sum()),
                        float((chosen - vals).abs().max())))
        return chosen, want

    def recording_nms(boxes, scores, thresh, pre_max_size, post_max_size,
                      valid=None):
        got = nms(boxes, scores, thresh, pre_max_size, post_max_size, valid)
        if not replay:
            store.append(tuple(t.cpu() for t in got))
            return got
        want = tuple(t.to(got[0].device) for t in next(recorded))
        if all(torch.equal(a, b) for a, b in zip(got, want)):
            return got
        replays.append(("nms", int(sum((a != b).sum() for a, b in
                                       zip(got, want))),
                        _nms_gap((boxes, scores, thresh, pre_max_size),
                                 want)))
        return want

    H.top_k_stable, H.nms_bev = recording_top_k, recording_nms
    try:
        yield replays
    finally:
        H.top_k_stable, H.nms_bev = top_k, nms


def small_step_card_vs_cpu(label, build_trainer, batch, dev, k2_per_step,
                           decisions=None, grads_kwargs=None,
                           k1_counts=(K1_PER_FRAME, K1_BWD_PER_STEP)):
    """One training step of `build_trainer(device) -> (state, step)` on the
    card against the same step on the CPU, on `batch(device)` (and
    `grads_kwargs`, CPU tensors, moved to the device: Voxel R-CNN's RoI
    sampler noise), as phase 14:
    first with cuDNN off and the plain versions of K1 and K2 (forward and
    backward, still through their autograd Functions), held tight; then as
    the path runs, with K1, K2 (`k2_per_step` forward and as many backward
    launches) and cuDNN, held by L2; tolerances of `phase_small_train`. A
    fused model's frozen image branch stays unchanged on both.

    Decisions: the forwards on the card and on the CPU agree to ~1e-5 of
    the values, and a ReLU input that close to 0 passes the gradient on
    one device and not on the other, moving every leaf upstream by up to a
    few percent (tests/test_torch_fused_train_step.py met two such
    elements in the neck against JAX, |x| <= 4.1e-6); two near-equal
    heatmap scores can swap in TransFusion's top-k, and two near-equal
    assignments in its Hungarian step. So the CPU step records every
    ReLU's decisions, the queries and the matches, and each card step
    replays them where its own differ (`relu_decisions`,
    `transfusion_decisions`): at most 4 ReLU inputs, each within 1e-4 of
    0, as in the CPU tests, and at most 4 query slots or matches, each a
    tie within 1e-4 (of the scores, or of the summed costs) on the card;
    their counts are printed. With no replay the card's queries and matches
    equal the CPU's as integers. `decisions` (default
    `transfusion_decisions`) records and replays the path's decisions;
    K1 must launch `k1_counts` times forward and backward."""
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse as S
    from df3d_torch.ops import sparse_conv_kernel as K

    masks, picks = [], []
    decisions = decisions or transfusion_decisions

    def run(d, replay):
        state, step = build_trainer(d)
        branch = getattr(getattr(state.model, "rpn", state.model),
                         "image_branch", None)
        frozen = {} if branch is None else {
            k: v.clone() for k, v in branch.state_dict().items()}
        kwargs = {k: v.to(d) for k, v in (grads_kwargs or {}).items()}
        with relu_decisions(masks, replay) as flips, \
                decisions(picks, replay) as replays:
            logs, grads = step.grads(state, batch(d), **kwargs)
        grads = [g.cpu() for g in grads]
        state = step.apply(state, [g.to(d) for g in grads])
        for k, v in frozen.items():
            check(torch.equal(branch.state_dict()[k], v),
                  f"{label} on {d}: the frozen image branch moved ({k})")
        check(sum(n for n, _ in flips) <= 4
              and all(z < 1e-4 for _, z in flips),
              f"{label} on {d}: more than 4 ReLU inputs disagree with the "
              f"CPU's, or one lies more than 1e-4 from 0: {flips}")
        check(sum(n for _, n, _ in replays) <= 4
              and all(gap < 1e-4 for *_, gap in replays),
              f"{label} on {d}: more than 4 queries or matches differ from "
              f"the CPU's, or one is no tie within 1e-4: {replays}")
        log(f"{label} on {d}: {sum(n for n, _ in flips)} ReLU decisions "
            f"taken from the CPU's (largest |x| "
            f"{max([z for _, z in flips], default=0.0):.3g}); decision "
            f"replays {replays}")
        return (to_cpu(logs), dict(zip(state.param_names, grads)),
                to_cpu(state.model.state_dict()), float(state.tx.lr(0)))

    cpu = run("cpu", replay=False)
    body, fwd, bwd = S._conv_body, K2.msda_cuda, K2.msda_bwd_cuda
    S._conv_body = lambda f, idx, w, dx=False: K.sparse_conv_plain(f, idx, w)
    K2.msda_cuda, K2.msda_bwd_cuda = K2.msda_plain, K2.msda_bwd_plain
    torch.backends.cudnn.enabled = False
    try:
        card_plain = run(dev, replay=True)
    finally:
        S._conv_body, K2.msda_cuda, K2.msda_bwd_cuda = body, fwd, bwd
        torch.backends.cudnn.enabled = True
    compare_train_step(f"{label}, plain K1 and K2, no cuDNN", cpu,
                       card_plain, strict=True)
    K.launches = K.bwd_launches = K2.launches = K2.bwd_launches = 0
    card = run(dev, replay=True)
    check(K.launches == k1_counts[0] and K.bwd_launches == k1_counts[1]
          and K2.launches == k2_per_step and K2.bwd_launches == k2_per_step,
          f"{label}: K1 launched {K.launches} forward and {K.bwd_launches} "
          f"backward, K2 {K2.launches} and {K2.bwd_launches}, expected "
          f"{k1_counts[0]}, {k1_counts[1]}, {k2_per_step} and "
          f"{k2_per_step}")
    compare_train_step(f"{label}, K1, K2 and cuDNN", cpu, card, strict=False)


def small_train_arrays(b, points_f=5, n=4096):
    """Phase 14's batch as numpy: `n` points per sample over the +-16 m
    grid, the multichip dry run's gt layout (four equal boxes of class 0)."""
    rng = np.random.RandomState(0)
    points = np.concatenate([rng.uniform(-15, 15, (b, n, 2)),
                             rng.uniform(-1.8, 1.8, (b, n, 1)),
                             rng.uniform(0, 1, (b, n, points_f - 3))], -1)
    box = np.array([1.0, 2.0, 0.0, 4.0, 2.0, 1.5, 0.3, 0.0, 0.0], np.float32)
    return (points.astype(np.float32), np.tile(box, (b, 4, 1)),
            np.zeros((b, 4), np.int64)), rng


def fused_batch_fn(arrays, rng, fcfg):
    """`fused_train_batch` on a device, with seeded normalized images and
    the rig of `utils.synth.camera_rig` for `fcfg`'s cameras."""
    from df3d_torch.utils.synth import camera_rig

    b, nc, hw = arrays[0].shape[0], fcfg.num_cams, fcfg.image_shape
    images = rng.randn(b, nc, *hw, 3).astype(np.float32)
    proj = np.broadcast_to(camera_rig(nc, hw), (b, nc, 3, 4)).copy()
    return lambda d: fused_train_batch(*arrays, images, proj, d)


def phase_small_fused_train(dev):
    """One CenterPoint + 3D-DF training step of
    `entry.build_centerpoint3ddf_trainer` on the card against the same step
    on the CPU (`small_step_card_vs_cpu`): `small_fused_train_configs()` at
    batch 2, phase 14's points and gt layout, seeded normalized images and
    the rig of `utils.synth.camera_rig`, the same seeded weights."""
    from df3d_torch.entry import build_centerpoint3ddf_trainer

    cfg, fcfg = small_fused_train_configs()
    arrays, rng = small_train_arrays(2)
    small_step_card_vs_cpu(
        "small fused train step",
        lambda d: build_centerpoint3ddf_trainer(cfg, fcfg, d, seed=0),
        fused_batch_fn(arrays, rng, fcfg), dev, k2_per_step=1)


# four boxes a sample (gravity centre, 9-dof) of classes 0, 1, 2, 0, as
# tests/test_torch_transfusion_train_step.py has them
SMALL_TRANSFUSION_BOXES = np.array(
    [[1.0, 2.0, 0.0, 4.0, 2.0, 1.5, 0.3, 0.0, 0.0],
     [-6.0, -8.0, 0.2, 2.0, 1.0, 1.2, 1.0, 0.5, 0.0],
     [8.0, 5.0, -0.3, 1.0, 1.0, 1.8, -0.5, 0.0, 0.3],
     [3.0, -10.0, 0.0, 4.5, 2.0, 1.6, 2.0, 0.0, 0.0]], np.float32)


def small_transfusion_train_configs():
    """tests/test_torch_transfusion_slice.py's config: TransFusion-L on the
    +-16 m grid with a tiny head (3 classes, 16 proposals, hidden 32, 8 x 8
    BEV map), and its fused config (2 cameras of 64x112, ResNet + FPN on
    one-block stages, the `transfusion_3ddf_nusc` preset's ACTRv2 narrowed:
    one level, two layers, q_method "sum")."""
    from df3d_torch.models.detectors.fused import FusedConfig
    from df3d_torch.models.detectors.transfusion import TransFusionConfig
    from df3d_torch.models.fusion.actr import ACTRConfig
    from df3d_torch.models.heads.transfusion_head import TransFusionHeadCfg

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


def small_transfusion_train_arrays():
    """Phase 14's points with 4 features, and `SMALL_TRANSFUSION_BOXES` in
    each of the two samples (the second's moved by (1.5, -0.5) m)."""
    (points, _, _), rng = small_train_arrays(2, points_f=4)
    boxes = np.tile(SMALL_TRANSFUSION_BOXES[None], (2, 1, 1))
    boxes[1, :, :2] += (1.5, -0.5)
    classes = np.tile(np.int64([0, 1, 2, 0]), (2, 1))
    return (points, boxes, classes), rng


def phase_small_transfusion_train(dev):
    """One TransFusion-L training step of `entry.build_transfusion_trainer`
    on the card against the same step on the CPU
    (`small_step_card_vs_cpu`: queries and Hungarian matches equal as
    integers, or replayed near ties counted and bounded), on
    `small_transfusion_train_configs()` at batch 2."""
    from df3d_torch.entry import build_transfusion_trainer

    cfg, _ = small_transfusion_train_configs()
    arrays, _ = small_transfusion_train_arrays()
    small_step_card_vs_cpu(
        "small TransFusion-L train step",
        lambda d: build_transfusion_trainer(cfg, d, seed=0),
        lambda d: train_batch(*arrays, d), dev, k2_per_step=0)


def phase_small_transfusion_fused_train(dev):
    """One TransFusion + 3D-DF training step of
    `entry.build_transfusion3ddf_trainer` on the card against the same step
    on the CPU, as phase 20, with the cameras of phase 17 (seeded
    normalized images, the rig) and the frozen ResNet + FPN branch."""
    from df3d_torch.entry import build_transfusion3ddf_trainer

    cfg, fcfg = small_transfusion_train_configs()
    arrays, rng = small_transfusion_train_arrays()
    small_step_card_vs_cpu(
        "small TransFusion + 3D-DF train step",
        lambda d: build_transfusion3ddf_trainer(cfg, fcfg, d, seed=0),
        fused_batch_fn(arrays, rng, fcfg), dev,
        k2_per_step=fcfg.actr.num_layers)


def full_fused_train_setup(dev, transfusion=False, with_batch=True):
    """CenterPoint + 3D-DF at the `centerpoint_3ddf_nusc` preset's full
    width with `CenterPointConfig()`'s training caps (or TransFusion +
    3D-DF at `transfusion_3ddf_nusc`'s with `TransFusionConfig()`'s), its
    trainer from seed 0, and (unless not `with_batch`: None)
    `full_train_batch` plus six random normalized 448x800 images per sample
    and the rig of `utils.synth.camera_rig`."""
    from df3d_torch.entry import (
        build_centerpoint3ddf_trainer, build_transfusion3ddf_trainer,
        centerpoint_3ddf_nusc, fused_config, transfusion_3ddf_nusc,
    )
    from df3d_torch.utils.synth import camera_rig

    preset = transfusion_3ddf_nusc() if transfusion else centerpoint_3ddf_nusc()
    build = (build_transfusion3ddf_trainer if transfusion
             else build_centerpoint3ddf_trainer)
    cfg, fcfg = preset["lidar"], fused_config(preset)
    state, step = build(cfg, fcfg, dev, seed=0)
    if not with_batch:
        return cfg, fcfg, state, step, None
    nc, hw = fcfg.num_cams, fcfg.image_shape
    batch = full_train_batch(dev)
    g = torch.Generator(device=dev).manual_seed(20)
    batch["images"] = torch.randn(TRAIN_BATCH, nc, *hw, 3, generator=g,
                                  device=dev)
    batch["proj"] = torch.from_numpy(np.broadcast_to(
        camera_rig(nc, hw), (TRAIN_BATCH, nc, 3, 4)).copy()).to(dev)
    return cfg, fcfg, state, step, batch


def k2_bwd_check(label, launch, plain, value, shapes, locs, attn, grad):
    """One K2 backward launch against autograd of the plain version, and a
    repeat launch: dloc and dattn must give the same bits, dvalue (f32
    atomics) agree within the tolerance. Returns (max abs err, worst err /
    tolerance) over the three gradients."""
    got = launch(value, shapes, locs, attn, grad)
    again = launch(value, shapes, locs, attn, grad)
    want = plain(value, shapes, locs, attn, grad)
    torch.cuda.synchronize()
    max_err, worst = 0.0, 0.0
    for name, g, a, w in zip(("dvalue", "dloc", "dattn"), got, again, want):
        err = (g - w).abs().max().item()
        tol = 1e-4 * w.abs().max().item() + 1e-5
        check(bool(torch.isfinite(g).all()), f"{label}: non-finite {name}")
        check(err <= tol, f"{label}: {name} max abs err {err} > {tol}")
        rep = (a - g).abs().max().item()
        check(rep <= tol, f"{label}: a repeat launch's {name} is off by "
              f"{rep} > {tol}")
        max_err, worst = max(max_err, err), max(worst, err / tol)
    check(torch.equal(got[1], again[1]) and torch.equal(got[2], again[2]),
          f"{label}: a repeat launch's dloc or dattn differs")
    return max_err, worst


# (B, Q, nH, D, levels, P, value offset, warp path)
K2_BWD_EDGE_CASES = (
    [(2, 37, 8, 16, K2_LEVELS, 4, 0, True),
     (6, 20, 8, 16, K2_LEVELS, 4, 0, True),
     (2, 37, 8, 16, K2_LEVELS[:1], 4, 0, True),
     (2, 37, 8, 16, K2_LEVELS, 4, 1, False),
     (2, 10, 8, 8, K2_LEVELS, 4, 0, False),
     (2, 11, 2, 8, K2_LEVELS[:2], 4, 0, False),
     (3, 17, 3, 5, K2_LEVELS[:2], 2, 0, False),
     (2, 13, 2, 8, K2_LEVELS_8, 1, 0, False),
     (6, 20, 8, 16, K2_LEVELS[2:], 4, 0, True),
     (2, 37, 8, 16, K2_LEVELS[:1], 4, 1, False)],
    "warp path at L = 3 and L = 1, B = 2 and 6; general path: unaligned "
    "tables at L = 3 and 1, D 8 and 5, nH 2, 3 and 8, L 2 and 8, P 1, 2 "
    "and 4")
# KITTI's head shape on the general path (a Voxel R-CNN + 3D-DF step)
K2_KITTI_BWD_EDGE_CASES = (
    [(2, 37, 8, 8, K2_LEVELS, 4, 0, False),
     (2, 37, 8, 8, K2_LEVELS, 4, 1, False),
     (1, 1, 8, 8, K2_LEVELS, 4, 0, False),
     (2, 1000, 8, 8, K2_LEVELS, 4, 0, False),
     (2, 37, 8, 8, K2_LEVELS[:1], 4, 0, False)],
    "KITTI's nH 8, D 8 on the general path: L 3 and 1, Q 37, 1 and 1000, "
    "B 1 and 2, an unaligned table")


def k2_bwd_edge_cases(launch, plain, warp_path, cases=K2_BWD_EDGE_CASES):
    """K2's backward against autograd of its plain version on small inputs,
    `cases` a (list of (B, Q, nH, D, levels, P, value offset, warp path),
    summary) pair; the default is both paths: the warp path at L = 3 and L
    = 1 (nH 8, D 16, P 4; B 2 and 6), the general path with an unaligned
    value table (L 3 and 1) and at D = 8 (the KITTI ACTR's head width), nH
    2 and 3, L 2 and 8, P 1 and 2. Every case has
    samples on the last pixel centre, at -0.5 px and far off the map
    (`k2_inputs`), a query wholly off the map, every point of query 3 on
    an exact integer pixel position, zero weights on query 4, and a zero
    cotangent on query 5 (a masked query: its dloc and dattn must be 0)."""
    g = torch.Generator(device="cuda").manual_seed(4)
    cases, summary = cases
    for b, q, nh, d, shapes, p, offset, warp in cases:
        value, locs, attn = k2_inputs(g, b, q, nh, d, shapes, p, (q - 1,),
                                      offset)
        for lid, (h, w) in enumerate(shapes):
            kx = torch.randint(-1, w + 1, (b, nh, p), device="cuda",
                               generator=g)
            ky = torch.randint(-1, h + 1, (b, nh, p), device="cuda",
                               generator=g)
            locs[:, 3 % q, :, lid, :, 0] = (kx + 0.5) / w
            locs[:, 3 % q, :, lid, :, 1] = (ky + 0.5) / h
        attn[:, 4 % q] = 0.0
        grad = torch.randn(b, q, nh * d, device="cuda", generator=g)
        grad[:, 5 % q] = 0.0
        label = (f"K2 backward edge case B={b} Q={q} nH={nh} D={d} "
                 f"L={len(shapes)} P={p} value offset {offset}")
        check(warp_path(value, shapes, locs) == warp,
              f"{label}: expected the {'warp' if warp else 'general'} path")
        k2_bwd_check(label, launch, plain, value, shapes, locs, attn, grad)
        _, dloc, dattn = launch(value, shapes, locs, attn, grad)
        for i in (q - 1, 5 % q):
            check(not dloc[:, i].any() and not dattn[:, i].any(),
                  f"{label}: query {i} (off the map or g = 0) has a gradient")
    log(f"K2 backward edge cases ({summary}; samples on the last pixel "
        "centre, at -0.5 px, on exact integer pixel positions, far off the "
        "map, zero weights, a zero cotangent): agree with autograd of the "
        "plain version, repeat launches give the same dloc and dattn bits")


def phase_fused_train_k2(state, step, batch, per_step=1, warp=True,
                         step_args=(), edge_cases=None):
    """The K2 launches of one full-width fused training step (batch 4 x 6
    cameras = 24 value tables; `per_step` forward and `per_step` backward
    launches, one each per ACTR layer). Each forward launch's inputs
    captured, its output held against the plain version (`k2_check`:
    max|err| <= 1e-4 * max|ref| + 1e-5, bit for bit on a repeat launch) on
    the warp path, and timed beside the plain version. Each backward
    launch's inputs and incoming gradient captured, dvalue, dloc and dattn
    held against autograd of the plain version (max|err| <= 1e-4 *
    max|ref| + 1e-5 per gradient; dloc and dattn bit for bit on a repeat
    launch), the edge cases (at L = 1 and 3 on the warp path), and per
    launch the back-to-back and device time, the plain version's time and
    the bound: g read and dvalue, dloc and dattn written once, and for the
    queries with g != 0 (for the others every gradient is 0, whatever
    their other inputs) their locations and weights and the value rows
    their in-bounds corners touch read once; each forward launch's bound
    as in phase 7. With `warp` False every launch must take the general
    path (KITTI's 64 channels); `edge_cases` replaces
    `k2_bwd_edge_cases`'s cases; `step.grads(state, batch, *step_args)`
    runs the step. Returns K2's numbers for the kernels line, summed over
    the step's launches."""
    from df3d_torch.ops import msda_kernel as K2

    captured, launch = [], K2.msda_bwd_cuda
    fwd_captured, fwd_launch = [], K2.msda_cuda

    def recording_forward(value, shapes, locs, attn):
        fwd_captured.append((value.clone(), tuple(shapes), locs.clone(),
                             attn.clone(), K2.warp_path(value, shapes, locs)))
        return fwd_launch(value, shapes, locs, attn)

    def recording(value, shapes, locs, attn, grad):
        captured.append((value.clone(), tuple(shapes), locs.clone(),
                         attn.clone(), grad.clone(),
                         K2.warp_path(value, shapes, locs)))
        return launch(value, shapes, locs, attn, grad)

    K2.msda_cuda, K2.msda_bwd_cuda = recording_forward, recording
    try:
        logs, _ = step.grads(state, batch, *step_args)
    finally:
        K2.msda_cuda, K2.msda_bwd_cuda = fwd_launch, launch
    torch.cuda.synchronize()
    check(len(fwd_captured) == per_step,
          f"expected {per_step} K2 forward launches a fused step, saw "
          f"{len(fwd_captured)}")
    check(len(captured) == per_step,
          f"expected {per_step} K2 backward launches a fused step, saw "
          f"{len(captured)}")
    path = "warp" if warp else "general"
    fwd = dict(fwd_ms=0.0, fwd_device_ms=0.0, fwd_plain_ms=0.0,
               fwd_bound_ms=0.0, fwd_table_bound_ms=0.0, fwd_max_abs_err=0.0)
    for i, (value, shapes, locs, attn, on_warp) in enumerate(fwd_captured):
        label = f"K2 forward launch {i} of the full-width step"
        check(on_warp == warp, f"{label} missed the {path} path")
        out, _, err, tol = k2_check(label, fwd_launch, K2.msda_plain, value,
                                    shapes, locs, attn)
        ms = cuda_ms(lambda: fwd_launch(value, shapes, locs, attn), 10)
        dev_ms = device_ms(lambda: fwd_launch(value, shapes, locs, attn), 10)
        plain_ms = cuda_ms(lambda: K2.msda_plain(value, shapes, locs, attn),
                           2)
        fb = k2_fwd_bound(value, shapes, locs, attn, out)
        fwd["fwd_ms"] += ms
        fwd["fwd_device_ms"] += dev_ms
        fwd["fwd_plain_ms"] += plain_ms
        fwd["fwd_bound_ms"] += fb["bound_ms"]
        fwd["fwd_table_bound_ms"] += fb["table_bound_ms"]
        fwd["fwd_max_abs_err"] = max(fwd["fwd_max_abs_err"], err)
        log(f"{label}: value {tuple(value.shape)}, locations "
            f"{tuple(locs.shape)}, levels {list(shapes)}; touched rows "
            f"{fb['touched_rows']} of {int(np.prod(value.shape[:3]))}; "
            f"kernel {ms:.4f} ms, device {dev_ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, bound "
            f"{fb['bound_ms']:.5f} ms (whole table {fb['table_bound_ms']:.5f}"
            f" ms); max abs err {err:.3g} (tolerance {tol:.3g})")
    del fwd_captured
    k2_bwd_edge_cases(launch, K2.msda_bwd_plain, K2.warp_path,
                      *(() if edge_cases is None else (edge_cases,)))
    rows, max_err = [], 0.0
    for i, (value, shapes, locs, attn, grad, on_warp) in enumerate(captured):
        label = f"K2 backward launch {i} of the full-width step"
        check(on_warp == warp, f"{label} missed the {path} path")
        err, worst = k2_bwd_check(label, launch, K2.msda_bwd_plain, value,
                                  shapes, locs, attn, grad)
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: launch(value, shapes, locs, attn, grad), 10)
        dev_ms = device_ms(lambda: launch(value, shapes, locs, attn, grad),
                           10)
        plain_ms = cuda_ms(lambda: K2.msda_bwd_plain(value, shapes, locs,
                                                     attn, grad), 2)
        b, len_v, nh, d = value.shape
        q, nl, npnt = locs.shape[1], locs.shape[3], locs.shape[4]
        live = grad.abs().amax(-1) > 0                       # (B, Q)
        live_locs = torch.where(live[:, :, None, None, None, None], locs,
                                torch.full_like(locs, -1e6))
        corners, touched = k2_touched_rows(value, shapes, live_locs)
        samples = b * q * nh * nl * npnt
        flops = float(K2_BWD_FLOP_PER_SAMPLE * samples + 4 * d * corners)
        n_live = int(live.sum())
        nbytes = 4.0 * (grad.numel() + value.numel() + locs.numel()
                        + attn.numel()
                        + (locs[live].numel() + attn[live].numel())
                        + touched * d)
        t_ops, t_bytes = flops / FP32_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        bound_ms = 1e3 * max(t_ops, t_bytes)
        bound_by = "operations" if t_ops >= t_bytes else "bytes"
        rows.append(dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, t_ops=t_ops, t_bytes=t_bytes))
        log(f"{label}: value {tuple(value.shape)}, locations "
            f"{tuple(locs.shape)}, levels {list(shapes)}; queries with g != "
            f"0 {n_live} of {b * q}; their in-bounds corners {corners}, "
            f"touched rows {touched} of {b * len_v * nh}; "
            f"{nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} GFLOP; kernel "
            f"{ms:.4f} ms, device {dev_ms:.4f} ms, plain {plain_ms:.4f} ms, "
            f"bound {bound_ms:.5f} ms ({bound_by}); max abs err {err:.3g} "
            f"(worst err / tolerance {worst:.3g})")
    total = {key: sum(r[key] for r in rows) for key in rows[0]}
    log(f"K2 forward per step: {per_step} launches, kernel "
        f"{fwd['fwd_ms']:.4f} ms (device {fwd['fwd_device_ms']:.4f} ms), "
        f"plain {fwd['fwd_plain_ms']:.4f} ms, bound "
        f"{fwd['fwd_bound_ms']:.5f} ms (whole table "
        f"{fwd['fwd_table_bound_ms']:.5f} ms)")
    log(f"K2 backward per step: {len(rows)} launches, kernel "
        f"{total['ms']:.4f} ms (device {total['device_ms']:.4f} ms), plain "
        f"{total['plain_ms']:.4f} ms, bound {total['bound_ms']:.5f} ms; step "
        f"loss {logs['loss'].item():.4f}")
    return dict(**fwd, bwd_replaces="df3d/ops/pallas/msda_kernel.py:132",
                bwd_ms=total["ms"], bwd_device_ms=total["device_ms"],
                bwd_plain_ms=total["plain_ms"], bwd_bound_ms=total["bound_ms"],
                bwd_bound_by=("operations" if total["t_ops"] >= total["t_bytes"]
                              else "bytes"),
                bwd_library_ms=None, bwd_max_abs_err=max_err)


def phase_fused_train_path(state, step, batch, fcfg, k2_per_step=1,
                           label="fused train path", step_args=(),
                           k1_counts=(K1_PER_FRAME, K1_BWD_PER_STEP),
                           caps_drop=False):
    """A fused trainer's step (`entry.build_centerpoint3ddf_trainer`,
    `build_transfusion3ddf_trainer` or `build_voxelrcnn3ddf_trainer`,
    `step(state, batch, *step_args)`) at full width on that fixed batch:
    warm-up steps, then timed steps with every kernel's counts set to 0
    just before and read just after (K1 `k1_counts` forward and backward
    launches a step, K2 `k2_per_step` forward and backward, one per ACTR
    layer); every loss finite and falling below the first step's within 5
    steps; a TransFusion step's queries matched to at least one box; no
    row dropped by a cap (the down2/3/4 overflows 0: the logged
    `cap_overflow` also counts the dense tail's rows summed over the batch
    against the per-sample cap, as the JAX package does), unless
    `caps_drop` (KITTI's caps drop rows by design; the counts are
    printed); the frozen image branch unchanged. Prints ms/step, the
    host-clock split of one step, peak memory and a one-step profile."""
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1
    from df3d_torch.utils import stages

    losses, overflows = [], []
    first = getattr(state.model, "rpn", state.model)  # Voxel R-CNN: stage 1
    image_branch = first.image_branch
    branch = {k: v.clone() for k, v in image_branch.state_dict().items()}
    detector = first.detector
    backbone = getattr(detector, "backbone", None) or detector.middle_encoder
    handle = backbone.register_forward_hook(
        lambda mod, inp, out: overflows.append(
            {k: v.detach().cpu() for k, v in out[2].items()}))

    def one_step():
        nonlocal state
        state, logs = step(state, batch, *step_args)
        losses.append(logs["loss"].item())
        dropped = {k: int(v.sum()) for k, v in overflows[-1].items()
                   if k != "cap_overflow_dense_tail"}
        check(caps_drop or not any(dropped.values()),
              f"{label} step {len(losses)}: a cap dropped rows {dropped}")
        check(int(logs.get("tf_matched", 1)) >= 1,
              f"{label} step {len(losses)}: no query matched a box")
        return logs

    for _ in range(TRAIN_WARMUP_STEPS):
        one_step()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K1.launches = K1.bwd_launches = K2.launches = K2.bwd_launches = 0
    per_step = []
    for _ in range(TRAIN_TIMED_STEPS):
        t0 = time.perf_counter()
        logs = one_step()
        torch.cuda.synchronize()
        per_step.append(1e3 * (time.perf_counter() - t0))
    counts = dict(k1_fwd=K1.launches, k1_bwd=K1.bwd_launches,
                  k2_fwd=K2.launches, k2_bwd=K2.bwd_launches)
    peak = torch.cuda.max_memory_allocated()
    for name, want in (("k1_fwd", k1_counts[0]), ("k1_bwd", k1_counts[1]),
                       ("k2_fwd", k2_per_step), ("k2_bwd", k2_per_step)):
        check(counts[name] == want * TRAIN_TIMED_STEPS,
              f"{label}: {name} launched {counts[name]} times in "
              f"{TRAIN_TIMED_STEPS} steps, expected {want} a step")
    with stages.recording() as split:
        one_step()
    profile_frame(one_step)
    handle.remove()
    check(all(np.isfinite(losses)), f"{label}: losses {losses}")
    check(min(losses[1:5]) < losses[0],
          f"{label}: the loss did not fall below {losses[0]} in 5 steps")
    for k, v in image_branch.state_dict().items():
        check(torch.equal(v, branch[k]),
              f"{label}: the frozen image branch moved ({k})")
    forward = sum(split.get(k, 0.0) for k in (
        "image_branch", "backbone_3d", "mvx", "ifat", "lt", "msda_actr",
        "backbone_3d_tail", "neck", "head", "rpn", "roi_head"))
    drops = {k: int(v.sum()) for k, v in overflows[-1].items()}
    log(f"{label}: batch {batch['points'].shape[0]} x {fcfg.num_cams} "
        "cameras, "
        f"{TRAIN_TIMED_STEPS} timed steps after {TRAIN_WARMUP_STEPS}, ms/step "
        f"mean {np.mean(per_step):.3f} median {np.median(per_step):.3f} min "
        f"{np.min(per_step):.3f}; per step "
        f"{[round(x, 3) for x in per_step]}")
    log(f"{label}: launches per step K1 "
        f"{counts['k1_fwd'] // TRAIN_TIMED_STEPS} forward, "
        f"{counts['k1_bwd'] // TRAIN_TIMED_STEPS} backward; K2 "
        f"{counts['k2_fwd'] // TRAIN_TIMED_STEPS} forward, "
        f"{counts['k2_bwd'] // TRAIN_TIMED_STEPS} backward; peak memory "
        f"{peak / 2**30:.3f} GiB")
    log(f"{label} step split (ms, host clock, synchronised): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f"; forward (image_branch .. head, or .. roi_head) {forward:.3f}")
    log(f"{label} losses by step: {[round(x, 5) for x in losses]}; "
        "last step: " + ", ".join(f"{k} {float(v):.4f}"
                                  for k, v in logs.items())
        + "; rows the caps dropped (the dense tail's: its batch-summed "
        "count over the per-sample cap): "
        + ", ".join(f"{k}={v}" for k, v in drops.items()))
    return counts


# KITTI (Voxel R-CNN, phases 24-28): K1 launches a frame (12 sparse convs,
# no dense tail) and K2 launches a fused frame (one ACTR layer)
K1_PER_KITTI_FRAME = 12
K2_PER_KITTI_FUSED_FRAME = 1
KITTI_IMAGE = (384, 1280)


def kitti_frames(n):
    """`n` single-sweep 64-beam frames cut to the front camera's view
    (`utils.synth.make_kitti_frame`, ~20k points each)."""
    from df3d_torch.utils.synth import make_kitti_frame

    return [make_kitti_frame(np.random.RandomState(100 + i))
            for i in range(n)]


def kitti_inputs(frame, image_shape, dev, seed, scale=1.0):
    """(points, valid, images, proj) on `dev` for one KITTI frame: the
    lidar frame, a random normalized (1, H, W, 3) image and the front
    camera (`utils.synth.kitti_camera`, pixels scaled by `scale`)."""
    from df3d_torch.utils.synth import kitti_camera

    g = torch.Generator(device=dev).manual_seed(seed)
    images = torch.randn(1, *image_shape, 3, generator=g, device=dev)
    proj = torch.from_numpy(kitti_camera(scale)[None]).to(dev)
    pts = torch.from_numpy(frame[None]).to(dev)
    valid = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    return pts, valid, images, proj


def _nms_gap(args, _want):
    """How near a tie the rotated NMS's decisions are on this device: the
    least |IoU - threshold| of two candidates and the least gap between
    two candidates' scores."""
    from df3d_torch.core.iou import iou_bev
    from df3d_torch.core.nms import top_k_stable

    boxes, scores, thresh, pre = args[:4]
    k = min(pre, boxes.shape[-2])
    vals, order = top_k_stable(scores, k)
    cand = boxes.gather(-2, order[..., None].expand(*order.shape, 7))
    mat = iou_bev(cand, cand)
    upper = torch.ones(k, k, dtype=torch.bool, device=mat.device).triu(1)
    gap_iou = (mat - thresh).abs()[..., upper].min()
    gap_score = (vals[..., :-1] - vals[..., 1:]).min()
    return float(torch.minimum(gap_iou, gap_score))


def _collect_gap(args, _want):
    """The least gap, per RoI, between its max_local-th and next nearest
    voxels' squared distances, or of one to the coarse radius squared."""
    from df3d_torch.ops.roi_ops import _sqdist

    centres, xyz, valid, coarse, k = args
    d2 = _sqdist(centres[:, :, None], xyz[:, None])
    d2 = torch.where(valid[:, None], d2, torch.full_like(d2, 1e10))
    s = torch.sort(d2, -1).values
    return float(torch.minimum((s[..., k] - s[..., k - 1]).min()
                               if s.shape[-1] > k else s.new_tensor(1e10),
                               (d2 - coarse * coarse).abs().min()))


def _ball_gap(args, _want):
    """The least |d^2 - radius^2| of a grid point and a local voxel."""
    from df3d_torch.ops.roi_ops import _sqdist

    grid, xyz, lidx, _, radius, _ = args
    b, r, l = lidx.shape
    local = xyz.gather(1, lidx.reshape(b, r * l, 1).expand(-1, -1, 3))
    d2 = _sqdist(grid[:, :, :, None], local.view(b, r, l, 3)[:, :, None])
    return float((d2 - radius * radius).abs().min())


@contextlib.contextmanager
def voxelrcnn_decisions(store, replay):
    """Patch Voxel R-CNN's decisions, the proposal and final NMS and the
    RoI head's two-stage neighbour search: record each call's integer
    outputs in `store`, in call order; or, with `replay`, give each call
    the recorded outputs where its own differ. A replay is a near tie on
    this device (`_nms_gap`, `_collect_gap`, `_ball_gap`: within 1e-4;
    the caller bounds it). Yields the replays, (kind, entries that differ,
    gap) per call that had any."""
    from df3d_torch.models.detectors import voxel_rcnn as V
    from df3d_torch.models.heads import voxelrcnn_head as H

    patched = [(V, "nms_bev", _nms_gap),
               (H, "collect_local_voxels", _collect_gap),
               (H, "grid_ball_query", _ball_gap)]
    originals = {(m, n): getattr(m, n) for m, n, _ in patched}
    recorded, replays = iter(store), []

    def wrap(fn, kind, gap):
        def decided(*args):
            got = fn(*args)
            if not replay:
                store.append(tuple(t.cpu() for t in got))
                return got
            want = tuple(t.to(got[0].device) for t in next(recorded))
            if all(torch.equal(a, b) for a, b in zip(got, want)):
                return got
            replays.append((kind, int(sum((a != b).sum() for a, b in
                                          zip(got, want))),
                            gap(args, want)))
            return want
        return decided

    for m, n, gap in patched:
        setattr(m, n, wrap(originals[m, n], n, gap))
    try:
        yield replays
    finally:
        for (m, n), fn in originals.items():
            setattr(m, n, fn)


def small_kitti_configs():
    """tests/test_torch_voxelrcnn_slice.py's tiny Voxel R-CNN (a 64x64
    grid, 16 RoIs, grid 4) and, for the fused path, the preset's ACTRv2
    (d_model 64, 8 heads, 3 levels, 4 points; LT at 64 centres) with a
    one-block DeepLabV3 on one 96x320 camera."""
    from df3d_torch.entry import fused_config, voxel_rcnn_3ddf_kitti
    from df3d_torch.models.detectors.voxel_rcnn import VoxelRCNNConfig
    from df3d_torch.models.heads.voxelrcnn_head import (
        RoIPoolScaleCfg, VoxelRCNNHeadCfg,
    )

    cfg = VoxelRCNNConfig(
        pc_range=(0.0, -16.0, -2.4, 32.0, 16.0, 2.4),
        voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64), max_voxels=512,
        stage_caps=(512, 384, 256, 128), test_pre_nms=128, test_post_nms=16,
        rcnn=VoxelRCNNHeadCfg(grid_size=4, max_local=64, scales=tuple(
            RoIPoolScaleCfg(k, ds, r, nsample=8) for k, ds, r in
            (("conv2", 2, 0.8), ("conv3", 4, 1.6), ("conv4", 8, 1.6)))))
    preset = voxel_rcnn_3ddf_kitti()
    fcfg = fused_config(preset, image_shape=(96, 320),
                        image_layers=(1, 1, 1, 1),
                        actr=dataclasses.replace(preset["actr"],
                                                 lt_npoint=64))
    return cfg, fcfg


def kitti_card_vs_cpu(label, build, cfg, inputs, infer_fn, dev):
    """A Voxel R-CNN path with its kernels on the card against the same
    path with the plain versions on the CPU: same weights
    (`build(device)` -> (rpn, head)) and inputs (CPU tensors: points,
    valid, then the fused path's images and proj). The card replays the
    CPU's NMS and neighbour decisions where its own differ, each a near
    tie within 1e-4, at most 4 calls (`voxelrcnn_decisions`). Voxel
    coords, cap overflows, roi_mask and valid equal; the RPN maps, RoIs,
    RCNN cls and reg, final boxes and scores to atol = rtol = 1e-3."""
    from df3d_torch.ops.voxelize import voxelize_batch

    store, out = [], []
    for d, replay in (("cpu", False), (dev, True)):
        rpn, head = build(d)
        args = [t.to(d) for t in inputs]
        with torch.no_grad(), voxelrcnn_decisions(store, replay) as replays:
            res = voxelize_batch(args[0], args[1], cfg.voxel_size,
                                 cfg.pc_range, cfg.grid_size, cfg.max_voxels,
                                 cfg.max_points_per_voxel)
            preds, _ = rpn(res.features, res.coords, *args[2:])
            det, overflow = infer_fn(rpn, head, cfg, *args)
            cls, reg = head(det["rois"], det["roi_mask"], preds["ms"])
        maps = {k: preds[k] for k in ("cls", "box", "dir")}
        out.append(to_cpu((res.coords, maps, det, overflow,
                           {"cls": cls, "reg": reg})))
    (c_coords, c_maps, c_det, c_ov, c_head), (g_coords, g_maps, g_det, g_ov,
                                              g_head) = out
    check(len(replays) <= 4 and all(g < 1e-4 for *_, g in replays),
          f"{label}: more than 4 decisions differ from the CPU's, or one is "
          f"no tie within 1e-4: {replays}")
    check(torch.equal(c_coords, g_coords), f"{label}: voxel coords differ")
    for k in c_ov:
        check(torch.equal(c_ov[k], g_ov[k]), f"{label}: {k} differs")
    for k in ("roi_mask", "valid", "labels"):
        check(torch.equal(c_det[k], g_det[k]), f"{label}: {k} differs")
    check(bool(c_det["valid"].any()), f"{label}: no detection kept")
    worst = 0.0
    for tree_c, tree_g in ((c_maps, g_maps), (c_head, g_head),
                           (c_det, g_det)):
        for k, t in tree_c.items():
            if not t.is_floating_point():
                continue
            check(torch.isfinite(tree_g[k]).all(), f"{label}: non-finite {k}")
            torch.testing.assert_close(tree_g[k], t, atol=1e-3, rtol=1e-3)
            worst = max(worst, (tree_g[k] - t).abs().max().item())
    log(f"{label}: card vs CPU plain path agree: {len(store)} NMS and "
        f"neighbour decisions recorded, replays {replays}; "
        f"{int(c_det['roi_mask'].sum())} RoIs and "
        f"{int(c_det['valid'].sum())} kept boxes equal; max diff of the RPN "
        f"maps, the RCNN head, boxes and scores {worst:.3g}; cap overflow "
        + ", ".join(f"{k}={int(v.sum())}" for k, v in c_ov.items()))


def phase_small_kitti(dev):
    """Both KITTI paths on a small input, card against CPU
    (`kitti_card_vs_cpu`): tests/test_torch_voxelrcnn_slice.py's points,
    and for the fused path a seeded normalized 96x320 image and the front
    camera scaled to it."""
    from df3d_torch.entry import (
        build_voxelrcnn, build_voxelrcnn3ddf, infer_voxelrcnn,
        infer_voxelrcnn_fused,
    )

    cfg, fcfg = small_kitti_configs()
    rng = np.random.RandomState(0)
    n = 1500
    pts = np.concatenate([rng.uniform(0, 31, (1, n, 1)),
                          rng.uniform(-15, 15, (1, n, 1)),
                          rng.uniform(-1.8, 1.8, (1, n, 1)),
                          rng.uniform(0, 1, (1, n, 1))], -1).astype(np.float32)
    kitti_card_vs_cpu(
        "small KITTI input", lambda d: build_voxelrcnn(cfg, d, seed=0), cfg,
        list(kitti_inputs(pts[0], fcfg.image_shape, "cpu", 0)[:2]),
        infer_voxelrcnn, dev)
    kitti_card_vs_cpu(
        "small KITTI fused input",
        lambda d: build_voxelrcnn3ddf(cfg, fcfg, d, seed=0), cfg,
        list(kitti_inputs(pts[0], fcfg.image_shape, "cpu", 0,
                          scale=fcfg.image_shape[1] / KITTI_IMAGE[1])),
        infer_voxelrcnn_fused, dev)


def kitti_rows(label, rpn, cfg, frames, dev):
    """Each frame's voxels against max_voxels and each stage's rows against
    its cap, with the rows a cap drops."""
    from df3d_torch.ops.voxelize import compute_voxel_coords, voxelize_batch

    zg, yg, xg = cfg.grid_size
    for i, f in enumerate(frames):
        pts = torch.from_numpy(f).to(dev)
        c = compute_voxel_coords(pts, cfg.voxel_size, cfg.pc_range).long()
        ok = ((c >= 0) & (c < torch.tensor([zg, yg, xg], device=dev))).all(1)
        voxels = int(torch.unique((c[ok, 0] * yg + c[ok, 1]) * xg
                                  + c[ok, 2]).numel())
        with torch.no_grad():
            res = voxelize_batch(pts[None], torch.ones(1, len(f), dtype=torch.bool,
                                                       device=dev),
                                 cfg.voxel_size, cfg.pc_range, cfg.grid_size,
                                 cfg.max_voxels, cfg.max_points_per_voxel)
            preds, overflow = rpn(res.features, res.coords)
        rows = {k: int(st.valid.sum()) for k, st in preds["ms"].items()}
        caps = dict(zip(("conv1", "conv2", "conv3", "conv4"),
                        cfg.stage_caps))
        drops = {k: int(v.sum()) for k, v in overflow.items()}
        log(f"{label} frame {i}: {len(f)} points, {voxels} voxels of "
            f"max_voxels {cfg.max_voxels} ({max(0, voxels - cfg.max_voxels)} "
            "dropped); rows per stage (cap): "
            + ", ".join(f"{k} {rows[k]} ({caps[k]})" for k in rows)
            + "; rows the caps drop: "
            + ", ".join(f"{k}={v}" for k, v in drops.items()))


def phase_kitti_paths(dev, frames):
    """Phases 25-28 at full KITTI width: `voxel_rcnn_car_kitti` (K1 per
    launch, then `infer_voxelrcnn` timed, K1 12 launches a frame, K2
    none), then `voxel_rcnn_3ddf_kitti` (one 384x1280 camera: K2's launch
    against the plain version on the general path with its nH 8, D 8 edge
    cases, then `infer_voxelrcnn_fused` timed, K1 12 and K2 1 launches a
    frame). Returns K1's and K2's entries and each path's launches."""
    from df3d_torch.entry import (
        build_voxelrcnn, build_voxelrcnn3ddf, fused_config,
        infer_voxelrcnn, infer_voxelrcnn_fused, voxel_rcnn_3ddf_kitti,
        voxel_rcnn_car_kitti,
    )
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1

    cfg = voxel_rcnn_car_kitti()
    rpn, head = build_voxelrcnn(cfg, dev, seed=0)
    kitti_rows("KITTI", rpn, cfg, frames, dev)
    lidar_fn = lambda m, c, p, v: infer_voxelrcnn(m, head, c, p, v)
    k1 = phase_k1(rpn, cfg, frames[0], dev, lidar_fn, edge_cases=False,
                  per_frame=K1_PER_KITTI_FRAME)
    inputs = [kitti_inputs(f, KITTI_IMAGE, dev, 10 + i)[:2]
              for i, f in enumerate(frames)]
    lidar = timed_path("KITTI Voxel R-CNN path",
                       lambda *a: lidar_fn(rpn, cfg, *a),
                       cfg.final_max_boxes, inputs, TIMED_FRAMES,
                       {K1: K1_PER_KITTI_FRAME, K2: 0}, box_dim=7)
    del rpn, head

    preset = voxel_rcnn_3ddf_kitti()
    fcfg = fused_config(preset)
    frpn, fhead = build_voxelrcnn3ddf(preset["lidar"], fcfg, dev, seed=0)
    fused_fn = lambda m, c, *a: infer_voxelrcnn_fused(m, fhead, c, *a)
    inputs = [kitti_inputs(f, KITTI_IMAGE, dev, 10 + i)
              for i, f in enumerate(frames)]
    k2_edge_cases(K2.msda_cuda, K2.msda_plain, K2.warp_path,
                  K2_KITTI_EDGE_CASES)
    k2 = phase_k2(frpn, cfg, inputs[0], fused_fn, K2_PER_KITTI_FUSED_FRAME,
                  edge_cases=False, warp=False,
                  k1_per_frame=K1_PER_KITTI_FRAME)
    fused = timed_path("KITTI Voxel R-CNN + 3D-DF path",
                       lambda *a: fused_fn(frpn, cfg, *a),
                       cfg.final_max_boxes, inputs, FUSED_TIMED_FRAMES,
                       {K1: K1_PER_KITTI_FRAME,
                        K2: K2_PER_KITTI_FUSED_FRAME}, box_dim=7)
    seen = []
    hook = frpn.detector.backbone.fusion_hook
    handle = hook.actr.register_forward_hook(
        lambda mod, inp, out: seen.append(inp[4]))
    with torch.no_grad():
        fused_fn(frpn, cfg, *inputs[0])
    handle.remove()
    mask = seen[0]
    log(f"KITTI Voxel R-CNN + 3D-DF queries: {mask.shape[1]} stage-4 rows, "
        f"the camera sees {int(mask.sum())} ({float(mask.float().mean()):.4f})")
    return k1, k2, lidar, fused


# KITTI training (phases 29-33): batch 2 (pcdet's voxel_rcnn_car.yaml
# BATCH_SIZE_PER_GPU); K1's input-gradient launches a step (every sparse
# conv but conv_input)
KITTI_TRAIN_BATCH = 2
K1_BWD_PER_KITTI_STEP = 11


@contextlib.contextmanager
def kitti_train_decisions(store, replay):
    """`voxelrcnn_decisions` (the proposal NMS and the RoI head's neighbour
    searches, near ties replayed) and the proposals themselves: the
    training step's proposals carry no gradient, so the second stage reads
    them as an input; with `replay` each call returns the recorded
    proposals, after its own roi_mask is checked equal to them and its
    RoIs and scores within 1e-4 * max + 1e-5 (the RoIs' coordinates reach
    70 m, and the card's rounding moves them by more than the tight
    tolerance of the second stage's gradients allows)."""
    from df3d_torch.train import trainer as T

    if not store:  # the searches' decisions, and the proposals
        store.extend([[], []])
    propose, recorded = T.proposal_layer, iter(store[1])

    def proposals(*args, **kwargs):
        got = propose(*args, **kwargs)
        if not replay:
            store[1].append(tuple(t.cpu() for t in got))
            return got
        want = tuple(t.to(got[0].device) for t in next(recorded))
        check(torch.equal(got[2], want[2]), "the card's roi_mask differs")
        for g, w in zip(got[:2], want[:2]):
            tol = 1e-4 * w.abs().max().item() + 1e-5
            err = (g - w).abs()
            at = np.unravel_index(int(err.argmax()), tuple(err.shape))
            check(err.max().item() <= tol,
                  "the card's proposals differ from the CPU's beyond "
                  f"{tol}: {err.max().item()} at {at}, {g[at[:2]].tolist()}"
                  f" against {w[at[:2]].tolist()}")
        return want

    with voxelrcnn_decisions(store[0], replay) as replays:
        T.proposal_layer = proposals
        try:
            yield replays
        finally:
            T.proposal_layer = propose


def small_kitti_train_configs():
    """tests/test_torch_voxelrcnn_train_step.py's config (tests/
    test_train_steps.py's Voxel R-CNN: one RoI scale at conv3, grid 3) and
    tests/test_torch_voxelrcnn_fused_train_step.py's (tests/
    test_fused_training.py's: conv2, grid 2; one 64x96 camera, DeepLabV3
    ResNet-50 taps at two levels, a tiny ACTRv2)."""
    from df3d_torch.models.detectors.fused import FusedConfig
    from df3d_torch.models.detectors.voxel_rcnn import VoxelRCNNConfig
    from df3d_torch.models.fusion.actr import ACTRConfig
    from df3d_torch.models.heads.voxelrcnn_head import (
        RoIPoolScaleCfg, VoxelRCNNHeadCfg,
    )

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
    fcfg = FusedConfig(image_shape=(64, 96), n_levels=2, actr=ACTRConfig(
        d_model=16, n_heads=2, n_points=2, n_levels=2, num_layers=1,
        dim_feedforward=32, lt_npoint=8, lt_nsample=4))
    return lidar, fused, fcfg


def gts_near_proposals(state, step, batch):
    """Three gt cars a sample near the proposals 0, 5 and 10 of a training
    forward of `state`'s model (a copy) on `batch` (CPU), moved by (0.2,
    -0.1, 0.05) m and turned by 0.1 rad, the second by pi more, and a
    padding slot, so that RoIs reach the regression threshold. -> (boxes,
    classes, valid), numpy."""
    import copy

    from df3d_torch.models.detectors.voxel_rcnn import proposal_layer

    probe = copy.deepcopy(state.model).train()
    with torch.no_grad():
        res = step.voxelize(batch)
        preds, _ = probe.rpn(res.features, res.coords,
                             *step.model_inputs(batch))
        rois = proposal_layer(step.cfg, preds, probe.anchors, train=True)[0]
    gts = rois[:, [0, 5, 10]].numpy() + np.float32(
        [0.2, -0.1, 0.05, 0.0, 0.0, 0.0, 0.1])
    gts[:, 1, 6] += np.pi
    b = gts.shape[0]
    boxes = np.concatenate([gts, np.zeros((b, 1, 7), np.float32)], 1)
    return (boxes.astype(np.float32), np.zeros((b, 4), np.int64),
            np.arange(4)[None].repeat(b, 0) < 3)


def flax_initial_attention(built):
    """`(state, step)` with the deformable attention's sampling-offset and
    attention-weight kernels at zero, as flax initialises them. The
    port's random weights draw them LeCun-normal (so that queries sample at
    different places), and on the small fused step the frozen random
    ResNet-50's taps (~350) then put the attention logits near 450: the
    softmax saturates, and the card's f32 rounding moves the fusion's
    gradient leaves past the tight tolerance (2.4x seen, plain K1 and K2
    without cuDNN), as the CPU tests against JAX saw (1.35x)."""
    from df3d_torch.models.fusion.msda_module import MSDeformAttnModule

    state, step = built
    with torch.no_grad():
        for m in state.model.modules():
            if isinstance(m, MSDeformAttnModule):
                m.sampling_offsets.weight.zero_()
                m.attention_weights.weight.zero_()
    return state, step


def phase_small_kitti_train(dev):
    """Both KITTI training steps (`entry.build_voxelrcnn_trainer`,
    `build_voxelrcnn3ddf_trainer`) on a small input, card against CPU
    (`small_step_card_vs_cpu`, `kitti_train_decisions`): the configs of
    the CPU tests at batch 2, 300 seeded points a sample, gts near the
    first stage's proposals, a seeded normalized 64x96 image and KITTI's
    camera scaled to it, the same RoI sampler noise on both devices; the
    fused step's attention kernels at flax's initial zeros
    (`flax_initial_attention`)."""
    from df3d_torch.entry import (
        build_voxelrcnn3ddf_trainer, build_voxelrcnn_trainer,
    )

    lidar, fused, fcfg = small_kitti_train_configs()
    noise = torch.rand(KITTI_TRAIN_BATCH, lidar.train_post_nms,
                       generator=torch.Generator().manual_seed(5)) * 1e-3
    for label, build, k2 in (
            ("small KITTI train step",
             lambda d: build_voxelrcnn_trainer(lidar, d, seed=0), 0),
            ("small KITTI fused train step",
             lambda d: flax_initial_attention(
                 build_voxelrcnn3ddf_trainer(fused, fcfg, d, seed=0)), 1)):
        state, step = build("cpu")
        cpu = small_kitti_train_batch(bool(k2), fcfg)
        boxes, classes, valid = gts_near_proposals(state, step, cpu)
        del state, step
        cpu.update(gt_boxes=torch.from_numpy(boxes),
                   gt_classes=torch.from_numpy(classes),
                   gt_valid=torch.from_numpy(valid))
        small_step_card_vs_cpu(
            label, build, lambda d, cpu=cpu: {k: v.to(d)
                                              for k, v in cpu.items()},
            dev, k2_per_step=k2, decisions=kitti_train_decisions,
            grads_kwargs={"noise": noise},
            k1_counts=(K1_PER_KITTI_FRAME, K1_BWD_PER_KITTI_STEP))


def kitti_train_batch(dev, fused):
    """`KITTI_TRAIN_BATCH` training samples of `utils.synth.make_kitti_sample`
    (seeds 100, 101: the frames of phase 25 with their scenes' cars in
    view) on `dev`, points padded to the longest; fused, with a random
    normalized 384x1280 image each and KITTI's front camera."""
    from df3d_torch.utils.synth import kitti_camera, make_kitti_sample

    samples = [make_kitti_sample(np.random.RandomState(100 + i))
               for i in range(KITTI_TRAIN_BATCH)]
    p = max(len(s[0]) for s in samples)
    points = np.zeros((KITTI_TRAIN_BATCH, p, 4), np.float32)
    valid = np.zeros((KITTI_TRAIN_BATCH, p), bool)
    for i, (pts, *_) in enumerate(samples):
        points[i, :len(pts)], valid[i, :len(pts)] = pts, True
    batch = {"points": points, "points_valid": valid,
             "gt_boxes": np.stack([s[1] for s in samples]),
             "gt_classes": np.stack([s[2] for s in samples]).astype(np.int64),
             "gt_valid": np.stack([s[3] for s in samples])}
    batch = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    if fused:
        g = torch.Generator(device=dev).manual_seed(20)
        batch["images"] = torch.randn(KITTI_TRAIN_BATCH, *KITTI_IMAGE, 3,
                                      generator=g, device=dev)
        batch["proj"] = torch.from_numpy(np.broadcast_to(
            kitti_camera(), (KITTI_TRAIN_BATCH, 3, 4)).copy()).to(dev)
    log(f"KITTI training batch: {[len(s[0]) for s in samples]} points, "
        f"{[int(s[3].sum()) for s in samples]} cars in view")
    return batch


def phase_kitti_train(dev):
    """Phases 30-33 at full KITTI width, batch 2: `voxel_rcnn_car_kitti`'s
    trainer (K1's 12 forward and 11 backward launches of one step against
    the plain version, timed with their bounds; then timed steps), then
    `voxel_rcnn_3ddf_kitti`'s (K2's forward and backward launch of one
    step on the general path against the plain version and its autograd,
    KITTI's backward edge cases, times and bounds; then timed steps). The
    RoI sampler's noise comes from a seeded generator on the card.
    Returns K1's and K2's entries and each path's launch counts."""
    from df3d_torch.entry import (
        build_voxelrcnn3ddf_trainer, build_voxelrcnn_trainer, fused_config,
        voxel_rcnn_3ddf_kitti, voxel_rcnn_car_kitti,
    )

    gen = torch.Generator(device=dev).manual_seed(7)
    counts = (K1_PER_KITTI_FRAME, K1_BWD_PER_KITTI_STEP)
    cfg = voxel_rcnn_car_kitti()
    state, step = build_voxelrcnn_trainer(cfg, dev, seed=0)
    batch = kitti_train_batch(dev, fused=False)
    k1 = phase_train_k1(state, step, batch, *counts, step_args=(gen,),
                        time_forward=True)
    lidar = phase_train_path(state, step, batch,
                             "KITTI Voxel R-CNN train path", (gen,), counts,
                             caps_drop=True)
    del state, step, batch
    torch.cuda.empty_cache()

    preset = voxel_rcnn_3ddf_kitti()
    fcfg = fused_config(preset)
    state, step = build_voxelrcnn3ddf_trainer(preset["lidar"], fcfg, dev,
                                              seed=0)
    batch = kitti_train_batch(dev, fused=True)
    k2 = phase_fused_train_k2(state, step, batch, per_step=1, warp=False,
                              step_args=(gen,),
                              edge_cases=K2_KITTI_BWD_EDGE_CASES)
    fused = phase_fused_train_path(
        state, step, batch, fcfg, 1, "KITTI Voxel R-CNN + 3D-DF train path",
        (gen,), counts, caps_drop=True)
    del state, step, batch
    torch.cuda.empty_cache()
    return k1, lidar, k2, fused


# Data-parallel training (phases 34-36): two ranks share the one card over
# gloo (NCCL refuses two ranks on one device); they exchange results with
# this process through CPU tensors saved under build/dp/
DP_WORLD = 2
DP_DIR = Path(__file__).resolve().parent / "build" / "dp"
DP_NOISE_SEED = 5
DP_TIMED_STEPS = 3
SMALL_DP_STEPS = ("CenterPoint", "CenterPoint + 3D-DF", "TransFusion-L",
                  "TransFusion + 3D-DF", "Voxel R-CNN", "Voxel R-CNN + 3D-DF")


def rank_rows(tree, rank, world):
    """A recorded decision store (nested lists, tuples and dicts of
    tensors) cut to one rank's rows: a tensor whose first dim the ranks
    divide gives rank `rank`'s rows, any other (an input without a batch
    dim, as TransFusion's positional embedding's) stays whole. A wrong cut
    shows as a shape error or as replays past their bounds."""
    if isinstance(tree, dict):
        return {k: rank_rows(v, rank, world) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(rank_rows(v, rank, world) for v in tree)
    if tree.dim() and tree.shape[0] > 1 and tree.shape[0] % world == 0:
        n = tree.shape[0] // world
        return tree[rank * n:(rank + 1) * n]
    return tree


def small_dp_case(name, dev):
    """One of `SMALL_DP_STEPS` at the config and on the batch of its small
    card-against-CPU phase (14, 17, 20, 22, 29), with the second sample's
    last two gt boxes (KITTI: its third) and its points past the 3000th
    (KITTI: the 200th, before the gts are placed near the proposals) made
    invalid, so that the samples differ in valid rows and positives:
    (state, step) on `dev`, the global batch on the CPU, the decisions to
    replay, and the step's arguments (Voxel R-CNN: a generator on `dev`
    for the RoI sampler's noise)."""
    from df3d_torch import entry

    decisions, args, kitti = transfusion_decisions, (), name.startswith("V")
    if name.startswith("CenterPoint"):
        arrays, rng = small_train_arrays(2)
    elif name.startswith("TransFusion"):
        arrays, rng = small_transfusion_train_arrays()
    if name == "CenterPoint":
        built = entry.build_centerpoint_trainer(entry.mesh_cfg(), dev,
                                                seed=0)
        batch = train_batch(*arrays, "cpu")
    elif name == "CenterPoint + 3D-DF":
        cfg, fcfg = small_fused_train_configs()
        built = entry.build_centerpoint3ddf_trainer(cfg, fcfg, dev, seed=0)
        batch = fused_batch_fn(arrays, rng, fcfg)("cpu")
    elif name == "TransFusion-L":
        cfg, _ = small_transfusion_train_configs()
        built = entry.build_transfusion_trainer(cfg, dev, seed=0)
        batch = train_batch(*arrays, "cpu")
    elif name == "TransFusion + 3D-DF":
        cfg, fcfg = small_transfusion_train_configs()
        built = entry.build_transfusion3ddf_trainer(cfg, fcfg, dev, seed=0)
        batch = fused_batch_fn(arrays, rng, fcfg)("cpu")
    else:
        lidar, fused, fcfg = small_kitti_train_configs()

        def build(d):
            if name == "Voxel R-CNN":
                return entry.build_voxelrcnn_trainer(lidar, d, seed=0)
            return flax_initial_attention(
                entry.build_voxelrcnn3ddf_trainer(fused, fcfg, d, seed=0))

        built, batch = build(dev), small_kitti_train_batch(name != "Voxel "
                                                           "R-CNN", fcfg)
        batch["points_valid"][1, 200:] = False
        state, step = build("cpu")
        boxes, classes, valid = gts_near_proposals(state, step, batch)
        batch.update(gt_boxes=torch.from_numpy(boxes),
                     gt_classes=torch.from_numpy(classes),
                     gt_valid=torch.from_numpy(valid))
        decisions = kitti_train_decisions
        args = (torch.Generator(device=dev).manual_seed(DP_NOISE_SEED),)
    if not kitti:
        batch["points_valid"][1, 3000:] = False
    batch["gt_valid"][1, 2 if kitti else -2:] = False
    return built, batch, decisions, args


def small_kitti_train_batch(fused, fcfg):
    """Phase 29's points (and, `fused`, its image and camera) as a CPU
    batch without gt boxes."""
    from df3d_torch.utils.synth import kitti_camera

    rng = np.random.RandomState(0)
    n, b = 300, KITTI_TRAIN_BATCH
    points = np.concatenate([rng.uniform(0, 31, (b, n, 1)),
                             rng.uniform(-15, 15, (b, n, 1)),
                             rng.uniform(-1.8, 1.8, (b, n, 1)),
                             rng.uniform(0, 1, (b, n, 1))], -1)
    batch = {"points": torch.from_numpy(points.astype(np.float32)),
             "points_valid": torch.ones(b, n, dtype=torch.bool)}
    if fused:
        batch["images"] = torch.from_numpy(rng.randn(
            b, *fcfg.image_shape, 3).astype(np.float32))
        batch["proj"] = torch.from_numpy(np.broadcast_to(kitti_camera(
            fcfg.image_shape[1] / KITTI_IMAGE[1]), (b, 3, 4)).copy())
    return batch


def step_record(state, logs, grads):
    """(logs, gradients by name, state dict, lr0) on the CPU, as
    `compare_train_step` takes them."""
    def copy(tree):  # `to_cpu` alone would keep a CPU tensor's storage
        return {k: v.detach().cpu().clone() for k, v in tree.items()}

    return (copy(logs), copy(dict(zip(state.param_names, grads))),
            copy(state.model.state_dict()), float(state.tx.lr(0)))


def dp_small_rank(rank, world, init_method):
    """A rank of phase 34: each small step over the ranks on this rank's
    sample (`DataParallelTrainStep`), the one-process step's ReLU and path
    decisions replayed on its rows; saves what it computed."""
    from df3d_torch.parallel import ddp
    from df3d_torch.train.trainer import DataParallelTrainStep

    f32_backends()
    dev = ddp.init_data_parallel(rank, world, backend="gloo",
                                 init_method=init_method, device="cuda:0")
    try:
        for i, name in enumerate(SMALL_DP_STEPS):
            (state, step), batch, decisions, args = small_dp_case(name, dev)
            rec = torch.load(DP_DIR / f"small{i}.pt")
            ddp.broadcast_state(state)
            mine = {k: v.to(dev) for k, v in
                    ddp.shard_batch(batch, rank, world).items()}
            with relu_decisions(rank_rows(rec["relu"], rank, world),
                                True) as flips, \
                    decisions(rank_rows(rec["picks"], rank, world),
                              True) as replays:
                logs, grads = DataParallelTrainStep(step).grads(
                    state, mine, *args)
            step.apply(state, grads)
            torch.save({"step": step_record(state, logs, grads),
                        "flips": flips,
                        "replays": replays},
                       DP_DIR / f"small{i}_rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(fn):
    """fn(rank, DP_WORLD, init_method) in `DP_WORLD` new processes, which
    meet through a file under build/dp/."""
    store = DP_DIR / "store"
    store.unlink(missing_ok=True)
    torch.multiprocessing.spawn(fn, nprocs=DP_WORLD,
                                args=(DP_WORLD, f"file://{store}"))


def phase_small_dp_train(dev):
    """Each of the six small training steps (phases 14, 17, 20, 22 and 29's
    configs and batches, the second sample's valid points and gt boxes
    cut)
    over 2 ranks sharing the card (gloo), one sample each, against the
    one-process batch-2 step on the card: the ranks replay the one-process
    step's ReLU decisions, queries, matches, NMS and neighbour decisions
    and proposals at near ties, as the card replays the CPU's in the
    small phases (at most 4 replays, each within 1e-4), and are held to
    `compare_train_step`'s tolerances for K1, K2 and cuDNN (every gradient
    leaf by L2, 5e-2; batch statistics 1e-4 * max + 1e-6, updated
    parameters, logs rtol 1e-4, cap overflow equal): cuDNN times and
    picks its f32 algorithms per shape and per run, so a rank's half batch
    rounds apart from the whole one, by more on some runs (one run of
    five saw the fused KITTI step's first-stage leaves 7x past the tight
    tolerance, at 7e-4 of their largest entry). Both ranks end with the
    same bits."""
    DP_DIR.mkdir(parents=True, exist_ok=True)
    refs = []
    for i, name in enumerate(SMALL_DP_STEPS):
        (state, step), batch, decisions, args = small_dp_case(name, dev)
        masks, picks = [], []
        with relu_decisions(masks, False), decisions(picks, False):
            logs, grads = step.grads(state, {k: v.to(dev) for k, v in
                                             batch.items()}, *args)
        step.apply(state, grads)
        refs.append(step_record(state, logs, grads))
        torch.save({"relu": masks, "picks": picks}, DP_DIR / f"small{i}.pt")
        del state, step
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn_ranks(dp_small_rank)
    log(f"small data-parallel steps: 2 ranks on one card over gloo, "
        f"{time.perf_counter() - t0:.1f} s for the six steps with the ranks' "
        "start")
    for i, name in enumerate(SMALL_DP_STEPS):
        got = [torch.load(DP_DIR / f"small{i}_rank{r}.pt")
               for r in range(DP_WORLD)]
        for r, g in enumerate(got):
            check(sum(n for n, _ in g["flips"]) <= 4
                  and all(z < 1e-4 for _, z in g["flips"]),
                  f"{name} rank {r}: ReLU replays {g['flips']}")
            check(sum(n for _, n, _ in g["replays"]) <= 4
                  and all(gap < 1e-4 for *_, gap in g["replays"]),
                  f"{name} rank {r}: decision replays {g['replays']}")
        for key in got[0]["step"][2]:
            check(torch.equal(got[0]["step"][2][key], got[1]["step"][2][key]),
                  f"{name}: the ranks' {key} differ")
        log(f"small {name} step, 2 ranks: ReLU replays "
            f"{[g['flips'] for g in got]}, decision replays "
            f"{[g['replays'] for g in got]}")
        compare_train_step(f"small {name} step, 2 ranks against 1 process",
                           refs[i], got[0]["step"], strict=False)


def rel_l2(got, ref):
    """||got - ref|| / ||ref|| (0 for two zero tensors)."""
    err, norm = (got - ref).double().norm(), ref.double().norm()
    return float(err / norm) if norm > 0 else float(err)


def dp_full_rank(rank, world, init_method):
    """A rank of phase 35: `full_fused_train_setup`'s step over the ranks
    on its rows of the batch that phase 35 saved (two samples of four).
    The step with the kernels' counts set to 0 just before and read just
    after (what it computed saved for phase 35); rank 0 then holds every
    K1 and K2 launch of its step against the plain versions (phases 15
    and 18's helpers) while rank 1 takes the same steps; then timed
    steps, a host-clock split with the all-reduces' stage, peak memory."""
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1
    from df3d_torch.parallel import ddp
    from df3d_torch.train.trainer import DataParallelTrainStep
    from df3d_torch.utils import stages

    f32_backends()
    dev = ddp.init_data_parallel(rank, world, backend="gloo",
                                 init_method=init_method, device="cuda:0")
    try:
        _, _, state, step, _ = full_fused_train_setup(dev, with_batch=False)
        ddp.broadcast_state(state)
        mine = {k: v.to(dev) for k, v in ddp.shard_batch(
            torch.load(DP_DIR / "full_batch.pt"), rank, world).items()}
        dp = DataParallelTrainStep(step)
        K1.launches = K1.bwd_launches = K2.launches = K2.bwd_launches = 0
        logs, grads = dp.grads(state, mine)
        counts = dict(k1_fwd=K1.launches, k1_bwd=K1.bwd_launches,
                      k2_fwd=K2.launches, k2_bwd=K2.bwd_launches)
        step.apply(state, grads)
        out = {"counts": counts}
        if rank == 0:
            out["step"] = step_record(state, logs, grads)
        del logs, grads
        if rank == 0:
            out["k1"] = phase_train_k1(state, dp, mine)
            out["k2"] = phase_fused_train_k2(state, dp, mine)
        else:
            dp.grads(state, mine)
            dp.grads(state, mine)
        state, _ = dp(state, mine)  # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        per_step = []
        for _ in range(DP_TIMED_STEPS):
            t0 = time.perf_counter()
            state, logs = dp(state, mine)
            torch.cuda.synchronize()
            per_step.append(1e3 * (time.perf_counter() - t0))
            check(np.isfinite(logs["loss"].item()), f"rank {rank}: loss")
        with stages.recording() as split:
            dp(state, mine)
        out.update(
            ms=per_step, split=split,
            grad_bytes=sum(p.numel() * p.element_size()
                           for p in state.params),
            peak_gib=torch.cuda.max_memory_allocated() / 2**30)
        torch.save(out, DP_DIR / f"full_rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def phase_dp_fused_train(dev):
    """The `centerpoint_3ddf_nusc` step at batch 4 (six 448x800 cameras a
    sample, phase 18's batch and weights) as 2 ranks x 2 samples sharing
    the card over gloo, against the one-process batch-4 step, run first
    and freed before the ranks start. Every gradient leaf within 5e-2
    relative L2 of the one process's (as the small steps' kernel runs),
    plus 1e-6 of the step's largest gradient entry per element; updated
    parameters (plus Adam's first-step jump, as in `compare_train_step`)
    and batch statistics 1e-3; logs rtol 1e-4, cap overflow equal. No
    decision is replayed at this width: a ReLU input within rounding of 0
    moves the leaves upstream of it (1.1-1.2% relative L2 seen on
    `conv_input`'s and `res1b`'s norms). Each rank must launch
    K1 and K2 as often in its step as the one process (16 + 15 and 1 + 1);
    rank 0 holds each launch against its plain version. Prints per rank
    ms/step, the split (with `allreduce`: the gradients' and logs'
    all-reduces and the norms' and normalizers' collectives, both ways),
    the gradient bytes all-reduced and peak memory. Two ranks sharing one
    card run one after the other on it: their ms/step is not a two-card
    number. Returns what each rank measured: its launch counts and, rank
    0's, K1's and K2's numbers."""
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1
    from df3d_torch.train.schedules import global_norm

    DP_DIR.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    _, _, state, step, batch = full_fused_train_setup(dev)
    torch.save({k: v.cpu() for k, v in batch.items()},
               DP_DIR / "full_batch.pt")
    K1.launches = K1.bwd_launches = K2.launches = K2.bwd_launches = 0
    logs, grads = step.grads(state, batch)
    one = dict(k1_fwd=K1.launches, k1_bwd=K1.bwd_launches,
               k2_fwd=K2.launches, k2_bwd=K2.bwd_launches)
    step.apply(state, grads)
    ref = step_record(state, logs, grads)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"data-parallel fused step: the one-process batch-4 step launches "
        f"{one}, peak {peak:.3f} GiB, {time.perf_counter() - t0:.1f} s with "
        "its build and batch; freed before the ranks start")
    del state, step, batch, logs, grads
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn_ranks(dp_full_rank)
    log(f"data-parallel fused step: 2 ranks, {time.perf_counter() - t0:.1f}"
        " s with their start and build")
    ranks = [torch.load(DP_DIR / f"full_rank{r}.pt")
             for r in range(DP_WORLD)]
    for r, got in enumerate(ranks):
        check(got["counts"] == one,
              f"rank {r} launched {got['counts']}, the one process {one}")
        log(f"data-parallel fused step, rank {r} of 2 sharing one card "
            f"(not a two-card number): ms/step "
            f"{[round(x, 3) for x in got['ms']]}, mean "
            f"{np.mean(got['ms']):.3f}; split (ms, host clock, "
            "synchronised): " + ", ".join(f"{k} {v:.3f}" for k, v in
                                          got["split"].items())
            + f"; gradient bytes all-reduced {got['grad_bytes']}; peak "
            f"memory {got['peak_gib']:.3f} GiB; launches in its step "
            f"{got['counts']}")
    g_logs, g_grads, g_sd, _ = ranks[0]["step"]
    c_logs, c_grads, c_sd, lr0 = ref
    check(int(g_logs["cap_overflow"]) == int(c_logs["cap_overflow"]),
          "data-parallel fused step: cap overflow differs")
    for k, v in c_logs.items():
        check(abs(g_logs[k].item() - v.item()) <= 1e-4 * abs(v.item()),
              f"data-parallel fused step: log {k} {g_logs[k].item()} "
              f"against {v.item()}")
    # a leaf whose exact gradient is 0 (a bias ahead of a training norm, an
    # attention key's bias) holds rounding noise of the step's scale: the
    # floor is 1e-6 of the step's largest gradient entry, per element.
    # Adam's first update g / (|g| + eps) jumps by 2 where g crosses 0, so
    # an updated parameter also gets lr * ||u(g + t) - u(g - t)||, t the L2
    # gap of the two clipped gradients (it bounds every element's gap)
    scale = max(g.abs().max().item() for g in c_grads.values())
    clip_c, clip_g = (min(1.0, 10.0 / float(global_norm(list(g.values()))))
                      for g in (c_grads, g_grads))
    floor, slack = {}, {}
    for k, c in c_grads.items():
        floor[k] = 1e-6 * scale * c.numel() ** 0.5
        cg = c * clip_c
        t = (g_grads[k] * clip_g - cg).norm()
        slack[k] = lr0 * ((cg + t) / ((cg + t).abs() + 1e-8)
                          - (cg - t) / ((cg - t).abs() + 1e-8)).norm()
    stats = {k: v for k, v in c_sd.items()
             if k.endswith(("running_mean", "running_var"))}
    worst, over = {}, []
    for kind, want, have, tol, extra in (
            ("gradient", c_grads, g_grads, 5e-2, floor),
            ("parameter", {k: c_sd[k] for k in c_grads}, g_sd, 1e-3, slack),
            ("statistic", stats, g_sd, 1e-3, {})):
        for k, r in want.items():
            err, norm = ((have[k] - r).double().norm().item(),
                         r.double().norm().item())
            bound = (tol * norm + 1e-6 * r.numel() ** 0.5
                     + float(extra.get(k, 0.0)))
            worst[kind] = max(worst.get(kind, (0.0,)),
                              (err / bound, k, err, norm, bound))
            if err > bound:
                over.append(f"{kind} {k}: L2 gap {err:.4g}, L2 {norm:.4g}, "
                            f"bound {bound:.4g}")
    log(f"data-parallel fused step against the one process (largest "
        f"gradient entry {scale:.4g}), the leaf nearest its bound: "
        + "; ".join(f"{kind} {k} at {q:.3g} of it (L2 gap {e:.4g}, L2 "
                    f"{n:.4g})" for kind, (q, k, e, n, _) in worst.items()))
    check(not over, "data-parallel fused step: " + "; ".join(over[:10]))
    log(f"data-parallel fused step: loss {g_logs['loss'].item():.6f} (one "
        f"process {c_logs['loss'].item():.6f}), {len(c_grads)} gradient "
        "leaves, updated parameters and batch statistics agree")
    return ranks


def phase_dryrun_multichip():
    """`entry.dryrun_multichip` over every card there is (one rank each,
    NCCL): a CenterPoint and a CenterPoint + 3D-DF training step, finite
    losses."""
    from df3d_torch.entry import dryrun_multichip

    n = torch.cuda.device_count()
    t0 = time.perf_counter()
    losses = dryrun_multichip(n)
    check(all(np.isfinite(v) for v in losses.values()),
          f"dryrun_multichip: {losses}")
    log(f"dryrun_multichip({n}) over NCCL: {losses}, "
        f"{time.perf_counter() - t0:.1f} s with the ranks' start")


def f32_backends():
    """TF32 off for matmuls and cuDNN convs, cuDNN's algorithms timed: the
    settings of every process that runs a phase (a spawned rank too)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # the frame shapes are static, so cuDNN can time its f32 algorithms once
    # in the warm-up; its default pick for the 180x180 BEV convs is an FFT
    # algorithm that spends ~90 ms a frame in tens of thousands of gemv calls
    torch.backends.cudnn.benchmark = True


def main():
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    from df3d_torch.models.detectors.centerpoint import CenterPointConfig
    from df3d_torch.entry import (
        build_centerpoint, build_centerpoint3ddf, build_transfusion,
        build_transfusion3ddf, infer, infer_fused, infer_transfusion,
        infer_transfusion_fused,
    )
    from df3d_torch.ops import build
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1

    f32_backends()
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
            if "entry function" in line:
                log(f"  {name}: {line.split('entry function')[1].strip()}")
            elif "registers" in line or "spill" in line:
                log(f"  {name}:   {line.strip()}")

    phase_small_input(dev)

    cfg = CenterPointConfig(max_voxels=REALISTIC_STAGE_CAPS[0],
                            stage_caps=REALISTIC_STAGE_CAPS)
    model = build_centerpoint(cfg, dev, seed=0)
    frames = full_width_frames(3)
    k1 = phase_k1(model, cfg, frames[0], dev)
    lidar = phase_main_path("main path", model, cfg, frames, dev, infer,
                            len(cfg.tasks) * cfg.nms_post_max_size)
    del model

    phase_small_fused(dev)
    fcfg_l, fcfg = full_fused_configs()
    fmodel = build_centerpoint3ddf(fcfg_l, fcfg, dev, seed=0)
    k2 = phase_k2(fmodel, fcfg_l, fused_inputs(frames[0], fcfg.num_cams,
                                               fcfg.image_shape, dev, 10),
                  infer_fused, K2_PER_FUSED_FRAME)
    fused = phase_fused_main_path(
        "fused main path", fmodel, fcfg_l, fcfg, frames, dev, infer_fused,
        len(fcfg_l.tasks) * fcfg_l.nms_post_max_size, K2_PER_FUSED_FRAME)
    del fmodel

    phase_small_transfusion(dev)
    tcfg, tfcfg = full_transfusion_configs()
    tmodel = build_transfusion(tcfg, dev, seed=0)
    tk1 = phase_k1(tmodel, tcfg, frames[0], dev, infer_transfusion,
                   edge_cases=False)
    tlidar = phase_main_path("TransFusion-L path", tmodel, tcfg, frames, dev,
                             infer_transfusion, tcfg.head.num_proposals)
    del tmodel

    phase_small_transfusion_fused(dev)
    tfmodel = build_transfusion3ddf(tcfg, tfcfg, dev, seed=0)
    tk2 = phase_k2(tfmodel, tcfg, fused_inputs(frames[0], tfcfg.num_cams,
                                               tfcfg.image_shape, dev, 10),
                   infer_transfusion_fused, K2_PER_TRANSFUSION_FUSED_FRAME,
                   edge_cases=False)
    tfused = phase_fused_main_path(
        "TransFusion + 3D-DF path", tfmodel, tcfg, tfcfg, frames, dev,
        infer_transfusion_fused, tcfg.head.num_proposals,
        K2_PER_TRANSFUSION_FUSED_FRAME)

    del tfmodel
    torch.cuda.empty_cache()

    phase_small_train(dev)
    _, state, step, batch = full_train_setup(dev)
    k1_train = phase_train_k1(state, step, batch)
    train = phase_train_path(state, step, batch)
    del state, step, batch
    torch.cuda.empty_cache()

    phase_small_fused_train(dev)
    _, fcfg, state, step, batch = full_fused_train_setup(dev)
    k2_train = phase_fused_train_k2(state, step, batch)
    fused_train = phase_fused_train_path(state, step, batch, fcfg)
    del state, step, batch
    torch.cuda.empty_cache()

    phase_small_transfusion_train(dev)
    _, state, step, batch = full_train_setup(dev, transfusion=True)
    tk1_train = phase_train_k1(state, step, batch)
    ttrain = phase_train_path(state, step, batch,
                              label="TransFusion-L train path")
    del state, step, batch
    torch.cuda.empty_cache()

    phase_small_transfusion_fused_train(dev)
    _, fcfg, state, step, batch = full_fused_train_setup(dev,
                                                         transfusion=True)
    n_actr = fcfg.actr.num_layers
    tk2_train = phase_fused_train_k2(state, step, batch, per_step=n_actr)
    tfused_train = phase_fused_train_path(
        state, step, batch, fcfg, k2_per_step=n_actr,
        label="TransFusion + 3D-DF train path")

    # each path's timed run, counts set to 0 just before it and read just
    # after; "launches" sums the paths. The top-level numbers are the
    # CenterPoint paths' (phases 4 and 7), "transfusion" holds phases 10's
    # and 12's, K1's "train" the CenterPoint training path's (phases 15
    # and 16: K1's forward and backward launches, its backward times and
    # dW's), K2's "train" the CenterPoint + 3D-DF training path's (phases
    # 18 and 19: K2's forward and backward launches, its backward times
    # and the step's forward launches' times, bounds and error), and
    # "transfusion"'s "train" the same for the TransFusion training paths
    # (K1: phase 21; K2: phase 23, two launches each way a step);
    # "fused_train", "transfusion_train" and "transfusion_fused_train"
    # count phases 19's, 21's and 23's launches of each kernel. Below,
    # "kitti_lidar" and "kitti_fused" count phases 26's and 28's launches,
    # "kitti_train" and "kitti_fused_train" phases 31's and 33's, and
    # "kitti" holds phases 25's and 27's numbers, its "train" phases 30's
    # (K1, its forward timed too) and 32's (K2).
    paths = {"lidar": lidar, "fused": fused, "transfusion_lidar": tlidar,
             "transfusion_fused": tfused}
    for entry, kernel, extra in ((k1, K1, tk1), (k2, K2, tk2)):
        entry["launches_by_path"] = {name: launches[kernel]
                                     for name, launches in paths.items()}
        entry["transfusion"] = {k: v for k, v in extra.items()
                                if k not in ("name", "route", "source",
                                             "replaces", "library_ms")}
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   extra["max_abs_err"])
    k1["launches_by_path"]["train"] = train["train_fwd"] + train["train_bwd"]
    k2["launches_by_path"]["train"] = 0
    k1["launches_by_path"]["fused_train"] = (fused_train["k1_fwd"]
                                             + fused_train["k1_bwd"])
    k2["launches_by_path"]["fused_train"] = (fused_train["k2_fwd"]
                                             + fused_train["k2_bwd"])
    k1["train"] = dict(fwd_launches=train["train_fwd"],
                       bwd_launches=train["train_bwd"], **k1_train)
    k2["train"] = dict(fwd_launches=fused_train["k2_fwd"],
                       bwd_launches=fused_train["k2_bwd"], **k2_train)
    k1["launches_by_path"]["transfusion_train"] = (ttrain["train_fwd"]
                                                   + ttrain["train_bwd"])
    k2["launches_by_path"]["transfusion_train"] = 0
    k1["launches_by_path"]["transfusion_fused_train"] = (
        tfused_train["k1_fwd"] + tfused_train["k1_bwd"])
    k2["launches_by_path"]["transfusion_fused_train"] = (
        tfused_train["k2_fwd"] + tfused_train["k2_bwd"])
    del state, step, batch
    torch.cuda.empty_cache()

    phase_small_kitti(dev)
    kk1, kk2, klidar, kfused = phase_kitti_paths(dev, kitti_frames(3))
    for entry, kernel, extra in ((k1, K1, kk1), (k2, K2, kk2)):
        entry["launches_by_path"]["kitti_lidar"] = klidar[kernel]
        entry["launches_by_path"]["kitti_fused"] = kfused[kernel]
        entry["kitti"] = {k: v for k, v in extra.items()
                          if k not in ("name", "route", "source",
                                       "replaces", "library_ms")}
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   extra["max_abs_err"])
    k1["transfusion"]["train"] = dict(fwd_launches=ttrain["train_fwd"],
                                      bwd_launches=ttrain["train_bwd"],
                                      **tk1_train)
    k2["transfusion"]["train"] = dict(fwd_launches=tfused_train["k2_fwd"],
                                      bwd_launches=tfused_train["k2_bwd"],
                                      **tk2_train)
    k1["max_abs_err"] = max(k1["max_abs_err"], k1_train["bwd_max_abs_err"],
                            tk1_train["bwd_max_abs_err"])
    k2["max_abs_err"] = max(k2["max_abs_err"], k2_train["bwd_max_abs_err"],
                            tk2_train["bwd_max_abs_err"],
                            k2_train["fwd_max_abs_err"],
                            tk2_train["fwd_max_abs_err"])
    phase_small_kitti_train(dev)
    kk1_train, ktrain, kk2_train, kfused_train = phase_kitti_train(dev)
    k1["launches_by_path"]["kitti_train"] = (ktrain["train_fwd"]
                                             + ktrain["train_bwd"])
    k2["launches_by_path"]["kitti_train"] = 0
    k1["launches_by_path"]["kitti_fused_train"] = (kfused_train["k1_fwd"]
                                                   + kfused_train["k1_bwd"])
    k2["launches_by_path"]["kitti_fused_train"] = (kfused_train["k2_fwd"]
                                                   + kfused_train["k2_bwd"])
    k1["kitti"]["train"] = dict(fwd_launches=ktrain["train_fwd"],
                                bwd_launches=ktrain["train_bwd"], **kk1_train)
    k2["kitti"]["train"] = dict(fwd_launches=kfused_train["k2_fwd"],
                                bwd_launches=kfused_train["k2_bwd"],
                                **kk2_train)
    k1["max_abs_err"] = max(k1["max_abs_err"], kk1_train["bwd_max_abs_err"])
    k2["max_abs_err"] = max(k2["max_abs_err"], kk2_train["bwd_max_abs_err"],
                            kk2_train["fwd_max_abs_err"])
    torch.cuda.empty_cache()

    phase_small_dp_train(dev)
    dp_ranks = phase_dp_fused_train(dev)
    phase_dryrun_multichip()
    # phase 35's step, both ranks: counts set to 0 just before and read just
    # after in each rank; "dp" holds the counts per rank and rank 0's K1
    # and K2 numbers (phases 15 and 18's helpers on its step)
    counts = [r["counts"] for r in dp_ranks]
    for entry, kernel in ((k1, "k1"), (k2, "k2")):
        entry["launches_by_path"]["dp_fused_train"] = sum(
            c[f"{kernel}_fwd"] + c[f"{kernel}_bwd"] for c in counts)
        entry["dp"] = dict(
            ranks=DP_WORLD, fwd_launches_per_rank=[
                c[f"{kernel}_fwd"] for c in counts],
            bwd_launches_per_rank=[c[f"{kernel}_bwd"] for c in counts],
            **dp_ranks[0][kernel])
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   dp_ranks[0][kernel]["bwd_max_abs_err"])
    k2["max_abs_err"] = max(k2["max_abs_err"],
                            dp_ranks[0]["k2"]["fwd_max_abs_err"])
    for entry in (k1, k2):
        entry["launches"] = sum(entry["launches_by_path"].values())

    log(f"card: {card}")
    print(json.dumps({"kernels": [k1, k2]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
