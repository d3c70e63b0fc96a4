#!/usr/bin/env python3
"""Drive the PyTorch port's serving paths on one CUDA card: CenterPoint
(LiDAR only), CenterPoint + 3D-DF (six cameras + LiDAR), TransFusion-L
(LiDAR only) and TransFusion + 3D-DF (six cameras + LiDAR); then the
training steps of the same four models; then KITTI's Voxel R-CNN and
Voxel R-CNN + 3D-DF (one camera + LiDAR) serving paths and training
steps; then the training steps data parallel; then CenterPoint in the
bf16 "tpu_v5e" serving profile beside "exact"; then the evaluation path:
reference checkpoints imported, double-flip TTA, recalibration and the
metrics; then the fused training steps with the aux objectives and
TransFusion + 3D-DF with the Swin-T image branch; then every preset of
the registry built by name, and "tpu_v5e" on each of them beside
"exact"; then training and evaluation from datasets on disk through the
train and test CLIs; then infos made from raw KITTI and nuScenes files
by `create_data` and trained on, the train CLI over 2 ranks, the demo
and fit_caps; then PV-RCNN, PointPillars and the TransFusion LC image
decoder.

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
   gives the same bits in all three; so do small inputs at its edge cases
   on both paths (corners off the map and on its last row and column,
   exact integer pixel positions, L 1 and 3, D 8, zero weights, a zero
   cotangent, a pixel 4400 samples of one head hit, an all-zero
   cotangent, whose dvalue must be all zeros). Prints the
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
37. the "tpu_v5e" serving profile (`entry.build_centerpoint(...,
   profile="tpu_v5e")`: bf16 sparse-conv bodies from 32 input channels,
   the dense tail on bf16-rounded operands): every K1 launch of one
   full-width frame, 6 on K1's f32 form (held as in phase 4) and 10 on its
   bf16 form, each of these against the bf16 plain version within one
   bf16 ulp (bit patterns at most one apart) or 1e-6, and a repeat launch
   bit for bit; K1's edge cases in bf16 first. Per bf16 launch: back-to-
   back and device time, the plain version's time, the bound (2 bytes per
   touched table element, weight and output, 4 per index, or FLOP at the
   dense bf16 peak), and how many outputs sit one ulp from the plain ones.
38. the small input of phase 3 in "tpu_v5e", card against CPU: phase 3's
   tolerances, every near-tie replay within 1e-4 and counted but not
   bounded in number, the boxes' headings printed and not held (their rot
   maps are; `phase_profile_small` says why).
39. full-width frames in "exact" and "tpu_v5e" (one model each, the same
   weights) one after the other, each timed as phase 5 with its split,
   profile and peak memory: K1 16 f32 launches a frame
   in "exact", 6 f32 and 10 bf16 in "tpu_v5e", K2 none; then the two
   profiles' head maps of one frame against each other.
40. imported weights: synthetic reference checkpoints at the full widths
   of `centerpoint_nusc` (det3d's names, spconv v1, {'state_dict': ...}),
   `transfusion_l_nusc` (mmdet3d's, DDP's 'module.' prefix) and
   `voxel_rcnn_car_kitti` (pcdet's, spconv v2, {'model_state': ...}),
   written with torch.save from seeded random port weights
   (`det3d_state_dict`, `mmdet3d_state_dict`, `pcdet_state_dict`) and
   built on the card by `entry.build_*(checkpoint=...)`: every entry must
   equal its source (the import is strict both ways), and each serves one
   full-width frame (K1 16, 16 and 12 launches). Then each family at a
   small config from a small checkpoint, card against CPU as phases 3, 9
   and 24.
41. double-flip TTA, LiDAR: phase 3's small config card against CPU with
   `entry.infer_double_flip` (kept boxes, near ties replayed, and the
   merged head maps to atol = rtol = 1e-3); then `centerpoint_nusc` at
   full width, each 260k-point frame as its four flips in one batch-4
   forward at the serving caps: every K1 launch of one TTA frame against
   the plain version and a repeat launch (phase 4's tolerance), timed with
   its bound; TTA frames timed as phase 5 (K1 16 launches a frame).
42. double-flip TTA, fused: `centerpoint_3ddf_nusc`, six 448x800 cameras
   repeated for the four flips, each variant's reflection composed into
   its projections: K2's launch on its warp path at B = 4 against the
   plain version as in phase 7, K1 16 launches; TTA frames timed (K1 16,
   K2 1 a frame).
43. recalibration and the metrics: `recalibrate_batch_stats` on the small
   CenterPoint, card against CPU; nuScenes mAP/NDS of phase 41's TTA
   frames against their scenes' boxes and KITTI's APs, AOS and recall of
   phase 40's KITTI frame against its cars (random weights: no accuracy);
   the ground truth scored as its own detections must give what
   tests/test_nuscenes_eval.py::test_perfect_detections and
   tests/test_kitti_eval.py::test_perfect_detection_ap_high assert, and
   KITTI's frame of cars the exact R40 AP of each difficulty's count.
44. aux, small: phases 17, 22 and 29's small fused training steps with
   the aux objectives (`aux=True`), card against CPU with those phases'
   tolerances, the aux head's leaves and the three aux logs among them.
45. aux, full width: `centerpoint_3ddf_nusc` and `transfusion_3ddf_nusc`
   at batch 4 x six 448x800 cameras, `voxel_rcnn_3ddf_kitti` at batch 2,
   each step aux off then aux on in this process (2 warm-up + 3 timed
   steps, the split with an `aux` stage, peak memory); the aux step's K1
   and K2 launch counts equal the aux-off step's, and each launch of one
   aux step is held against its plain version (`check_launches`).
46. aux, data parallel: phase 34 for the three fused small steps with the
   aux objectives (their normalizers over the global batch).
47. Swin small: phase 11's check on `transfusion_3ddf_swin_nusc`'s Swin-T
   branch narrowed (one block a stage, width 24) on two 64x112 cameras.
48. Swin at full width: `transfusion_3ddf_swin_nusc` on six 448x800
   cameras: every launch of one frame against its plain version (K1 16,
   K2 2), 3 warm-up and 5 timed frames with the split; then a seeded
   synthetic mmdet TransFusion + Swin checkpoint at full width through
   `build_transfusion3ddf(..., checkpoint=)`, every entry equal to its
   source, one frame finite.
49. Swin training: the preset's step at batch 4 (K1 16 + 15, K2 2 + 2, each
   launch against its plain version), 2 warm-up + 3 timed steps, the split
   and peak memory.
50. presets by name: each of the registry's eight presets
   (`config.get_preset`), narrowed by `--set` overrides
   (`config.apply_preset_overrides`) to its family's small config
   (phases 3, 9 and 24's; a fused preset's cameras small through
   `build_detector`'s `image_shape`), built by
   `models.build.build_detector` on the card, serves one small input in
   "exact" against a CPU copy of the same model: phases 3, 9 and 24's
   checks, near ties replayed and counted.
51. "tpu_v5e" on every preset but `centerpoint_nusc`: phase 50's models in
   the profile, card against CPU (`profile_card_vs_cpu`: any number of
   near-tie replays, TransFusion's peak test among them, each within
   `PROFILE_TIE`; maps, boxes and scores within `PROFILE_MAP_REL` of their
   largest value: the bf16 stages round an ulp apart where card and CPU
   sum in other orders, and later layers carry it); K1's bf16 form at
   KITTI's shapes (strided N_out < N_in, `conv_out`'s 3 taps to 128,
   all-miss rows); then the six presets built by name at full width,
   one frame each in "tpu_v5e" with every launch held against its plain
   version (K1 f32 as phase 4, K1 bf16 within one ulp and bit for bit on
   repeat, K2 as phase 7) and counted: K1 6 f32 and 10 bf16 launches a
   nuScenes frame, 3 and 9 a KITTI one, K2 as in "exact".
52. the six presets at full width in "exact" and "tpu_v5e" (one model
   each, the profile switched, the same frames), each timed as phase 5
   (2 warm-up, 3 timed frames, the split, peak memory, a one-frame
   profile) with the launch counts asserted; then K1's bf16 launches of
   a TransFusion-L and a Voxel R-CNN frame timed per launch against
   phase 37's bound.
53. the CLIs, small, card against CPU: a tiny nuScenes-layout dataset
   (two ray-cast frames cut to 3000 points, each split into a key frame
   and nine sweeps) and a tiny KITTI-layout one (two KITTI frames with
   their cars) written into a temporary directory under build/;
   `centerpoint_tiny_smoke` at its own widths, and `voxel_rcnn_car_kitti`
   and `voxel_rcnn_3ddf_kitti` narrowed to phase 29's grid (pcdet's three
   RoI pooling scales; the fused one with 96x320 PNGs, one camera). For
   each, phase 14's check of one step on the CLI's model and the loader's
   first batch from disk (`small_step_card_vs_cpu`; KITTI with the CLI's
   RoI sampler noise, its proposal decisions replayed, and the CPU's step
   in f64 as a witness of how far each f32 step lies from exact); then
   the train CLI (`df3d_torch.tools.train.main`) for 2 steps on the CPU
   and on the card, fed the same batches, the card replaying the CPU's
   decisions at near ties in the first step (`compare_cli_runs` states
   what is held after each step); the card run's checkpoint restored bit
   for bit; a resumed run that starts at the saved step.
54. `centerpoint_nusc` at full width from disk: 8 ray-cast frames (260k
   points each, ~42 MB) with their boxes; the train CLI at batch 4 for
   2 epochs of 2 steps (the first epoch's K1 launches, 16 + 15 a step,
   each held against its plain version; the second epoch resumed from
   the first's checkpoint), each step's data ms and step ms and the
   checkpoint's save and restore seconds; then the test CLI on the last
   checkpoint over 4 frames in "exact" (K1 16 a frame) and "tpu_v5e" (6
   f32 and 10 bf16), each launch held against its plain version, the
   metrics JSON written.
55. `voxel_rcnn_3ddf_kitti` at full width, batch 2, from disk with
   375x1242 PNGs (Pillow resizes them to 384x1280): the train CLI for 2
   steps (K1 12 + 11, K2 1 + 1 on its general path a step, each launch
   held against its plain version), then the test CLI once (K1 12, K2 1
   a frame). Without Pillow on the machine, the preset trains through
   the CLI's --synthetic and the test CLI is not run.
56. `create_data nuscenes` from raw tables (`utils.synth.
   write_nuscenes_raw`: 8 samples, each a ray-cast key frame and 9 sweeps
   in their own LiDAR frames, six 1600x900 JPEG cameras, the scenes'
   boxes under raw category names; Pillow must write and read JPEG), then
   the train CLI on `centerpoint_3ddf_nusc` at batch 4 for 2 steps (K1
   16 + 15, K2 1 + 1 a step) and the test CLI on 4 frames (K1 16, K2 1),
   every launch held against its plain version; step ms beside data ms.
57. `create_data kitti --with-gt-database --with-image-crops` from raw
   KITTI files (4 frames, labels, 375x1242 PNGs), then the train CLI on
   `voxel_rcnn_3ddf_kitti` at batch 2 for 2 steps (K1 12 + 11, K2 1 + 1
   a step), every launch held against its plain version.
58. the train CLI over 2 ranks sharing the card (`--nprocs 2`, gloo),
   `centerpoint_nusc`, global batch 4, 2 steps, against the one-process
   CLI: logs, statistics after step 1, and each step's update and change
   of the statistics in relative L2 (`phase_cli_ranks`); each rank's
   ms/step, split with its `allreduce` stage and launches (16 + 15 a
   step).
59. the demo on the card: `centerpoint_nusc` on a 260k-point .bin with
   phase 54's checkpoint, equal to the test CLI's eval step (K1 16, held
   against the plain version); `centerpoint_tiny_smoke` card against CPU.
60. fit_caps on the card: `centerpoint_nusc --synthetic --frames 8`, the
   four stage occupancies of each frame equal to the CPU's; the fitted
   caps beside bench.py's REALISTIC_STAGE_CAPS.
61. PV-RCNN: a small PV-RCNN (every VSA scale, 128 keypoints) card against
   CPU with near ties replayed (`voxelrcnn_decisions` on `pv_rcnn`), then
   `PVRCNNConfig()` at full KITTI width on three KITTI frames
   (`make_kitti_sample`): every K1 launch of one frame against its plain
   version (12 a frame), the path (voxelize -> PVRCNN -> proposal_layer
   -> PVRCNNRoIHead -> post-processing) timed with K1 12 and K2 0
   launches a frame, its stage split (the keypoint stages FPS, ball
   queries and BEV sample apart), a one-frame profile and peak memory;
   each frame's keypoints labelled against its cars.
62. PointPillars at full width (`PointPillarConfig()`, 16 000 pillars of
   32 points built with numpy from the KITTI frames): card against CPU,
   then ms/frame, a split and peak memory.
63. the TransFusion LC image decoder at `transfusion_3ddf_nusc`'s head
   width on six 112x200 feature maps of 256 channels, seeded inputs
   (queries seen by 0, 1 or 2 cameras, the gaussian term on): card
   against CPU, then ms a call and peak memory.

TF32 is off for matmuls and cuDNN convs: the port serves in f32 (the JAX
package's "exact" profile) and the comparisons need full f32; the
"tpu_v5e" phases round to bf16 where the profile says. cuDNN picks its
conv algorithms by timing them (cudnn.benchmark).

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
launches per rank and rank 0's kernel numbers; the third entry, K1_bf16,
is K1's bf16 form: phase 37's numbers, phase 39's "tpu_v5e" launches;
"tta" holds phases 41's (K1) and 42's (K2) numbers at the TTA's batch-4
shapes, and "launches" adds phases 40-42's; "<preset>_<profile>" in
"launches_by_path" counts phase 52's timed frames, and K1_bf16's
"transfusion" and "kitti" hold phase 52's per-launch numbers;
"cli_small_<preset>", "cli_train_<preset>" and
"cli_test_<preset>[_<profile>]" count phases 53-55's CLI runs,
"create_data_<train|test>_<preset>" phases 56-57's, "cli_ranks" phase
58's over both ranks, "demo_<preset>" phase 59's and "pv_rcnn" phase
61's; K1's "pv_rcnn" holds phase 61's per-launch numbers) and
the result line
{"ok": true, "device": {...}}. With no CUDA device, or outside a checkout,
the script exits non-zero without them.
"""

import contextlib
import dataclasses
import functools
import json
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12
TF32_FLOP_PER_S = 495e12
BF16_FLOP_PER_S = 989e12

REALISTIC_STAGE_CAPS = (102_400, 73_728, 27_648, 10_240)
NUM_POINTS = 260_000
TIMED_FRAMES = 10
FUSED_TIMED_FRAMES = 5
K1_PER_FRAME = 16
# a CenterPoint frame in the "tpu_v5e" profile: conv_input, res1 and down2
# (Cin 5 and 16) on K1's f32 form, res2, down3, res3 and down4 (Cin 32 and
# 64) on its bf16 form
K1_F32_PER_PROFILE_FRAME = 6
K1_BF16_PER_FRAME = 10
K1_TILE_ROWS = 64
K2_PER_FUSED_FRAME = 1
K2_PER_TRANSFUSION_FUSED_FRAME = 2  # one per ACTR layer
# training: batch, steps, and K1's input-gradient launches a step (every
# sparse conv but conv_input, whose input, the voxel features, needs none)
TRAIN_BATCH = 4
TRAIN_WARMUP_STEPS = 2
TRAIN_TIMED_STEPS = 3
K1_BWD_PER_STEP = 15
SCENE_CLASSES = (0,) * 52 + (1,) * 9 + (8,) * 18
# a K2 output element costs ~14 FLOP of corner arithmetic per sample and
# head (shared by its D channels) plus a multiply-add per in-bounds corner
K2_FLOP_PER_SAMPLE = 14
# K2's backward: ~30 FLOP per sample (corner weights, dattn, dloc) and per
# in-bounds corner and channel a multiply-add for g . v and a multiply and
# an add for dvalue
K2_BWD_FLOP_PER_SAMPLE = 30


T0 = time.perf_counter()


def log(*args):
    """Print with the seconds since the script started."""
    print(f"[{time.perf_counter() - T0:7.1f} s]", *args, flush=True)


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
                     decisions=None, max_replays=4):
    """The path with its kernels on the card and the same path with the
    plain versions on the CPU: same weights (`build(device)`) and inputs
    (CPU tensors: points, valid, then the fused path's images and proj).
    With `decisions` (`transfusion_decisions`), the CPU run records the
    path's decisions and the card run replays them at near ties: at most
    `max_replays` entries differ (None: any number), each a tie within
    1e-4 on the card, counted.
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
    n_replayed = sum(n for _, n, _ in replays)
    check((max_replays is None or n_replayed <= max_replays)
          and all(gap < 1e-4 for *_, gap in replays),
          f"{label}: more than {max_replays} decisions differ from the "
          f"CPU's, or one is no tie within 1e-4: {replays}")
    check(torch.equal(c_coords, g_coords), f"{label}: voxel coords differ")
    for k in cpu[2]:
        check(torch.equal(cpu[2][k], card[2][k]), f"{label}: {k} differs")
    return cpu, card, replays


def card_vs_cpu(label, build, cfg, inputs, infer_fn, dev, max_replays=4,
                heading=True):
    """CenterPoint's paths, card against CPU (`run_card_and_cpu`): voxel
    coords, cap overflows and kept boxes equal; head maps to atol = rtol =
    1e-3. The card replays the CPU's pre-NMS top-k and NMS decisions where
    its own differ, each a near tie within 1e-4, at most `max_replays`
    entries (`centerpoint_decisions`), counted. Without `heading`, the
    boxes' heading (column 6) is printed and not held: it is the atan2 of
    the rot map's two channels, held with the other maps."""
    (c_preds, c_det, c_ov), (g_preds, g_det, _), replays = run_card_and_cpu(
        label, build, cfg, inputs, infer_fn, dev, centerpoint_decisions,
        max_replays)
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
    cols = [c for c in range(c_det["boxes"].shape[-1])
            if heading or c != 6]
    torch.testing.assert_close(g_det["boxes"][m][:, cols],
                               c_det["boxes"][m][:, cols],
                               atol=1e-3, rtol=1e-3)
    gaps = (g_det["boxes"][m] - c_det["boxes"][m]).abs()
    gaps = gaps.max(0).values.tolist() if m.any() else []
    log(f"{label}: card vs CPU plain path agree: max head-map diff "
        f"{worst:.3g}, {int(m.sum())} kept boxes equal (max diff per "
        f"column {[float(f'{g:.3g}') for g in gaps]}; decision replays: "
        f"{sum(n for _, n, _ in replays)} entries, {replays}), cap overflow "
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


# the run's ray-cast frames: the serving frames (seeds 100-102) and the
# training batch's (0-3); ~10 s each on the host, so `prefetch_frames`
# casts them in worker processes while the kernels build
SERVING_SEEDS, TRAIN_SEEDS = (100, 101, 102), (0, 1, 2, 3)
_FRAMES = {}


def _cast_frame(seed):
    """One ray-cast frame (a worker process's job)."""
    from df3d_torch.utils.synth import make_raycast_frame

    return make_raycast_frame(np.random.RandomState(seed), NUM_POINTS)


def raycast_frame(seed):
    """`utils.synth.make_raycast_frame(RandomState(seed), NUM_POINTS)`,
    cast once a run."""
    if seed not in _FRAMES:
        _FRAMES[seed] = _cast_frame(seed)
    return _FRAMES[seed]


def prefetch_frames(seeds):
    """Start casting `seeds` in worker processes, one each (spawned: the
    parent has touched CUDA); -> a function that waits for them, puts
    them in `raycast_frame`'s cache and stops the workers."""
    import concurrent.futures
    import multiprocessing

    pool = concurrent.futures.ProcessPoolExecutor(
        len(seeds), mp_context=multiprocessing.get_context("spawn"))
    jobs = {s: pool.submit(_cast_frame, s) for s in seeds}

    def collect():
        try:
            for seed, job in jobs.items():
                _FRAMES[seed] = job.result()
        finally:
            pool.shutdown(cancel_futures=True)
    return collect


def full_width_frames(n):
    return [raycast_frame(SERVING_SEEDS[0] + i) for i in range(n)]


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


def bf16_ulps(a, b):
    """Distance in bf16 ulps between two bf16 tensors, element by element:
    their bit patterns as sign-magnitude integers, subtracted."""
    def codes(x):
        u = x.contiguous().view(torch.int16).int() & 0xFFFF
        return torch.where(u >= 0x8000, -(u & 0x7FFF), u)
    return (codes(a) - codes(b)).abs()


def k1_bf16_check(label, launch, plain, f, idx, w):
    """One launch of K1's bf16 form against its plain version: every output
    within one bf16 ulp of the plain one (bit patterns at most one apart,
    so |err| <= 2^-7 |ref|: both round an f32 sum of the same exact
    products, summed in another order) or within 1e-6 of it, and a second
    launch that must give the same bits. Returns (output, plain output, max
    abs err, outputs one ulp apart, outputs past 2^-8 |ref| + 1e-6)."""
    out = launch(f, idx, w)
    again = launch(f, idx, w)
    ref = plain(f, idx, w)
    torch.cuda.synchronize()
    check(out.dtype == ref.dtype == torch.bfloat16,
          f"{label}: outputs {out.dtype}, {ref.dtype}, expected bf16")
    diff = (out.float() - ref.float()).abs()
    err = diff.max().item() if out.numel() else 0.0
    ulps = bf16_ulps(out, ref)
    far = ~((ulps <= 1) | (diff <= 1e-6))
    check(torch.isfinite(out).all(), f"{label}: non-finite output")
    check(not far.any(), f"{label}: {int(far.sum())} outputs more than one "
          f"bf16 ulp from the plain version (max abs err {err})")
    check(torch.equal(out, again), f"{label}: a repeat launch differs")
    half = int((diff > 2.0 ** -8 * ref.float().abs() + 1e-6).sum())
    return out, ref, err, int((ulps == 1).sum()), half


def k1_edge_cases(launch, plain, check_fn=k1_check, dtype=torch.float32):
    """K1 against its plain version where the v2 design breaks first: Cin
    5 (padded to 8, 4-byte row copies) and 12 (padded to 16), Cin 72, 96
    and 128 (the widest instantiations, at each column-block width), Cout 6
    (4-byte W copies), Cout 8 and 12 (a partial m16 slice), Cout 128 (two
    column blocks), N_out not a multiple of the 64-row tile, N_out > N_in +
    1, an all-miss plan, a tile with a single hit (row, tap), and B = 2
    with different occupancies. Each repeat launch must give the same
    bits. `check_fn` and `dtype` (the table's and weights'): `k1_check` and
    f32, or `k1_bf16_check` and bf16 for the bf16 form (where Cin 5 and 12
    take element copies, padded to 16, and Cout 6 and 12 too)."""
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
        f = torch.randn(b, n_in, cin, device="cuda", generator=g).to(dtype)
        w = (torch.randn(k, cin, cout, device="cuda", generator=g)
             * 0.3).to(dtype)
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
        out = check_fn(label, launch, plain, f, idx, w)[0]
        if shares == (0.0,):
            check(not out.any(), f"{label}: an all-miss plan gave non-zeros")
    log(f"K1 edge cases, {dtype} (Cin 5, 12, 72, 96 and 128, Cout 6, 8, 12 "
        "and 128, "
        "N_out not a multiple of 64, N_out > N_in + 1, all-miss, a single "
        "hit, B = 2 with different occupancies): agree with the plain "
        "version, and repeat launches give the same bits")


def capture_k1(model, cfg, frame, dev, infer_fn=None, bf16=None):
    """The (features, gather_idx, weights) of every K1 launch of one
    `infer_fn` (default `entry.infer`) of `frame`, cloned as the wrapper was
    given them; with a list `bf16`, the launches of K1's bf16 form are
    appended to it the same way."""
    from df3d_torch.entry import infer
    from df3d_torch.ops import sparse_conv_kernel as K

    infer_fn = infer_fn or infer

    captured = []
    launch, launch_bf16 = K.sparse_conv_cuda, K.sparse_conv_bf16_cuda

    def recording(into, fn):
        def wrapped(features, gather_idx, weights):
            into.append((features.clone(), gather_idx.clone(),
                         weights.clone()))
            return fn(features, gather_idx, weights)
        return wrapped

    pts = torch.from_numpy(frame[None]).to(dev)
    valid = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
    K.sparse_conv_cuda = recording(captured, launch)
    if bf16 is not None:
        K.sparse_conv_bf16_cuda = recording(bf16, launch_bf16)
    try:
        infer_fn(model, cfg, pts, valid)
    finally:
        K.sparse_conv_cuda, K.sparse_conv_bf16_cuda = launch, launch_bf16
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
    the wall time and the kernels that take the most device time. Returns
    (wall ms, device kernel ms)."""
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
    return wall_ms, busy_ms


def timed_path(label, run, n_boxes, inputs, n_frames, per_frame,
               box_dim=9, stats=None):
    """`run(*inputs[i])` on full-width frames: one warm-up pass over the
    inputs, then `n_frames` timed frames with every kernel's launch count
    set to 0 just before and read just after; `per_frame` maps each kernel
    module (its `launches`), or a (module, count attribute) pair such as
    K1's `bf16_launches`, to the launches a frame must make, and each
    frame's detections
    must hold `n_boxes` finite boxes. Prints ms/frame, launches, peak
    memory, overflows and kept boxes (those marked valid where the decode
    marks them), then a host-clock stage split and a one-frame profile of
    inputs[0]. Boxes are `box_dim` wide. Returns the launch counts; a
    `stats` dict gets the mean ms/frame, peak GiB, the split and the
    profile's wall and device-kernel ms and idle share."""
    from df3d_torch.utils import stages

    for args in inputs:
        run(*args)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    counters = {c: c if isinstance(c, tuple) else (c, "launches")
                for c in per_frame}
    names = {c: f"{mod.SOURCE}{'' if attr == 'launches' else ' ' + attr}"
             for c, (mod, attr) in counters.items()}
    for mod, attr in counters.values():
        setattr(mod, attr, 0)
    per_frame_ms, dets = [], []
    for i in range(n_frames):
        t0 = time.perf_counter()
        det, overflow = run(*inputs[i % len(inputs)])
        torch.cuda.synchronize()
        per_frame_ms.append(1e3 * (time.perf_counter() - t0))
        dets.append((det, overflow))
    launches = {c: getattr(*counters[c]) for c in per_frame}
    peak = torch.cuda.max_memory_allocated()

    for kernel, want in per_frame.items():
        check(launches[kernel] == want * n_frames,
              f"{label}: {names[kernel]} launched {launches[kernel]} times "
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
        + ", ".join(f"{names[k]} {v} ({v // n_frames} per frame)"
                    for k, v in launches.items())
        + f"; peak memory {peak / 2**30:.3f} GiB")
    for i, (det, overflow) in enumerate(dets[:len(inputs)]):
        kept = int(det["valid"].sum()) if "valid" in det else n_boxes
        log(f"{label} frame {i}: kept boxes {kept}; cap "
            "overflow " + ", ".join(f"{k}={int(v.sum())}"
                                    for k, v in overflow.items()))
    with torch.no_grad(), stages.recording() as split:
        run(*inputs[0])
    log(f"{label} stage split (ms, host clock, synchronised; one more "
        f"frame, apart from the timed ones, total "
        f"{sum(split.values()):.3f}): "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))
    wall_ms, busy_ms = profile_frame(lambda: run(*inputs[0]))
    if stats is not None:
        stats.update(ms=float(np.mean(per_frame_ms)), peak_gib=peak / 2**30,
                     split=dict(split), wall_ms=wall_ms, busy_ms=busy_ms,
                     idle=max(0.0, 1 - busy_ms / wall_ms))
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
    from df3d_torch.entry import small_cfg
    from df3d_torch.config.presets import centerpoint_3ddf_nusc, fused_config

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
    from df3d_torch.config.presets import centerpoint_3ddf_nusc, fused_config

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
    from df3d_torch.entry import small_cfg
    from df3d_torch.config.presets import transfusion_l_nusc

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
        build_transfusion3ddf, infer_transfusion_fused, random_points,
    )
    from df3d_torch.config.presets import fused_config, transfusion_3ddf_nusc

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
    from df3d_torch.config.presets import fused_config, transfusion_3ddf_nusc

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


def compare_train_step(label, ref, got, strict, exact=None):
    """Hold one step's (logs, gradients, state dict) against the
    reference's, with `phase_small_train`'s tolerances for its first run
    (`strict`) or its second, and print how far the gradient leaves are
    from it. `exact`: the reference's step in f64 (its gradients by name);
    a strict leaf's tolerance then also takes twice the reference's own
    f32 error, max|ref - exact|, so that the card may lie as far from the
    exact step as the reference does, on the other side. Where the
    reference's f32 is exact to phase 14's tolerance, that stays the
    tolerance."""
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
            if exact is not None:
                tol += 2 * (c.double() - exact[name]).abs().max().item()
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


def training_frame(seed):
    """The ray-cast frame of `seed` (`raycast_frame`) for the phases that
    train on it."""
    return raycast_frame(seed)


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
    )
    from df3d_torch.config.presets import transfusion_l_nusc
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
def transfusion_decisions(store, replay, peaks=False):
    """Patch TransFusion's head: record the queries' top-k indices and the
    Hungarian matches of each call in `store`, in call order; or, with
    `replay`, give each call the recorded indices or matches where its own
    differ. A replay is a near tie on this device: the top-k scores, or
    the batch's summed assignment costs, of the two choices lie within
    `gap` of each other (the caller bounds it). With `peaks` the heatmap's
    peak test (`local_peaks`) is recorded and replayed too, its gap the
    largest |heat - window max| of a cell whose test flips. Yields the
    replays, (kind, entries that differ, gap) per call that had any."""
    import torch.nn.functional as F
    from df3d_torch.models.heads import transfusion_head as H

    top_k, match, replays = H.top_k_stable, H.hungarian_match, []
    local_peaks = H.local_peaks
    recorded = iter(store)

    def recording_peaks(heatmap, cfg):
        got = local_peaks(heatmap, cfg)
        if not replay:
            store.append(got.cpu())
            return got
        want = next(recorded).to(got.device)
        if torch.equal(want, got):
            return got
        k = cfg.nms_kernel_size
        window = F.max_pool2d(heatmap, k, stride=1, padding=k // 2)
        flips = want != got
        replays.append(("peaks", int(flips.sum()),
                        float((window - heatmap).abs()[flips].max())))
        return want

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
    if peaks:
        H.local_peaks = recording_peaks
    try:
        yield replays
    finally:
        H.top_k_stable, H.hungarian_match = top_k, match
        H.local_peaks = local_peaks


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
                           k1_counts=(K1_PER_FRAME, K1_BWD_PER_STEP),
                           relu_limit=None, witness_f64=False):
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
    K1 must launch `k1_counts` times forward and backward. `relu_limit`
    (the CPU's recorded masks -> the ReLU replays allowed) stands for the
    4 where a config is larger than the CPU tests' (`relu_flip_limit`).
    With `witness_f64` the CPU also takes the step in f64 on the same
    batch, replaying its f32 decisions; both f32 steps' distances from it
    are printed, and the strict comparison takes it as `exact`
    (`compare_train_step`)."""
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
        limit = 4 if relu_limit is None else relu_limit(masks)
        check(sum(n for n, _ in flips) <= limit
              and all(z < 1e-4 for _, z in flips),
              f"{label} on {d}: more than {limit} ReLU inputs disagree with "
              f"the CPU's, or one lies more than 1e-4 from 0: {flips}")
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

    def run_f64():
        state, step = build_trainer("cpu")
        state.model.double()

        def f64(t):
            return t.double() if t.is_floating_point() else t
        with relu_decisions(masks, True) as flips, \
                decisions(picks, True) as replays:
            _, grads = step.grads(
                state, {k: f64(v) for k, v in batch("cpu").items()},
                **{k: f64(v) for k, v in (grads_kwargs or {}).items()})
        limit = 4 if relu_limit is None else relu_limit(masks)
        check(sum(n for n, _ in flips) <= limit
              and all(z < 1e-4 for _, z in flips)
              and all(gap < 1e-4 for *_, gap in replays),
              f"{label} in f64: the f32 step's decisions are no near ties "
              f"of the f64 step: {flips}, {replays}")
        log(f"{label} in f64 on the CPU: {sum(n for n, _ in flips)} ReLU "
            f"decisions taken from the f32 step's, decision replays "
            f"{replays}")
        return dict(zip(state.param_names, grads))

    def off_exact(grads, exact):  # in units of phase 14's tolerance
        rel = sorted((((grads[k].double() - e).abs().max()
                       / (1e-4 * e.abs().max() + 1e-5)).item(), k)
                     for k, e in exact.items())[::-1]
        return ", ".join(f"{k} {r:.3g}" for r, k in rel[:3])

    cpu = run("cpu", replay=False)
    exact = run_f64() if witness_f64 else None
    body, fwd, bwd = S._conv_body, K2.msda_cuda, K2.msda_bwd_cuda
    S._conv_body = lambda f, idx, w, dx=False: K.sparse_conv_plain(f, idx, w)
    K2.msda_cuda, K2.msda_bwd_cuda = K2.msda_plain, K2.msda_bwd_plain
    torch.backends.cudnn.enabled = False
    try:
        card_plain = run(dev, replay=True)
    finally:
        S._conv_body, K2.msda_cuda, K2.msda_bwd_cuda = body, fwd, bwd
        torch.backends.cudnn.enabled = True
    if exact is not None:
        log(f"{label}: max|f32 - f64| / (1e-4 max|f64| + 1e-5) over the "
            f"gradient leaves, largest: the CPU's {off_exact(cpu[1], exact)}"
            f"; the card's "
            f"(plain K1 and K2, no cuDNN) {off_exact(card_plain[1], exact)}")
    compare_train_step(f"{label}, plain K1 and K2, no cuDNN", cpu,
                       card_plain, strict=True, exact=exact)
    K.launches = K.bwd_launches = K2.launches = K2.bwd_launches = 0
    card = run(dev, replay=True)
    check(K.launches == k1_counts[0] and K.bwd_launches == k1_counts[1]
          and K2.launches == k2_per_step and K2.bwd_launches == k2_per_step,
          f"{label}: K1 launched {K.launches} forward and {K.bwd_launches} "
          f"backward, K2 {K2.launches} and {K2.bwd_launches}, expected "
          f"{k1_counts[0]}, {k1_counts[1]}, {k2_per_step} and "
          f"{k2_per_step}")
    compare_train_step(f"{label}, K1, K2 and cuDNN", cpu, card, strict=False)
    return cpu, card


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


def phase_small_fused_train(dev, aux=False):
    """One CenterPoint + 3D-DF training step of
    `entry.build_centerpoint3ddf_trainer` on the card against the same step
    on the CPU (`small_step_card_vs_cpu`): `small_fused_train_configs()` at
    batch 2, phase 14's points and gt layout, seeded normalized images and
    the rig of `utils.synth.camera_rig`, the same seeded weights; with
    `aux`, the step with the aux objectives (phase 44)."""
    from df3d_torch.entry import build_centerpoint3ddf_trainer

    cfg, fcfg = small_fused_train_configs()
    arrays, rng = small_train_arrays(2)
    return small_step_card_vs_cpu(
        "small fused train step" + (", aux" if aux else ""),
        lambda d: build_centerpoint3ddf_trainer(cfg, fcfg, d, seed=0,
                                                aux=aux),
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


def phase_small_transfusion_fused_train(dev, aux=False):
    """One TransFusion + 3D-DF training step of
    `entry.build_transfusion3ddf_trainer` on the card against the same step
    on the CPU, as phase 20, with the cameras of phase 17 (seeded
    normalized images, the rig) and the frozen ResNet + FPN branch; with
    `aux`, the step with the aux objectives (phase 44)."""
    from df3d_torch.entry import build_transfusion3ddf_trainer

    cfg, fcfg = small_transfusion_train_configs()
    arrays, rng = small_transfusion_train_arrays()
    return small_step_card_vs_cpu(
        "small TransFusion + 3D-DF train step" + (", aux" if aux else ""),
        lambda d: build_transfusion3ddf_trainer(cfg, fcfg, d, seed=0,
                                                aux=aux),
        fused_batch_fn(arrays, rng, fcfg), dev,
        k2_per_step=fcfg.actr.num_layers)


def full_fused_train_setup(dev, transfusion=False, with_batch=True,
                           aux=False, preset=None):
    """CenterPoint + 3D-DF at the `centerpoint_3ddf_nusc` preset's full
    width with `CenterPointConfig()`'s training caps (or TransFusion +
    3D-DF at `transfusion_3ddf_nusc`'s with `TransFusionConfig()`'s, or at
    another TransFusion `preset`'s), its trainer from seed 0 (with the aux
    objectives if `aux`), and (unless not `with_batch`: None)
    `full_train_batch` plus six random normalized 448x800 images per sample
    and the rig of `utils.synth.camera_rig`."""
    from df3d_torch.entry import (
        build_centerpoint3ddf_trainer, build_transfusion3ddf_trainer,
    )
    from df3d_torch.config.presets import (
        centerpoint_3ddf_nusc, fused_config, transfusion_3ddf_nusc,
    )

    transfusion = transfusion or preset is not None
    if preset is None:
        preset = (transfusion_3ddf_nusc() if transfusion
                  else centerpoint_3ddf_nusc())
    build = (build_transfusion3ddf_trainer if transfusion
             else build_centerpoint3ddf_trainer)
    cfg, fcfg = preset["lidar"], fused_config(preset)
    state, step = build(cfg, fcfg, dev, seed=0, aux=aux)
    if not with_batch:
        return cfg, fcfg, state, step, None
    return cfg, fcfg, state, step, full_fused_batch(dev, fcfg)


def full_fused_batch(dev, fcfg):
    """`full_train_batch` plus `TRAIN_BATCH` x `fcfg.num_cams` random
    normalized images and the rig of `utils.synth.camera_rig`."""
    from df3d_torch.utils.synth import camera_rig

    nc, hw = fcfg.num_cams, fcfg.image_shape
    batch = full_train_batch(dev)
    g = torch.Generator(device=dev).manual_seed(20)
    batch["images"] = torch.randn(TRAIN_BATCH, nc, *hw, 3, generator=g,
                                  device=dev)
    batch["proj"] = torch.from_numpy(np.broadcast_to(
        camera_rig(nc, hw), (TRAIN_BATCH, nc, 3, 4)).copy()).to(dev)
    return batch


def k2_bwd_check(label, launch, plain, value, shapes, locs, attn, grad):
    """One K2 backward launch against autograd of the plain version, and a
    repeat launch that must give the same bits in dvalue, dloc and dattn.
    Returns (max abs err, worst err / tolerance) over the three
    gradients."""
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
        check(torch.equal(g, a), f"{label}: a repeat launch's {name} differs")
        max_err, worst = max(max_err, err), max(worst, err / tol)
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


# the hot pixel case: queries whose every level-0 sample lands on one
# point, so each of its four corner rows (per head) gathers Q x P records
K2_HOT_QUERIES = 1100


def k2_bwd_hot_and_zero_cases(launch, plain, warp_path, d):
    """Two cases of K2's backward on both paths (nH 8, D `d`, P 4, L 3;
    the general path through an unaligned table, and always at D != 16):
    every level-0 sample of K2_HOT_QUERIES queries on one point (each of
    its corner rows summed from 4400 records of one head), and an all-zero
    cotangent (every gradient, dvalue included, must be exactly 0). Each
    against autograd of the plain version, bit for bit on repeat."""
    g = torch.Generator(device="cuda").manual_seed(5)
    h, w = K2_LEVELS[0]
    for offset, warp in ((0, d == 16), (1, False)):
        value, locs, attn = k2_inputs(g, 1, K2_HOT_QUERIES, 8, d, K2_LEVELS,
                                      4, (), offset)
        locs[:, :, :, 0] = torch.tensor([2.3 / w, 3.6 / h])
        path = "warp" if warp else "general"
        check(warp_path(value, K2_LEVELS, locs) == warp,
              f"K2 backward hot pixel: expected the {path} path")
        grad = torch.randn(1, K2_HOT_QUERIES, 8 * d, device="cuda",
                           generator=g)
        k2_bwd_check(f"K2 backward hot pixel, {path} path, D {d}", launch,
                     plain, value, K2_LEVELS, locs, attn, grad)
        zero = torch.zeros_like(grad)
        k2_bwd_check(f"K2 backward all-zero g, {path} path, D {d}", launch,
                     plain, value, K2_LEVELS, locs, attn, zero)
        check(not any(t.any() for t in launch(value, K2_LEVELS, locs, attn,
                                              zero)),
              f"K2 backward all-zero g, {path} path: a non-zero gradient")


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
    cotangent on query 5 (a masked query: its dloc and dattn must be 0).
    Then `k2_bwd_hot_and_zero_cases` at the cases' head width."""
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
    k2_bwd_hot_and_zero_cases(launch, plain, warp_path, cases[0][3])
    log(f"K2 backward edge cases ({summary}; samples on the last pixel "
        "centre, at -0.5 px, on exact integer pixel positions, far off the "
        "map, zero weights, a zero cotangent; then on both paths "
        f"{K2_HOT_QUERIES} queries' level-0 samples on one point, and an "
        "all-zero cotangent): agree with autograd of the plain version, "
        "repeat launches give the same dvalue, dloc and dattn bits")


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
                           caps_drop=False, timed_steps=TRAIN_TIMED_STEPS,
                           profile=True):
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
    printed); the frozen image branch unchanged. Prints ms/step
    (`timed_steps` of them), the host-clock split of one step, peak memory
    and (with `profile`) a one-step profile. Returns the launch counts,
    with the mean ms/step (`ms`), the peak (`peak_gib`), the split and the
    last step's logs."""
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
    for _ in range(timed_steps):
        t0 = time.perf_counter()
        logs = one_step()
        torch.cuda.synchronize()
        per_step.append(1e3 * (time.perf_counter() - t0))
    counts = dict(k1_fwd=K1.launches, k1_bwd=K1.bwd_launches,
                  k2_fwd=K2.launches, k2_bwd=K2.bwd_launches)
    peak = torch.cuda.max_memory_allocated()
    for name, want in (("k1_fwd", k1_counts[0]), ("k1_bwd", k1_counts[1]),
                       ("k2_fwd", k2_per_step), ("k2_bwd", k2_per_step)):
        check(counts[name] == want * timed_steps,
              f"{label}: {name} launched {counts[name]} times in "
              f"{timed_steps} steps, expected {want} a step")
    with stages.recording() as split:
        one_step()
    if profile:
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
        f"{timed_steps} timed steps after {TRAIN_WARMUP_STEPS}, ms/step "
        f"mean {np.mean(per_step):.3f} median {np.median(per_step):.3f} min "
        f"{np.min(per_step):.3f}; per step "
        f"{[round(x, 3) for x in per_step]}")
    log(f"{label}: launches per step K1 "
        f"{counts['k1_fwd'] // timed_steps} forward, "
        f"{counts['k1_bwd'] // timed_steps} backward; K2 "
        f"{counts['k2_fwd'] // timed_steps} forward, "
        f"{counts['k2_bwd'] // timed_steps} backward; peak memory "
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
    return dict(counts, ms=float(np.mean(per_step)), peak_gib=peak / 2**30,
                split=dict(split), logs={k: float(v) for k, v in logs.items()})


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
def voxelrcnn_decisions(store, replay, head_module=None):
    """Patch Voxel R-CNN's decisions, the proposal and final NMS and the
    RoI head's two-stage neighbour search (as `head_module` names them:
    default `voxelrcnn_head`, PV-RCNN's `pv_rcnn`): record each call's
    integer outputs in `store`, in call order; or, with `replay`, give
    each call the recorded outputs where its own differ. A replay is a
    near tie on this device (`_nms_gap`, `_collect_gap`, `_ball_gap`:
    within 1e-4; the caller bounds it). Yields the replays, (kind, entries
    that differ, gap) per call that had any."""
    from df3d_torch.models.detectors import voxel_rcnn as V
    from df3d_torch.models.heads import voxelrcnn_head as H

    H = head_module or H
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
    from df3d_torch.config.presets import fused_config, voxel_rcnn_3ddf_kitti
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
        build_voxelrcnn, build_voxelrcnn3ddf, infer_voxelrcnn,
        infer_voxelrcnn_fused,
    )
    from df3d_torch.config.presets import (
        fused_config, voxel_rcnn_3ddf_kitti, voxel_rcnn_car_kitti,
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


def kitti_train_decisions(store, replay):
    """`proposal_decisions` of the training step's proposals
    (`train.trainer.proposal_layer`): they carry no gradient, so the
    second stage reads them as an input; the card's held within 1e-4 *
    max + 1e-5 (the RoIs' coordinates reach 70 m, and the card's rounding
    moves them by more than the tight tolerance of the second stage's
    gradients allows)."""
    from df3d_torch.train import trainer as T

    return proposal_decisions(store, replay, T)


@contextlib.contextmanager
def proposal_decisions(store, replay, module, rel=1e-4, floor=1e-5):
    """`voxelrcnn_decisions` (the proposal NMS and the RoI head's neighbour
    searches, near ties replayed) and the proposals themselves, as
    `module.proposal_layer` gives them: with `replay` each call returns
    the recorded proposals, after its own roi_mask is checked equal to
    them and its RoIs and scores within `rel` * max + `floor`."""
    if not store:  # the searches' decisions, and the proposals
        store.extend([[], []])
    propose, recorded = module.proposal_layer, iter(store[1])

    def proposals(*args, **kwargs):
        got = propose(*args, **kwargs)
        if not replay:
            store[1].append(tuple(t.cpu() for t in got))
            return got
        want = tuple(t.to(g.device, g.dtype)
                     for t, g in zip(next(recorded), got))
        check(torch.equal(got[2], want[2]), "the card's roi_mask differs")
        for g, w in zip(got[:2], want[:2]):
            tol = rel * w.abs().max().item() + floor
            err = (g - w).abs()
            at = np.unravel_index(int(err.argmax()), tuple(err.shape))
            check(err.max().item() <= tol,
                  "the card's proposals differ from the CPU's beyond "
                  f"{tol}: {err.max().item()} at {at}, {g[at[:2]].tolist()}"
                  f" against {w[at[:2]].tolist()}")
        return want

    with voxelrcnn_decisions(store[0], replay) as replays:
        module.proposal_layer = proposals
        try:
            yield replays
        finally:
            module.proposal_layer = propose


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


def phase_small_kitti_train(dev, aux=False):
    """Both KITTI training steps (`entry.build_voxelrcnn_trainer`,
    `build_voxelrcnn3ddf_trainer`) on a small input, card against CPU
    (`small_step_card_vs_cpu`, `kitti_train_decisions`): the configs of
    the CPU tests at batch 2, 300 seeded points a sample, gts near the
    first stage's proposals, a seeded normalized 64x96 image and KITTI's
    camera scaled to it, the same RoI sampler noise on both devices; the
    fused step's attention kernels at flax's initial zeros
    (`flax_initial_attention`). With `aux`, the fused step only, with the
    aux objectives (phase 44). Returns the last step's records."""
    from df3d_torch.entry import (
        build_voxelrcnn3ddf_trainer, build_voxelrcnn_trainer,
    )

    lidar, fused, fcfg = small_kitti_train_configs()
    noise = torch.rand(KITTI_TRAIN_BATCH, lidar.train_post_nms,
                       generator=torch.Generator().manual_seed(5)) * 1e-3
    cases = [("small KITTI train step",
              lambda d: build_voxelrcnn_trainer(lidar, d, seed=0), 0),
             ("small KITTI fused train step",
              lambda d: flax_initial_attention(
                  build_voxelrcnn3ddf_trainer(fused, fcfg, d, seed=0)), 1)]
    if aux:
        cases = [("small KITTI fused train step, aux",
                  lambda d: flax_initial_attention(
                      build_voxelrcnn3ddf_trainer(fused, fcfg, d, seed=0,
                                                  aux=True)), 1)]
    for label, build, k2 in cases:
        state, step = build("cpu")
        cpu = small_kitti_train_batch(bool(k2), fcfg)
        boxes, classes, valid = gts_near_proposals(state, step, cpu)
        del state, step
        cpu.update(gt_boxes=torch.from_numpy(boxes),
                   gt_classes=torch.from_numpy(classes),
                   gt_valid=torch.from_numpy(valid))
        records = small_step_card_vs_cpu(
            label, build, lambda d, cpu=cpu: {k: v.to(d)
                                              for k, v in cpu.items()},
            dev, k2_per_step=k2, decisions=kitti_train_decisions,
            grads_kwargs={"noise": noise},
            k1_counts=(K1_PER_KITTI_FRAME, K1_BWD_PER_KITTI_STEP))
    return records


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
        build_voxelrcnn3ddf_trainer, build_voxelrcnn_trainer,
    )
    from df3d_torch.config.presets import (
        fused_config, voxel_rcnn_3ddf_kitti, voxel_rcnn_car_kitti,
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
# phase 46: the fused ones with the aux objectives
AUX_DP_STEPS = ("CenterPoint + 3D-DF, aux", "TransFusion + 3D-DF, aux",
                "Voxel R-CNN + 3D-DF, aux")


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

    aux = name.endswith(", aux")
    name = name.removesuffix(", aux")
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
        built = entry.build_centerpoint3ddf_trainer(cfg, fcfg, dev, seed=0,
                                                    aux=aux)
        batch = fused_batch_fn(arrays, rng, fcfg)("cpu")
    elif name == "TransFusion-L":
        cfg, _ = small_transfusion_train_configs()
        built = entry.build_transfusion_trainer(cfg, dev, seed=0)
        batch = train_batch(*arrays, "cpu")
    elif name == "TransFusion + 3D-DF":
        cfg, fcfg = small_transfusion_train_configs()
        built = entry.build_transfusion3ddf_trainer(cfg, fcfg, dev, seed=0,
                                                    aux=aux)
        batch = fused_batch_fn(arrays, rng, fcfg)("cpu")
    else:
        lidar, fused, fcfg = small_kitti_train_configs()

        def build(d):
            if name == "Voxel R-CNN":
                return entry.build_voxelrcnn_trainer(lidar, d, seed=0)
            return flax_initial_attention(
                entry.build_voxelrcnn3ddf_trainer(fused, fcfg, d, seed=0,
                                                  aux=aux))

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


def dp_small_rank(rank, world, init_method, names=SMALL_DP_STEPS,
                  tag="small"):
    """A rank of phase 34 (or 46: `names` and the files' `tag`): each
    small step over the ranks on this rank's sample
    (`DataParallelTrainStep`), the one-process step's ReLU and path
    decisions replayed on its rows; saves what it computed."""
    from df3d_torch.parallel import ddp
    from df3d_torch.train.trainer import DataParallelTrainStep

    f32_backends()
    dev = ddp.init_data_parallel(rank, world, backend="gloo",
                                 init_method=init_method, device="cuda:0")
    try:
        for i, name in enumerate(names):
            (state, step), batch, decisions, args = small_dp_case(name, dev)
            rec = torch.load(DP_DIR / f"{tag}{i}.pt")
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
                       DP_DIR / f"{tag}{i}_rank{rank}.pt")
    finally:
        torch.distributed.destroy_process_group()


def spawn_ranks(fn, *args):
    """fn(rank, DP_WORLD, init_method, *args) in `DP_WORLD` new processes,
    which meet through a file under build/dp/."""
    store = DP_DIR / "store"
    store.unlink(missing_ok=True)
    torch.multiprocessing.spawn(fn, nprocs=DP_WORLD,
                                args=(DP_WORLD, f"file://{store}", *args))


def phase_small_dp_train(dev, names=SMALL_DP_STEPS, tag="small"):
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
    same bits. Phase 46 runs the fused ones with the aux objectives
    (`names` AUX_DP_STEPS, files tagged "aux")."""
    DP_DIR.mkdir(parents=True, exist_ok=True)
    refs = []
    for i, name in enumerate(names):
        (state, step), batch, decisions, args = small_dp_case(name, dev)
        masks, picks = [], []
        with relu_decisions(masks, False), decisions(picks, False):
            logs, grads = step.grads(state, {k: v.to(dev) for k, v in
                                             batch.items()}, *args)
        step.apply(state, grads)
        refs.append(step_record(state, logs, grads))
        torch.save({"relu": masks, "picks": picks}, DP_DIR / f"{tag}{i}.pt")
        del state, step
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    spawn_ranks(dp_small_rank, names, tag)
    log(f"small data-parallel steps: 2 ranks on one card over gloo, "
        f"{time.perf_counter() - t0:.1f} s for the {len(names)} steps with "
        "the ranks' start")
    for i, name in enumerate(names):
        got = [torch.load(DP_DIR / f"{tag}{i}_rank{r}.pt")
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


def phase_profile_k1(model, cfg, frame, dev):
    """Phase 37: every K1 launch of one full-width CenterPoint frame in the
    "tpu_v5e" profile: the f32 ones as phase 4 holds them, the bf16 ones
    against the bf16 plain version within one bf16 ulp and bit for bit on
    repeat, after K1's edge cases in bf16; per bf16 launch its times, the
    plain version's and its bound (`k1_bf16_table`). Returns the `kernels`
    entry of K1's bf16 form."""
    from df3d_torch.ops import sparse_conv_kernel as K

    bf16 = []
    f32 = capture_k1(model, cfg, frame, dev, bf16=bf16)
    check(len(f32) == K1_F32_PER_PROFILE_FRAME
          and len(bf16) == K1_BF16_PER_FRAME,
          f"tpu_v5e frame: K1 launched {len(f32)} f32 and {len(bf16)} bf16, "
          f"expected {K1_F32_PER_PROFILE_FRAME} and {K1_BF16_PER_FRAME}")
    check(all(f.shape[-1] < 32 for f, _, _ in f32)
          and all(f.shape[-1] >= 32 for f, _, _ in bf16),
          "tpu_v5e frame: a conv took the form of the other side of the "
          "32-channel gate")
    for i, (f, idx, w) in enumerate(f32):
        k1_check(f"tpu_v5e f32 launch {i}", K.sparse_conv_cuda,
                 K.sparse_conv_plain, f, idx, w)
    launch, plain = K.sparse_conv_bf16_cuda, K.sparse_conv_bf16_plain
    k1_edge_cases(launch, plain, k1_bf16_check, torch.bfloat16)
    return dict(name="K1_bf16", route="cuda",
                source="df3d_torch/csrc/sparse_conv.cu",
                replaces="df3d/ops/pallas/sparse_conv_kernel.py:42",
                library_ms=None, **k1_bf16_table(
                    f"a tpu_v5e frame ({len(f32)} f32 launches held as in "
                    "phase 4 first)", bf16))


def k1_bf16_table(label, launches):
    """K1's bf16 launches of one frame (`label`), each held against the
    bf16 plain version (`k1_bf16_check`) and timed: back-to-back and
    device time, the plain version's time and the bound: 2 bytes per
    table element the hits touch, per weight and per output, 4 per index,
    over HBM's rate, or 2 x hit pairs x Cin x Cout FLOP at the dense bf16
    peak, whichever is larger. Logs a row per launch; returns the frame's
    totals (ms, device_ms, plain_ms, bound_ms, bound_by, max_abs_err and
    the outputs one ulp from the plain ones)."""
    from df3d_torch.ops import sparse_conv_kernel as K

    launch, plain = K.sparse_conv_bf16_cuda, K.sparse_conv_bf16_plain
    log(f"K1 bf16 per launch of {label} (tolerance: one bf16 ulp of the "
        "plain version, or 1e-6; a repeat launch equals the first bit for "
        "bit). one_ulp = outputs one ulp from the plain version, past_half "
        "= outputs past 2^-8 |plain| + 1e-6; bound = max(bytes / 3.35 TB/s, "
        "FLOP / 989 TFLOP/s bf16):")
    log("  #  N_in    N_out  K  Cin Cout  hit_pairs  touched_rows  "
        "kernel_ms  device_ms plain_ms  bound_ms  bound_by   max_abs_err "
        "one_ulp past_half")
    rows, max_err = [], 0.0
    for i, (f, idx, w) in enumerate(launches):
        b, n_in, cin = f.shape
        k, _, cout = w.shape
        n_out = idx.shape[1] // k
        _, _, err, one_ulp, half = k1_bf16_check(
            f"{label}: bf16 launch {i}", launch, plain, f, idx, w)
        max_err = max(max_err, err)
        ms = cuda_ms(lambda: launch(f, idx, w), 20)
        dev_ms = device_ms(lambda: launch(f, idx, w), 20)
        plain_ms = cuda_ms(lambda: plain(f, idx, w), 5)
        work = k1_work(idx, n_in, k)
        touched = sum(int(torch.unique(r[(r >= 0) & (r < n_in)]).numel())
                      for r in idx)
        flops = 2.0 * work["pairs"] * cin * cout
        nbytes = (2.0 * (touched * cin + w.numel() + b * n_out * cout)
                  + 4.0 * idx.numel())
        t_ops, t_bytes = flops / BF16_FLOP_PER_S, nbytes / HBM_BYTES_PER_S
        bound_ms = 1e3 * max(t_ops, t_bytes)
        rows.append(dict(ms=ms, device_ms=dev_ms, plain_ms=plain_ms,
                         bound_ms=bound_ms, t_ops=t_ops, t_bytes=t_bytes,
                         flops=flops, nbytes=nbytes, one_ulp=one_ulp,
                         past_half=half, outputs=b * n_out * cout,
                         pairs=work["pairs"]))
        log(f"  {i:<2d} {n_in:<7d} {n_out:<6d} {k:<2d} {cin:<4d} {cout:<4d} "
            f"{work['pairs']:<10d} {touched:<13d} {ms:<10.4f} "
            f"{dev_ms:<9.4f} {plain_ms:<9.4f} {bound_ms:<9.5f} "
            f"{'operations' if t_ops >= t_bytes else 'bytes':<10} "
            f"{err:<11.3g} {one_ulp:<7d} {half}")
    total = {key: sum(r[key] for r in rows) for key in rows[0]}
    bound_by = "operations" if total["t_ops"] >= total["t_bytes"] else "bytes"
    log(f"K1 bf16 per {label}: {len(rows)} launches, kernel "
        f"{total['ms']:.4f} ms (device time {total['device_ms']:.4f} ms), "
        f"plain {total['plain_ms']:.4f} ms, bound {total['bound_ms']:.5f} ms "
        f"({bound_by}: {total['nbytes'] / 1e6:.3f} MB, "
        f"{total['flops'] / 1e9:.3f} GFLOP in {total['pairs']} hit pairs); "
        f"{total['one_ulp']} of {total['outputs']} outputs one ulp from the "
        f"plain version, {total['past_half']} past 2^-8 |plain| + 1e-6")
    return dict(max_abs_err=max_err, ms=total["ms"],
                plain_ms=total["plain_ms"], bound_ms=total["bound_ms"],
                bound_by=bound_by, device_ms=total["device_ms"],
                one_ulp=total["one_ulp"], past_half=total["past_half"],
                outputs=total["outputs"])


def phase_profile_small(dev):
    """Phase 38: phase 3 in the "tpu_v5e" profile: the small input on the
    card (K1's f32 and bf16 forms, cuDNN's dense tail on bf16-rounded
    operands) against the CPU (the plain versions), same weights, same
    tolerances, near ties replayed and counted. The count is not bounded
    here, only each replay's gap (1e-4): the random weights' heatmaps are
    flat (the pre-NMS top-k sorts all 256 cells of a task, most within
    1e-3 of sigmoid(-2.19)), and card and CPU round the bf16 features
    apart by an ulp here and there, which reorders scores within ~2e-5 of
    each other: 257 top-k and 16 NMS entries on an H100 80GB HBM3. The
    kept boxes' headings are printed and not held: a heading is the atan2
    of the rot map's two channels (held at 1e-3 with the other maps), so a
    short rot vector turns an ulp of bf16 into 0.023 rad (the largest on
    an H100 80GB HBM3)."""
    from df3d_torch.entry import (
        build_centerpoint, infer, random_points, small_cfg,
    )

    cfg = small_cfg()
    pts = torch.from_numpy(random_points(np.random.RandomState(0), 1, 2000))
    valid = torch.ones(pts.shape[:2], dtype=torch.bool)
    card_vs_cpu("small input, tpu_v5e",
                lambda d: build_centerpoint(cfg, d, seed=0,
                                            profile="tpu_v5e"),
                cfg, [pts, valid], infer, dev, max_replays=None,
                heading=False)


def phase_profile_paths(cfg, frames, dev):
    """Phase 39: full-width CenterPoint frames in "exact" and in "tpu_v5e"
    (one model each, the same weights) in one process, one after the
    other, each a `timed_path` (warm-up, timed frames with the launch
    counts set to 0 just before and read just after, the split, the
    one-frame profile, peak memory): K1 16 f32 launches a frame in
    "exact", 6 f32 and 10 bf16 in "tpu_v5e", K2 none. Then the two
    profiles' head maps of frame 0 against each other. Returns the bf16
    and f32 launches of the "tpu_v5e" run."""
    from df3d_torch.entry import build_centerpoint, infer
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1
    from df3d_torch.ops.voxelize import voxelize_batch

    models = {name: build_centerpoint(cfg, dev, seed=0, profile=name)
              for name in ("exact", "tpu_v5e")}
    want = {"exact": {K1: K1_PER_FRAME, (K1, "bf16_launches"): 0, K2: 0},
            "tpu_v5e": {K1: K1_F32_PER_PROFILE_FRAME,
                        (K1, "bf16_launches"): K1_BF16_PER_FRAME, K2: 0}}
    inputs = [(torch.from_numpy(f[None]).to(dev),
               torch.ones(1, len(f), dtype=torch.bool, device=dev))
              for f in frames]
    n_boxes = len(cfg.tasks) * cfg.nms_post_max_size
    counts = {"bf16": 0, "f32": 0}
    for name in ("exact", "tpu_v5e"):
        got = timed_path(f"CenterPoint {name}",
                         lambda *a, m=models[name]: infer(m, cfg, *a),
                         n_boxes, inputs, TIMED_FRAMES, want[name])
        if name == "tpu_v5e":
            counts["bf16"] += got[(K1, "bf16_launches")]
            counts["f32"] += got[K1]
    with torch.no_grad():
        res = voxelize_batch(*inputs[0], cfg.voxel_size, cfg.pc_range,
                             cfg.grid_size, cfg.max_voxels,
                             cfg.max_points_per_voxel)
        maps = [models[n](res.features, res.coords)[0]
                for n in ("exact", "tpu_v5e")]
    gaps = {k: max((b[k] - a[k]).abs().max().item() / a[k].abs().max().item()
                   for a, b in zip(*maps)) for k in maps[0][0]}
    log("tpu_v5e against exact, frame 0, max |diff| / max |exact| of each "
        "head map over the tasks: "
        + ", ".join(f"{k} {v:.3e}" for k, v in gaps.items()))
    return counts


# --- the evaluation path (phases 40-43): reference checkpoints imported,
# double-flip TTA at batch 4, recalibration and the metrics ---------------

K1_PER_TTA_FRAME = K1_PER_FRAME  # one batch-4 forward
K2_PER_TTA_FRAME = 1
TTA_TIMED_FRAMES = 5
BN_SUFFIXES = ("weight", "bias", "running_mean", "running_var")


def _taps_5d(w, layout):
    """Port taps (K, Cin, Cout) -> an spconv weight: v1 (kz, ky, kx, Cin,
    Cout) or v2 (Cout, kz, ky, kx, Cin); K is 27 (3x3x3) or 3 (3x1x1)."""
    kyx = 3 if w.shape[0] == 27 else 1
    w = w.reshape(3, kyx, kyx, *w.shape[1:])
    return w if layout == "v1" else w.permute(4, 0, 1, 2, 3).contiguous()


def _renamer(sd):
    """(out, bn, linear) helpers that copy port entries of `sd` into the
    reference dict `out` under reference names."""
    out = {}

    def bn(dst, src):
        for s in BN_SUFFIXES:
            out[f"{dst}.{s}"] = sd[f"{src}.{s}"]

    def copy(dst, src, suffixes=("weight", "bias"), fn=lambda w: w):
        for s in suffixes:
            if f"{src}.{s}" in sd:
                out[f"{dst}.{s}"] = fn(sd[f"{src}.{s}"]) if s == "weight" \
                    else sd[f"{src}.{s}"]

    return out, bn, copy


def _bev_neck(sd, out, bn, copy, src, dst_blocks, dst_deblocks, first,
              deblock0):
    """A BEVBackbone's blocks (conv at index `first`, bn after it, then
    every 3) and deblocks under reference names; `deblock0` maps the
    stride-1 deblock's port weight to the reference's layout."""
    for i in range(2):
        copy(f"{dst_blocks}.{i}.{first}", f"{src}.block{i}_in.conv")
        bn(f"{dst_blocks}.{i}.{first + 1}", f"{src}.block{i}_in.bn")
        for j in range(5):
            copy(f"{dst_blocks}.{i}.{first + 3 + 3 * j}",
                 f"{src}.block{i}_conv{j}.conv")
            bn(f"{dst_blocks}.{i}.{first + 4 + 3 * j}",
               f"{src}.block{i}_conv{j}.bn")
    copy(f"{dst_deblocks}.0.0", f"{src}.deblock0.conv", fn=deblock0)
    bn(f"{dst_deblocks}.0.1", f"{src}.deblock0.bn")
    copy(f"{dst_deblocks}.1.0", f"{src}.deblock1.deconv")
    bn(f"{dst_deblocks}.1.1", f"{src}.deblock1.bn")


def det3d_state_dict(sd):
    """A port CenterPoint's state dict under det3d's names, spconv v1: the
    reference checkpoint it would import from."""
    out, bn, copy = _renamer(sd)

    def cbr(dst, src):
        out[f"{dst}.0.weight"] = _taps_5d(sd[f"{src}.conv.weight"], "v1")
        bn(f"{dst}.1", f"{src}.bn")

    def block(dst, src):
        for c in ("conv1", "conv2"):
            out[f"{dst}.{c}.weight"] = _taps_5d(sd[f"{src}.{c}.weight"], "v1")
        bn(f"{dst}.bn1", f"{src}.bn1")
        bn(f"{dst}.bn2", f"{src}.bn2")

    cbr("backbone.conv_input", "backbone.conv_input")
    block("backbone.conv1.0", "backbone.res1a")
    block("backbone.conv1.1", "backbone.res1b")
    for s in (2, 3, 4):
        cbr(f"backbone.conv{s}", f"backbone.down{s}")
        block(f"backbone.conv{s}.3", f"backbone.res{s}a")
        block(f"backbone.conv{s}.4", f"backbone.res{s}b")
    cbr("backbone.extra_conv", "backbone.extra_conv")
    _bev_neck(sd, out, bn, copy, "neck.blocks", "neck.blocks",
              "neck.deblocks", 1, lambda w: w)
    copy("bbox_head.shared_conv.0", "head.shared_conv")
    bn("bbox_head.shared_conv.1", "head.shared_bn")
    t = 0
    while f"head.tasks.{t}.hm.out.weight" in sd:
        for name in ("reg", "height", "dim", "rot", "vel", "hm"):
            src, dst = f"head.tasks.{t}.{name}", f"bbox_head.tasks.{t}.{name}"
            copy(f"{dst}.0", f"{src}.convs.0")
            bn(f"{dst}.1", f"{src}.bns.0")
            copy(f"{dst}.3", f"{src}.out")
        t += 1
    return out


def mmdet3d_state_dict(sd):
    """A port TransFusion-L's state dict under mmdet3d's names (spconv v1,
    Conv1d weights (out, in, 1), the attention's packed in_proj)."""
    out, bn, copy = _renamer(sd)
    conv1d = lambda w: w[..., None]  # noqa: E731
    enc, me = "pts_middle_encoder", "middle_encoder"

    def cbr(dst, src):
        out[f"{dst}.0.weight"] = _taps_5d(sd[f"{src}.conv.weight"], "v1")
        bn(f"{dst}.1", f"{src}.bn")

    cbr(f"{enc}.conv_input", f"{me}.conv_input")
    for i, n in enumerate((3, 3, 3, 2)):
        t = f"{enc}.encoder_layers.encoder_layer{i + 1}"
        for j in range(n):
            if j == n - 1 and i != 3:
                cbr(f"{t}.{j}", f"{me}.stage{i}_down")
                continue
            for c in ("conv1", "conv2"):
                out[f"{t}.{j}.{c}.weight"] = _taps_5d(
                    sd[f"{me}.stage{i}_block{j}.{c}.weight"], "v1")
            for c in ("bn1", "bn2"):
                bn(f"{t}.{j}.{c}", f"{me}.stage{i}_block{j}.{c}")
    cbr(f"{enc}.conv_out", f"{me}.conv_out")
    _bev_neck(sd, out, bn, copy, "pts_backbone.blocks", "pts_backbone.blocks",
              "pts_neck.deblocks", 0, lambda w: w)
    h, src = "pts_bbox_head", "bbox_head"
    copy(f"{h}.shared_conv", f"{src}.shared_conv")
    copy(f"{h}.heatmap_head.0.conv", f"{src}.hm_conv0")
    bn(f"{h}.heatmap_head.0.bn", f"{src}.hm_bn")
    copy(f"{h}.heatmap_head.1", f"{src}.hm_conv1")
    copy(f"{h}.class_encoding", f"{src}.class_encoding", fn=conv1d)
    for dst, name in (("self_posembed", "query_pos_embed"),
                      ("cross_posembed", "key_pos_embed")):
        t = f"{h}.decoder.0.{dst}.position_embedding_head"
        copy(f"{t}.0", f"{src}.{name}.fc0", fn=conv1d)
        bn(f"{t}.1", f"{src}.{name}.bn")
        copy(f"{t}.3", f"{src}.{name}.fc1", fn=conv1d)
    for dst, name in (("self_attn", "self_attn"),
                      ("multihead_attn", "cross_attn")):
        a = f"{src}.decoder0.{name}"
        for s in ("weight", "bias"):
            out[f"{h}.decoder.0.{dst}.in_proj_{s}"] = torch.cat(
                [sd[f"{a}.{p}.{s}"] for p in ("query", "key", "value")])
        copy(f"{h}.decoder.0.{dst}.out_proj", f"{a}.out")
    for i in (1, 2, 3):
        copy(f"{h}.decoder.0.norm{i}", f"{src}.decoder0.norm{i}")
    for i in (1, 2):
        copy(f"{h}.decoder.0.linear{i}", f"{src}.decoder0.ff{i}")
    for dst, name in (("center", "center"), ("height", "height"),
                      ("dim", "dim"), ("rot", "rot"), ("vel", "vel"),
                      ("heatmap", "cls")):
        t = f"{h}.prediction_heads.0.{dst}"
        copy(f"{t}.0.conv", f"{src}.{name}_fc0", fn=conv1d)
        bn(f"{t}.0.bn", f"{src}.{name}_bn0")
        copy(f"{t}.1", f"{src}.{name}_fc1", fn=conv1d)
    return out


def mmdet_swin_state_dict(sd, depths, window=7):
    """A port Swin image branch's state dict (`image_branch.swin.*` and
    `image_branch.swin_fpn.*`) under mmdet's names (`img_backbone.*`,
    `img_neck.*`): PatchMerging's norm and reduction in mmdet's
    channel-major (C, 4) order, the relative position index buffers of a
    `window` checkpoint (mmdet saves them)."""
    from df3d_torch.models.image.swin import relative_index

    out, _, copy = _renamer(sd)
    s, p = "image_branch.swin", "img_backbone"
    copy(f"{p}.patch_embed.projection", f"{s}.patch_embed")
    copy(f"{p}.patch_embed.norm", f"{s}.patch_norm")
    for si, depth in enumerate(depths):
        for bi in range(depth):
            t, b = f"{p}.stages.{si}.blocks.{bi}", f"{s}.stage{si}_block{bi}"
            copy(f"{t}.norm1", f"{b}.norm1")
            copy(f"{t}.norm2", f"{b}.norm2")
            copy(f"{t}.attn.w_msa.qkv", f"{b}.attn.qkv")
            copy(f"{t}.attn.w_msa.proj", f"{b}.attn.proj")
            table = sd[f"{b}.attn.rel_bias"]
            out[f"{t}.attn.w_msa.relative_position_bias_table"] = table
            win = round((table.shape[0] ** 0.5 + 1) / 2)
            if win == window:
                out[f"{t}.attn.w_msa.relative_position_index"] = \
                    relative_index(win)
            copy(f"{t}.ffn.layers.0.0", f"{b}.mlp0")
            copy(f"{t}.ffn.layers.1", f"{b}.mlp1")
        copy(f"{p}.norm{si}", f"{s}.out_norm{si}")
        if si < len(depths) - 1:
            t = f"{p}.stages.{si}.downsample"
            w = sd[f"{s}.merge{si}.weight"]
            c = w.shape[1] // 4
            out[f"{t}.reduction.weight"] = w.reshape(-1, 4, c).transpose(
                1, 2).reshape(w.shape)
            for k in ("weight", "bias"):
                out[f"{t}.norm.{k}"] = sd[f"{s}.merge_norm{si}.{k}"].reshape(
                    4, c).T.reshape(-1)
    for i in range(len(depths)):
        copy(f"img_neck.lateral_convs.{i}.conv", f"{s}_fpn.lateral{i}")
        copy(f"img_neck.fpn_convs.{i}.conv", f"{s}_fpn.fpn{i}")
    return out


def mmdet_transfusion_swin_state_dict(model):
    """A port TransFusion + 3D-DF (Swin image branch) model's image branch
    and LiDAR detector under mmdet's names, as an mmdet TransFusion + Swin
    checkpoint holds them (no fusion hook)."""
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    det = {k.removeprefix("detector."): v for k, v in sd.items()
           if k.startswith("detector.") and ".fusion_hook." not in k}
    return {**mmdet3d_state_dict(det),
            **mmdet_swin_state_dict(sd, model.image_branch.swin.depths)}


def pcdet_state_dict(rpn_sd, head_sd):
    """A port Voxel R-CNN's two state dicts under pcdet's names, spconv v2,
    the RoI head's FC stacks with dropout between layers (voxel_rcnn_car's
    DP_RATIO 0.3: the next Linear 4 indices on)."""
    out, bn, copy = _renamer(rpn_sd)

    def cbr(dst, src):
        out[f"{dst}.0.weight"] = _taps_5d(rpn_sd[f"{src}.conv.weight"], "v2")
        bn(f"{dst}.1", f"{src}.bn")

    b3 = "backbone_3d"
    cbr(f"{b3}.conv_input", "backbone.conv_input")
    cbr(f"{b3}.conv1.0", "backbone.conv1")
    for s in (2, 3, 4):
        cbr(f"{b3}.conv{s}.0", f"backbone.down{s}")
        cbr(f"{b3}.conv{s}.1", f"backbone.conv{s}a")
        cbr(f"{b3}.conv{s}.2", f"backbone.conv{s}b")
    cbr(f"{b3}.conv_out", "backbone.conv_out")
    # pcdet's stride-1 deblock is a ConvTranspose2d (in, out, 1, 1)
    _bev_neck(rpn_sd, out, bn, copy, "neck.blocks", "backbone_2d.blocks",
              "backbone_2d.deblocks", 1, lambda w: w.permute(1, 0, 2, 3))
    for dst, src in (("conv_cls", "conv_cls"), ("conv_box", "conv_box"),
                     ("conv_dir_cls", "conv_dir")):
        copy(f"dense_head.{dst}", f"dense_head.{src}",
             fn=lambda w: w[..., None, None])
    head, hbn, hcopy = _renamer(head_sd)
    for k, key in enumerate(("conv2", "conv3", "conv4")):
        t = f"roi_head.roi_grid_pool_layers.{k}"
        hcopy(f"{t}.mlps_in.0.0", f"{key}_mlp_in", fn=lambda w: w[..., None])
        hbn(f"{t}.mlps_in.0.1", f"{key}_bn_in")
        hcopy(f"{t}.mlps_pos.0.0", f"{key}_mlp_pos",
              fn=lambda w: w[..., None, None])
        hbn(f"{t}.mlps_pos.0.1", f"{key}_bn_pos")
        hcopy(f"{t}.mlps_out.0.0", f"{key}_mlp_out", fn=lambda w: w[..., None])
        hbn(f"{t}.mlps_out.0.1", f"{key}_bn_out")
    for name, dst in (("shared", "shared_fc_layer"), ("cls", "cls_fc_layers"),
                      ("reg", "reg_fc_layers")):
        i = 0
        while f"{name}_fc{i}.weight" in head_sd:
            hcopy(f"roi_head.{dst}.{4 * i}", f"{name}_fc{i}")
            hbn(f"roi_head.{dst}.{4 * i + 1}", f"{name}_bn{i}")
            i += 1
    hcopy("roi_head.cls_pred_layer", "cls_pred")
    hcopy("roi_head.reg_pred_layer", "reg_pred")
    return {**out, **head}


def _source_models(family, cfg, seed):
    """The port modules a synthetic reference checkpoint is written from:
    random weights drawn from `seed`, on the CPU."""
    from df3d_torch.models.detectors.centerpoint import CenterPoint
    from df3d_torch.models.detectors.transfusion import TransFusionL
    from df3d_torch.models.detectors.voxel_rcnn import (
        VoxelRCNN, init_head_weights,
    )
    from df3d_torch.models.heads.voxelrcnn_head import VoxelRCNNHead

    g = torch.Generator().manual_seed(seed)
    if family == "det3d":
        return (CenterPoint(cfg).init_weights(g),)
    if family == "mmdet3d":
        return (TransFusionL(cfg).init_weights(g),)
    head = VoxelRCNNHead(cfg.rcnn, cfg.voxel_size, cfg.pc_range)
    return VoxelRCNN(cfg).init_weights(g), init_head_weights(head, g)


def write_reference_checkpoint(path, family, cfg, seed):
    """A synthetic reference .pth in `family`'s naming and wrapper (det3d:
    {'state_dict': ...}, spconv v1; mmdet3d: {'state_dict': ...} with DDP's
    'module.' prefix; pcdet: {'model_state': ...}, spconv v2), made from
    seeded random port weights. Returns the source modules' state dicts
    and the number of reference keys."""
    sources = [m.state_dict() for m in _source_models(family, cfg, seed)]
    if family == "det3d":
        ref = det3d_state_dict(*sources)
        ckpt = {"state_dict": ref, "meta": {"epoch": 20}}
    elif family == "mmdet3d":
        ref = mmdet3d_state_dict(*sources)
        ckpt = {"state_dict": {f"module.{k}": v for k, v in ref.items()}}
    else:
        ref = pcdet_state_dict(*sources)
        ckpt = {"model_state": ref, "epoch": 80}
    torch.save(ckpt, path)
    return sources, len(ref)


def check_imported(label, modules, sources):
    """Every entry of the built modules equals the source weights: the
    import filled each entry from its reference key (and, strict both
    ways, read every key)."""
    for module, src in zip(modules, sources):
        got = module.state_dict()
        check(sorted(got) == sorted(src), f"{label}: entries differ")
        for k, v in src.items():
            check(torch.equal(got[k].cpu(), v), f"{label}: {k} differs")


def phase_imported_weights(dev, frames, kitti_frame):
    """Phase 40: synthetic det3d, mmdet3d and pcdet checkpoints at the full
    widths of `centerpoint_nusc`, `transfusion_l_nusc` and
    `voxel_rcnn_car_kitti`, written with torch.save and built on the card
    through `entry.build_*(checkpoint=...)` (`load_torch_checkpoint` and
    the importers); each serves one full-width frame (K1 16, 16 and 12
    launches). Then each family at a small config from a small checkpoint,
    card against CPU as phases 3, 9 and 24. Returns K1's launches and the
    KITTI frame's detections."""
    import tempfile

    from df3d_torch.entry import (
        build_centerpoint, build_transfusion, build_voxelrcnn, infer,
        infer_transfusion, infer_voxelrcnn, random_points, small_cfg,
    )
    from df3d_torch.config.presets import (
        transfusion_l_nusc, voxel_rcnn_car_kitti,
    )
    from df3d_torch.models.detectors.centerpoint import CenterPointConfig
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1

    serve = {
        "det3d": (CenterPointConfig(max_voxels=REALISTIC_STAGE_CAPS[0],
                                    stage_caps=REALISTIC_STAGE_CAPS),
                  lambda cfg, d, p: (build_centerpoint(cfg, d, checkpoint=p),),
                  lambda ms, cfg, *a: infer(ms[0], cfg, *a), frames[0],
                  K1_PER_FRAME),
        "mmdet3d": (dataclasses.replace(transfusion_l_nusc(),
                                        max_voxels=REALISTIC_STAGE_CAPS[0],
                                        stage_caps=REALISTIC_STAGE_CAPS),
                    lambda cfg, d, p: (build_transfusion(cfg, d,
                                                         checkpoint=p),),
                    lambda ms, cfg, *a: infer_transfusion(ms[0], cfg, *a),
                    frames[0], K1_PER_FRAME),
        "pcdet": (voxel_rcnn_car_kitti(),
                  lambda cfg, d, p: build_voxelrcnn(cfg, d, checkpoint=p),
                  lambda ms, cfg, *a: infer_voxelrcnn(*ms, cfg, *a),
                  kitti_frame, K1_PER_KITTI_FRAME),
    }
    launches, dets = 0, {}
    with tempfile.TemporaryDirectory() as tmp:
        for i, (family, (cfg, build, run, frame, k1_want)) in enumerate(
                serve.items()):
            path = f"{tmp}/{family}.pth"
            t0 = time.perf_counter()
            sources, n_keys = write_reference_checkpoint(path, family, cfg,
                                                         40 + i)
            t1 = time.perf_counter()
            modules = build(cfg, dev, path)
            t2 = time.perf_counter()
            check_imported(f"imported {family}", modules, sources)
            pts = torch.from_numpy(frame[None]).to(dev)
            valid = torch.ones(pts.shape[:2], dtype=torch.bool, device=dev)
            K1.launches, K2.launches = 0, 0
            det, _ = run(modules, cfg, pts, valid)
            torch.cuda.synchronize()
            check(K1.launches == k1_want and K2.launches == 0,
                  f"imported {family}: K1 {K1.launches} launches (expected "
                  f"{k1_want}), K2 {K2.launches}")
            launches += K1.launches
            for k, t in det.items():
                check(not t.is_floating_point() or bool(torch.isfinite(t).all()),
                      f"imported {family}: non-finite {k}")
            dets[family] = to_cpu(det)
            log(f"imported {family} checkpoint ({n_keys} reference keys, "
                f"{Path(path).stat().st_size / 2**20:.1f} MiB): written in "
                f"{t1 - t0:.2f} s, loaded and imported onto the card in "
                f"{t2 - t1:.2f} s; every entry equals its source; one "
                f"full-width frame served with {K1.launches} K1 launches")

        # small configs, card against the CPU's plain path
        cfg = small_cfg()
        path = f"{tmp}/det3d_small.pth"
        write_reference_checkpoint(path, "det3d", cfg, 50)
        pts = torch.from_numpy(random_points(np.random.RandomState(0), 1,
                                             2000))
        valid = torch.ones(pts.shape[:2], dtype=torch.bool)
        card_vs_cpu("small input, imported det3d weights",
                    lambda d: build_centerpoint(cfg, d, checkpoint=path), cfg,
                    [pts, valid], infer, dev)
        tcfg = small_transfusion_config()
        tpath = f"{tmp}/mmdet3d_small.pth"
        write_reference_checkpoint(tpath, "mmdet3d", tcfg, 51)
        tpts = torch.from_numpy(random_points(np.random.RandomState(2), 1,
                                              2000))
        transfusion_card_vs_cpu(
            "small TransFusion-L input, imported mmdet3d weights",
            lambda d: build_transfusion(tcfg, d, checkpoint=tpath), tcfg,
            [tpts, valid], infer_transfusion, dev)
        kcfg, _ = small_kitti_configs()
        kpath = f"{tmp}/pcdet_small.pth"
        write_reference_checkpoint(kpath, "pcdet", kcfg, 52)
        rng = np.random.RandomState(0)
        kpts = np.concatenate([rng.uniform(0, 31, (1, 1500, 1)),
                               rng.uniform(-15, 15, (1, 1500, 1)),
                               rng.uniform(-1.8, 1.8, (1, 1500, 1)),
                               rng.uniform(0, 1, (1, 1500, 1))], -1)
        kpts = torch.from_numpy(kpts.astype(np.float32))
        kitti_card_vs_cpu(
            "small KITTI input, imported pcdet weights",
            lambda d: build_voxelrcnn(kcfg, d, checkpoint=kpath), kcfg,
            [kpts, torch.ones(1, 1500, dtype=torch.bool)], infer_voxelrcnn,
            dev)
    return launches, dets["pcdet"]


def tta_card_vs_cpu(dev):
    """Phase 41's small input: the double-flip TTA path on the card against
    the CPU's plain path (`card_vs_cpu`, near ties replayed), and the
    merged head maps of both to atol = rtol = 1e-3."""
    from df3d_torch.entry import (
        build_centerpoint, infer_double_flip, random_points, small_cfg,
    )
    from df3d_torch.models.tta import merge_center_head_maps

    cfg = small_cfg()
    merged = []

    def tta(model, cfg, *args):
        seen = []
        handle = model.head.register_forward_hook(
            lambda mod, inp, out: seen.append(out))
        try:
            out = infer_double_flip(model, cfg, *args)
        finally:
            handle.remove()
        merged.append(to_cpu(merge_center_head_maps(seen[0])))
        return out

    pts = torch.from_numpy(random_points(np.random.RandomState(4), 1, 2000))
    card_vs_cpu("small double-flip TTA input",
                lambda d: build_centerpoint(cfg, d, seed=0), cfg,
                [pts, torch.ones(pts.shape[:2], dtype=torch.bool)], tta, dev)
    worst = 0.0
    for c, g in zip(*merged):
        for k in c:
            torch.testing.assert_close(g[k], c[k], atol=1e-3, rtol=1e-3)
            worst = max(worst, (g[k] - c[k]).abs().max().item())
    log(f"small double-flip TTA input: merged head maps agree, max diff "
        f"{worst:.3g}")


def phase_tta_lidar(dev, cfg, frames):
    """Phase 41: `centerpoint_nusc` at full width, each 260k-point frame as
    its four flips in one batch-4 forward (`entry.infer_double_flip`, the
    serving caps per variant): every K1 launch of one TTA frame against the
    plain version and a repeat launch (phase 4's tolerance), timed with
    its bound; then TTA frames timed as phase 5 (K1 16 launches a frame).
    Returns K1's entry, the launches and each frame's detections."""
    from df3d_torch.entry import build_centerpoint, infer_double_flip
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1

    tta_card_vs_cpu(dev)
    model = build_centerpoint(cfg, dev, seed=0)
    k1 = phase_k1(model, cfg, frames[0], dev, infer_double_flip,
                  edge_cases=False, per_frame=K1_PER_TTA_FRAME)
    inputs = [(torch.from_numpy(f[None]).to(dev),
               torch.ones(1, len(f), dtype=torch.bool, device=dev))
              for f in frames]
    launches = timed_path(
        "double-flip TTA path", lambda *a: infer_double_flip(model, cfg, *a),
        len(cfg.tasks) * cfg.nms_post_max_size, inputs, TTA_TIMED_FRAMES,
        {K1: K1_PER_TTA_FRAME, K2: 0})
    dets = [to_cpu(infer_double_flip(model, cfg, *a)[0]) for a in inputs]
    return k1, launches, dets


def phase_tta_fused(dev, frames):
    """Phase 42: `centerpoint_3ddf_nusc` at full width with double-flip
    TTA: six 448x800 cameras repeated for the four flips (24 images), each
    variant's reflection composed into its projections. K2's one launch of
    a TTA frame must take the warp path at B = 4 and agree with the plain
    version as in phase 7; K1 launches 16 times; then TTA frames timed
    (K1 16, K2 1 a frame). Returns K2's entry and the launches."""
    from df3d_torch.entry import build_centerpoint3ddf, infer_double_flip
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1

    cfg, fcfg = full_fused_configs()
    model = build_centerpoint3ddf(cfg, fcfg, dev, seed=0)
    inputs = [fused_inputs(f, fcfg.num_cams, fcfg.image_shape, dev, 10 + i)
              for i, f in enumerate(frames)]
    k2 = phase_k2(model, cfg, inputs[0], infer_double_flip,
                  K2_PER_TTA_FRAME, edge_cases=False,
                  k1_per_frame=K1_PER_TTA_FRAME)
    launches = timed_path(
        "fused double-flip TTA path",
        lambda *a: infer_double_flip(model, cfg, *a),
        len(cfg.tasks) * cfg.nms_post_max_size, inputs, FUSED_TIMED_FRAMES,
        {K1: K1_PER_TTA_FRAME, K2: K2_PER_TTA_FRAME})
    return k2, launches


def phase_recalibrate(dev):
    """Phase 43, first part: `recalibrate_batch_stats` on the small
    CenterPoint (one training-mode forward of two samples), card against
    CPU: every norm's statistics to 1e-3 x max(1, |CPU|) (the inversion
    divides the forward's rounding by 1 - 0.99), and moved from where they
    started."""
    from df3d_torch.entry import build_centerpoint, random_points, small_cfg
    from df3d_torch.models.layers import FlaxBatchNorm, MaskedBatchNorm
    from df3d_torch.ops.voxelize import voxelize_batch
    from df3d_torch.train.trainer import recalibrate_batch_stats

    cfg = small_cfg()
    pts = torch.from_numpy(random_points(np.random.RandomState(5), 2, 2000))
    stats = []
    for d in ("cpu", dev):
        model = build_centerpoint(cfg, d, seed=0)
        res = voxelize_batch(pts.to(d), torch.ones(2, 2000, dtype=torch.bool,
                                                   device=d),
                             cfg.voxel_size, cfg.pc_range, cfg.grid_size,
                             cfg.max_voxels, cfg.max_points_per_voxel)
        norms = {n: m for n, m in model.named_modules()
                 if isinstance(m, (MaskedBatchNorm, FlaxBatchNorm))}
        before = {n: m.running_var.cpu().clone() for n, m in norms.items()}
        recalibrate_batch_stats(model,
                                lambda: model(res.features, res.coords))
        check(not model.training, "recalibration left the model training")
        stats.append({n: (m.running_mean.cpu(), m.running_var.cpu())
                      for n, m in norms.items()})
    worst, moved = 0.0, 0
    for name, (mean, var) in stats[0].items():
        for c, g in zip((mean, var), stats[1][name]):
            err = (g - c).abs().max().item()
            scale = max(1.0, c.abs().max().item())
            check(err <= 1e-3 * scale, f"recalibration {name}: card and CPU "
                  f"differ by {err} (scale {scale})")
            worst = max(worst, err / scale)
        moved += int(not torch.equal(var, before[name]))
    check(moved == len(stats[0]), "recalibration left norms unmoved")
    log(f"recalibrate_batch_stats (small CenterPoint, {len(stats[0])} norms "
        f"at momentum 0.99): card vs CPU agree, max |diff| / max(1, |CPU|) "
        f"{worst:.3g}")


def kitti_calib():
    """A KITTI calib dict of the synthetic front camera
    (`utils.synth.kitti_camera`): P2 @ R0 @ V2C is its projection."""
    from df3d_torch.utils import synth

    rot = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    v2c = np.concatenate([rot, np.asarray(synth.KITTI_VELO_TO_CAM_T)[:, None]],
                         1)
    return {"P2": np.asarray(synth.KITTI_P2, np.float32),
            "R0": np.eye(3, dtype=np.float32),
            "V2C": v2c.astype(np.float32)}


def kitti_gt_sample(boxes, calib):
    """A KITTI sample record (raw annotations of cars in the camera frame,
    unoccluded and untruncated) of lidar boxes (N, 7)."""
    from df3d_torch.data.kitti import (
        lidar_boxes_to_kitti_annos, lidar_to_rect,
    )

    n = len(boxes)
    bottom = boxes[:, :3] - np.stack([np.zeros(n), np.zeros(n),
                                      boxes[:, 5] / 2], 1)
    annos = lidar_boxes_to_kitti_annos(boxes, np.ones(n), np.zeros(n, int),
                                       calib, KITTI_IMAGE, ("Car",))
    return {"calib": calib, "image_shape": KITTI_IMAGE, "gt_boxes": boxes,
            "annos_raw": {"name": np.asarray(["Car"] * n),
                          "location": lidar_to_rect(calib, bottom),
                          "dimensions": boxes[:, [3, 5, 4]],
                          "rotation_y": -boxes[:, 6] - np.pi / 2,
                          "bbox": annos["bbox"], "alpha": annos["alpha"],
                          "occluded": np.zeros(n), "truncated": np.zeros(n)}}


def kitti_perfect_ap(gt_annos, cls):
    """The R40 AP, in each difficulty, of detections that are the ground
    truth itself, all scores distinct: with n boxes that count in a
    difficulty (1 <= n <= 40), the precision is 1 at recalls 1/n .. n/n
    and R40 takes the samples 1..n-1 of its 40, so AP = (n - 1) / 40 * 100
    (0 for no box). The counts follow KITTI's buckets (bbox height above
    the minimum, occlusion and truncation at most the maximum)."""
    from df3d_torch.data.kitti_eval import DIFFICULTY

    out = []
    for d in range(3):
        min_h, max_occ, max_trunc = DIFFICULTY[d]
        n = 0
        for a in gt_annos:
            h = a["bbox"][:, 3] - a["bbox"][:, 1]
            k = len(a["name"])
            occ = a.get("occluded", np.zeros(k))
            trunc = a.get("truncated", np.zeros(k))
            n += int(np.sum((a["name"] == cls) & (h > min_h)
                            & (occ <= max_occ) & (trunc <= max_trunc)))
        if n > 40:
            raise ValueError(f"{n} boxes: more than R40's samples")
        out.append(max(n - 1, 0) / 40.0 * 100.0)
    return out


def phase_metrics(tta_dets, kitti_det, kitti_boxes):
    """Phase 43, second part: nuScenes mAP/NDS of phase 41's TTA frames
    against their scenes' boxes and KITTI's APs and recall of phase 40's
    KITTI frame against its cars (random weights: the numbers show the
    path runs, not an accuracy); then the ground truth scored as its own
    detections, which must give what the JAX package's tests assert
    (tests/test_nuscenes_eval.py::test_perfect_detections: mAP and NDS
    over 0.95, ATE under 0.01, AAE 0; tests/test_kitti_eval.py::
    test_perfect_detection_ap_high: moderate 3D and BEV AP over 95) on
    those tests' inputs; on this run's synthetic boxes, nuScenes' bounds
    and, for KITTI's few cars a frame, the exact R40 value of each
    difficulty's count (`kitti_perfect_ap`)."""
    from df3d_torch.data.kitti_eval import evaluate_kitti
    from df3d_torch.data.nuscenes_eval import NUSC_CLASSES, evaluate_nuscenes
    from df3d_torch.train.evaluate import (
        kitti_metrics, kitti_records, nuscenes_metrics, nuscenes_records,
    )

    gts, dets, gt_perfect = [], [], []
    classes = np.asarray(SCENE_CLASSES, np.int64)
    for i, det in enumerate(tta_dets):
        boxes = scene_boxes(100 + i)
        batch = {"gt_boxes": boxes[None], "gt_classes": classes[None],
                 "gt_valid": np.ones((1, len(boxes)), bool)}
        g, d = nuscenes_records(det, batch)
        gts += g
        dets += d
        gt_perfect.append(dict(g[0], attrs=np.zeros(len(boxes), np.int32)))
    m = nuscenes_metrics(gts, dets)
    log(f"nuScenes metric of {len(dets)} TTA frames "
        f"({sum(len(d['boxes']) for d in dets)} detections, random weights: "
        f"not an accuracy): mAP {m['mAP']:.4f}, NDS {m['NDS']:.4f}")
    own = [dict(g, scores=np.linspace(0.9, 0.5, len(g["boxes"])))
           for g in gt_perfect]
    res = evaluate_nuscenes(gt_perfect, own, NUSC_CLASSES)
    check(res["mAP"] > 0.95 and res["NDS"] > 0.95
          and res["tp_errors"]["trans_err"] < 0.01
          and res["tp_errors"]["attr_err"] < 1e-9,
          f"nuScenes: the scenes' boxes as their own detections: {res}")
    car = [10.0, 0.0, 0.0, 4.0, 2.0, 1.5, 0.3, 1.0, 0.0]
    ped = [5.0, 5.0, 0.0, 0.7, 0.7, 1.7, 0.0, 0.0, 0.0]
    frame = {"boxes": np.asarray([car, ped], np.float32),
             "names": np.asarray(["car", "pedestrian"]),
             "attrs": np.asarray([1, 2], np.int32)}
    test = evaluate_nuscenes(
        [frame] * 10, [dict(frame, scores=np.asarray([0.9, 0.8]))] * 10,
        ("car", "pedestrian"))
    check(test["mAP"] > 0.95 and test["NDS"] > 0.95
          and test["tp_errors"]["trans_err"] < 0.01
          and test["tp_errors"]["attr_err"] < 1e-9,
          f"nuScenes: test_perfect_detections' input: {test}")
    log(f"nuScenes, ground truth as its own detections: the scenes' boxes "
        f"mAP {res['mAP']:.4f} NDS {res['NDS']:.4f}; "
        f"test_perfect_detections' input mAP {test['mAP']:.4f} NDS "
        f"{test['NDS']:.4f}")

    calib = kitti_calib()
    sample = kitti_gt_sample(kitti_boxes, calib)
    recall = {}
    g, d = kitti_records(kitti_det, [sample], ("Car",), recall)
    km = kitti_metrics(g, d, recall, ("Car",))
    log(f"KITTI metric of one frame ({len(kitti_boxes)} cars, "
        f"{len(d[0]['name'])} detections, random weights: not an accuracy): "
        + ", ".join(f"{k} {v:.4f}" for k, v in km.items()
                    if k != "detail"))
    own_det = [dict(a, score=np.linspace(0.9, 0.5, len(a["name"])))
               for a in g]
    own = evaluate_kitti(g, own_det, classes=("Car",),
                         metrics=("3d", "bev", "bbox"), compute_aos=True)
    want = kitti_perfect_ap(g, "Car")
    check(all(abs(own["Car"][m][d] - want[d]) < 1e-6
              for m in ("3d", "bev", "bbox", "aos") for d in range(3)),
          f"KITTI: the frame's cars as their own detections: {own['Car']}, "
          f"R40 of each difficulty's count gives {want}")
    box = [10.0, 0.0, 0.0, 3.9, 1.6, 1.56, 0.0]
    box2 = [30.0, 5.0, 0.0, 3.9, 1.6, 1.56, 0.5]
    gt = {"boxes_lidar": np.asarray([box, box2], np.float32),
          "name": np.asarray(["Car", "Car"]),
          "bbox": np.tile(np.array([0, 0, 100, 50], np.float32), (2, 1)),
          "occluded": np.zeros(2), "truncated": np.zeros(2)}
    perfect = [{"boxes_lidar": gt["boxes_lidar"],
                "score": np.asarray([0.9 - 0.001 * i, 0.8 - 0.001 * i],
                                    np.float32),
                "name": gt["name"]} for i in range(30)]
    test = evaluate_kitti([gt] * 30, perfect)
    check(test["Car"]["3d"][1] > 95.0 and test["Car"]["bev"][1] > 95.0,
          f"KITTI: test_perfect_detection_ap_high's input: {test}")
    log(f"KITTI, ground truth as its own detections: the frame's cars "
        f"{own['Car']} (R40 of each difficulty's count: {want}); "
        f"test_perfect_detection_ap_high's input 3D "
        f"{test['Car']['3d']}, BEV {test['Car']['bev']}")


# the aux objectives (phases 44-46) and the Swin-T preset (47-49)
AUX_LOGS = ("aux_seg_loss", "aux_consistency_loss", "aux_loss")


def phase_aux_small_train(dev):
    """Phase 44: phases 17, 22 and 29's small fused training steps with the
    aux objectives, card against CPU (`small_step_card_vs_cpu`: the aux
    head's leaves among the gradients and updated parameters, the three
    aux logs among the logs)."""
    for label, run in (("CenterPoint + 3D-DF", phase_small_fused_train),
                       ("TransFusion + 3D-DF",
                        phase_small_transfusion_fused_train),
                       ("Voxel R-CNN + 3D-DF", phase_small_kitti_train)):
        cpu, _ = run(dev, aux=True)
        logs, grads = cpu[0], cpu[1]
        check(all(k in logs for k in AUX_LOGS),
              f"{label}, aux: logs {sorted(logs)}")
        head = [n for n in grads if ".aux_seg." in f".{n}"]
        check(len(head) == 4 and all(grads[n].abs().max() > 0
                                     for n in head),
              f"{label}, aux: the aux head's gradients {head}")


def check_launches(label, run, bf16=None):
    """`run()` with every K1 launch (forward and input gradient) and K2
    launch (forward and backward) captured, then each held against its
    plain version (`k1_check`, `k2_check`, `k2_bwd_check`: the tolerances
    of phases 4, 7 and 18, repeat launches bit for bit). With a list
    `bf16`, K1's bf16 launches are captured too (appended to it, counted
    as "k1_bf16") and each held against the bf16 plain version within one
    bf16 ulp (`k1_bf16_check`, its largest error under "k1_bf16"). Returns
    the launch counts and the largest errors of K1 and K2."""
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1

    launchers = {"k1_fwd": (K1, "sparse_conv_cuda"),
                 "k1_bwd": (K1, "sparse_conv_cuda_dx"),
                 "k2_fwd": (K2, "msda_cuda"), "k2_bwd": (K2, "msda_bwd_cuda")}
    if bf16 is not None:
        launchers["k1_bf16"] = (K1, "sparse_conv_bf16_cuda")
    saved = {k: getattr(m, a) for k, (m, a) in launchers.items()}
    captured = {k: [] for k in launchers}

    def recording(key):
        def wrapped(*args):
            captured[key].append(tuple(
                a.clone() if torch.is_tensor(a) else a for a in args))
            return saved[key](*args)
        return wrapped

    for key, (mod, attr) in launchers.items():
        setattr(mod, attr, recording(key))
    try:
        run()
    finally:
        for key, (mod, attr) in launchers.items():
            setattr(mod, attr, saved[key])
    torch.cuda.synchronize()
    err = {"k1": 0.0, "k2": 0.0}
    for key in ("k1_fwd", "k1_bwd"):
        for i, (f, idx, w) in enumerate(captured[key]):
            err["k1"] = max(err["k1"], k1_check(
                f"{label}: K1 {key} launch {i}", saved[key],
                K1.sparse_conv_plain, f, idx, w)[2])
    for i, args in enumerate(captured["k2_fwd"]):
        err["k2"] = max(err["k2"], k2_check(
            f"{label}: K2 forward launch {i}", saved["k2_fwd"],
            K2.msda_plain, *args)[2])
    for i, args in enumerate(captured["k2_bwd"]):
        err["k2"] = max(err["k2"], k2_bwd_check(
            f"{label}: K2 backward launch {i}", saved["k2_bwd"],
            K2.msda_bwd_plain, *args)[0])
    if bf16 is not None:
        err["k1_bf16"] = 0.0
        for i, (f, idx, w) in enumerate(captured["k1_bf16"]):
            err["k1_bf16"] = max(err["k1_bf16"], k1_bf16_check(
                f"{label}: K1 bf16 launch {i}", saved["k1_bf16"],
                K1.sparse_conv_bf16_plain, f, idx, w)[2])
        bf16.extend(captured["k1_bf16"])
    counts = {k: len(v) for k, v in captured.items()}
    log(f"{label}: launches {counts}, each against its plain version: max "
        f"abs err " + ", ".join(f"{k.upper()} {v:.3g}" for k, v in err.items())
        + "; repeat launches bit for bit")
    return counts, err


def aux_full_cases(dev):
    """(label, build(aux) -> (state, step), batch, step args, K2 per
    step, K1 counts) of phase 45's three presets at full width."""
    from df3d_torch.entry import build_voxelrcnn3ddf_trainer
    from df3d_torch.config.presets import (
        centerpoint_3ddf_nusc, fused_config, transfusion_3ddf_nusc,
        voxel_rcnn_3ddf_kitti,
    )

    def nusc(transfusion):
        def build(aux):
            return full_fused_train_setup(dev, transfusion=transfusion,
                                          with_batch=False, aux=aux)[2:4]
        return build

    kitti = voxel_rcnn_3ddf_kitti()
    gen = torch.Generator(device=dev)
    yield ("centerpoint_3ddf_nusc", nusc(False),
           lambda: full_fused_batch(dev, fused_config(
               centerpoint_3ddf_nusc())), (), 1,
           (K1_PER_FRAME, K1_BWD_PER_STEP))
    yield ("transfusion_3ddf_nusc", nusc(True),
           lambda: full_fused_batch(dev, fused_config(
               transfusion_3ddf_nusc())), (),
           K2_PER_TRANSFUSION_FUSED_FRAME, (K1_PER_FRAME, K1_BWD_PER_STEP))
    yield ("voxel_rcnn_3ddf_kitti",
           lambda aux: build_voxelrcnn3ddf_trainer(
               kitti["lidar"], fused_config(kitti), dev, seed=0, aux=aux),
           lambda: kitti_train_batch(dev, fused=True), (gen,), 1,
           (K1_PER_KITTI_FRAME, K1_BWD_PER_KITTI_STEP))


def phase_aux_full(dev):
    """Phase 45: the three fused presets' training steps at full width
    (`centerpoint_3ddf_nusc` and `transfusion_3ddf_nusc` at batch 4 x six
    448x800 cameras, `voxel_rcnn_3ddf_kitti` at batch 2) with the aux
    objectives, each beside its aux-off step in this process, the same
    weights but the head: ms/step (2 warm-up + 3 timed,
    `phase_fused_train_path` without its profile), the split with the
    `aux` stage (the head, the FG render and the two losses), peak memory,
    the aux logs finite; the kernels' launch counts equal the aux-off
    step's, and every launch of one aux step held against its plain
    version (`check_launches`). Returns {preset: (aux-off, aux-on)
    results} and the largest errors."""
    out, err = {}, {"k1": 0.0, "k2": 0.0}
    for label, build, batch_fn, args, k2, k1 in aux_full_cases(dev):
        batch = batch_fn()
        runs = []
        for aux in (False, True):
            state, step = build(aux)
            if args:
                args[0].manual_seed(7)
            if aux:
                counts, e = check_launches(
                    f"{label}, aux step",
                    lambda: step.grads(state, batch, *args))
                err = {k: max(err[k], e[k]) for k in err}
                check(counts == runs[0]["per_step"],
                      f"{label}: aux step launches {counts}, aux off "
                      f"{runs[0]['per_step']}")
            res = phase_fused_train_path(
                state, step, batch,
                getattr(state.model, "rpn", state.model).fused, k2,
                f"{label} train path, aux {'on' if aux else 'off'}", args,
                k1, caps_drop=bool(args), timed_steps=3, profile=False)
            res["per_step"] = {k: res[k] // 3 for k in
                               ("k1_fwd", "k1_bwd", "k2_fwd", "k2_bwd")}
            if aux:
                check(all(np.isfinite(res["logs"][k]) for k in AUX_LOGS)
                      and "aux" in res["split"],
                      f"{label}: aux logs {res['logs']}, split "
                      f"{res['split']}")
            runs.append(res)
            del state, step
            torch.cuda.empty_cache()
        off, on = runs
        log(f"{label}: aux off {off['ms']:.3f} ms/step, peak "
            f"{off['peak_gib']:.3f} GiB; aux on {on['ms']:.3f} ms/step, peak "
            f"{on['peak_gib']:.3f} GiB, aux stage {on['split']['aux']:.3f} "
            f"ms; aux logs " + ", ".join(f"{k} {on['logs'][k]:.5f}"
                                         for k in AUX_LOGS))
        out[label] = runs
        del batch
    return out, err


def phase_aux_dp(dev):
    """Phase 46: phase 34 with the aux objectives, for the three fused
    small steps (`AUX_DP_STEPS`): the consistency and segmentation
    normalizers over the global batch."""
    phase_small_dp_train(dev, AUX_DP_STEPS, tag="aux")


def swin_configs():
    """(TransFusion-L, its FusedConfig) of `transfusion_3ddf_swin_nusc` at
    the serving stage caps of `full_transfusion_configs`."""
    from df3d_torch.config.presets import (
        fused_config, transfusion_3ddf_swin_nusc,
    )

    preset = transfusion_3ddf_swin_nusc()
    cfg = dataclasses.replace(preset["lidar"],
                              max_voxels=REALISTIC_STAGE_CAPS[0],
                              stage_caps=REALISTIC_STAGE_CAPS)
    return cfg, fused_config(preset)


def phase_swin_small(dev):
    """Phase 47: phase 11's check with the Swin-T branch: the small
    TransFusion + 3D-DF input, card against the CPU's plain path, Swin-T
    narrowed (one block a stage, width 24) on two 64x112 cameras."""
    from df3d_torch.entry import (
        build_transfusion3ddf, infer_transfusion_fused, random_points,
    )
    from df3d_torch.config.presets import (
        fused_config, transfusion_3ddf_swin_nusc,
    )

    cfg = small_transfusion_config()
    preset = transfusion_3ddf_swin_nusc()
    fcfg = fused_config(preset, image_shape=(64, 112), num_cams=2,
                        swin_depths=(1, 1, 1, 1), swin_dim=24,
                        actr=dataclasses.replace(preset["actr"],
                                                 lt_npoint=64))
    frame = random_points(np.random.RandomState(3), 1, 2000)[0]
    transfusion_card_vs_cpu(
        "small Swin TransFusion + 3D-DF input",
        lambda d: build_transfusion3ddf(cfg, fcfg, d, seed=0), cfg,
        list(fused_inputs(frame, fcfg.num_cams, fcfg.image_shape, "cpu", 0)),
        infer_transfusion_fused, dev)


def phase_swin_full(dev, frames):
    """Phase 48: `transfusion_3ddf_swin_nusc` at full width on six 448x800
    cameras: every K1 and K2 launch of one frame against its plain version
    (`check_launches`: 16 and 2), then `phase_fused_main_path` (3 warm-up
    and 5 timed frames, the split with `image_branch`); then a seeded
    synthetic mmdet TransFusion + Swin checkpoint
    (`mmdet_transfusion_swin_state_dict`, full width, written with
    torch.save) built through `entry.build_transfusion3ddf(...,
    checkpoint=)`: its image branch and LiDAR detector equal the source's,
    its fusion hook the seeded one, and one frame of it finite. Returns
    the timed path's launches and the largest errors."""
    from df3d_torch.entry import build_transfusion3ddf, infer_transfusion_fused
    from df3d_torch.models.detectors.fused import TransFusion3DDF

    cfg, fcfg = swin_configs()
    model = build_transfusion3ddf(cfg, fcfg, dev, seed=0)
    inputs = fused_inputs(frames[0], fcfg.num_cams, fcfg.image_shape, dev, 10)
    counts, err = check_launches(
        "Swin TransFusion + 3D-DF frame",
        lambda: infer_transfusion_fused(model, cfg, *inputs))
    check(counts == {"k1_fwd": K1_PER_FRAME, "k1_bwd": 0,
                     "k2_fwd": K2_PER_TRANSFUSION_FUSED_FRAME, "k2_bwd": 0},
          f"Swin frame launches {counts}")
    launches = phase_fused_main_path(
        "Swin TransFusion + 3D-DF path", model, cfg, fcfg, frames, dev,
        infer_transfusion_fused, cfg.head.num_proposals,
        K2_PER_TRANSFUSION_FUSED_FRAME)
    hook = {k: v.cpu() for k, v in model.state_dict().items()
            if ".fusion_hook." in k}
    del model
    torch.cuda.empty_cache()

    source = TransFusion3DDF(cfg, fcfg).init_weights(
        torch.Generator().manual_seed(1))
    ref = mmdet_transfusion_swin_state_dict(source)
    path = Path(__file__).resolve().parent / "build" / "swin_ckpt.pth"
    path.parent.mkdir(parents=True, exist_ok=True)
    torch.save({"state_dict": ref}, path)
    built = build_transfusion3ddf(cfg, fcfg, dev, seed=0,
                                  checkpoint=str(path))
    path.unlink()
    want = dict(source.state_dict(), **hook)
    check_imported("Swin checkpoint", (built,), (want,))
    det, _ = infer_transfusion_fused(built, cfg, *inputs)
    check(all(torch.isfinite(v).all() for v in det.values()
              if v.is_floating_point()), "Swin checkpoint frame: non-finite")
    log(f"Swin checkpoint: {len(ref)} mmdet keys imported through "
        f"checkpoint=, every entry equal to the source's (the fusion hook's "
        f"the seeded ones); one frame finite, "
        f"{int(det['boxes'].shape[1])} boxes")
    del built, source
    torch.cuda.empty_cache()
    return launches, err


def phase_swin_train(dev):
    """Phase 49: the Swin preset's training step at batch 4 x six 448x800
    cameras: every launch of one step against its plain version (K1 16 +
    15, K2 2 + 2), then `phase_fused_train_path` (2 warm-up + 3 timed
    steps, the split, peak memory). Returns its counts and the largest
    errors."""
    from df3d_torch.config.presets import transfusion_3ddf_swin_nusc

    _, fcfg, state, step, batch = full_fused_train_setup(
        dev, preset=transfusion_3ddf_swin_nusc())
    counts, err = check_launches("Swin train step",
                                 lambda: step.grads(state, batch))
    k2 = K2_PER_TRANSFUSION_FUSED_FRAME
    check(counts == {"k1_fwd": K1_PER_FRAME, "k1_bwd": K1_BWD_PER_STEP,
                     "k2_fwd": k2, "k2_bwd": k2},
          f"Swin train step launches {counts}")
    res = phase_fused_train_path(state, step, batch, fcfg, k2,
                                 "Swin TransFusion + 3D-DF train path",
                                 timed_steps=3, profile=False)
    del state, step, batch
    torch.cuda.empty_cache()
    return res, err


# --- every preset by name (phases 50-52) ------------------------------------

# the presets phase 51 and 52 serve in "tpu_v5e" (`centerpoint_nusc`'s are
# phases 37-39), with their K1 launches a frame in that profile, (f32,
# bf16), and K2's, the same as in "exact": the 32-channel gate leaves
# conv_input, the first stage and the first downsample (Cin 5 and 16; 4
# and 16 on KITTI) on the f32 form, and the hybrid tail's dense convs are
# cuDNN's
PROFILE_PRESETS = {
    "centerpoint_3ddf_nusc": (6, 10, K2_PER_FUSED_FRAME),
    "transfusion_l_nusc": (6, 10, 0),
    "transfusion_3ddf_nusc": (6, 10, K2_PER_TRANSFUSION_FUSED_FRAME),
    "transfusion_3ddf_swin_nusc": (6, 10, K2_PER_TRANSFUSION_FUSED_FRAME),
    "voxel_rcnn_car_kitti": (3, 9, 0),
    "voxel_rcnn_3ddf_kitti": (3, 9, K2_PER_KITTI_FUSED_FRAME),
}
# phase 50's small configs: each family's preset narrowed by `--set`
# overrides to the small config of phases 3, 9 and 24 (the
# `centerpoint_tiny_smoke` grid on nuScenes), a fused preset's LT to 64
# centres and its cameras (all of them, the preset's image branch at
# full depth) to `SMALL_IMAGE` through `build_detector`'s `image_shape`
_SMALL_GRID = ["pc_range=[-25.6, -25.6, -2.4, 25.6, 25.6, 2.4]",
               "voxel_size=[0.4, 0.4, 0.2]", "grid_size=[24, 128, 128]",
               "max_voxels=2048", "stage_caps=[2048, 1024, 512, 256]"]
SMALL_OVERRIDES = {
    "centerpoint": _SMALL_GRID + [
        "max_objs=32", "nms_pre_max_size=128", "nms_post_max_size=16",
        "post_center_range=[-30.0, -30.0, -4.0, 30.0, 30.0, 4.0]"],
    "transfusion": _SMALL_GRID + [
        "head.bev_size=[16, 16]", "head.voxel_size=[0.4, 0.4]",
        "head.pc_range=[-25.6, -25.6]"],
    "voxelrcnn": [
        "pc_range=[0.0, -16.0, -2.4, 32.0, 16.0, 2.4]",
        "voxel_size=[0.5, 0.5, 0.2]", "grid_size=[24, 64, 64]",
        "max_voxels=512", "stage_caps=[512, 384, 256, 128]",
        "test_pre_nms=128", "test_post_nms=16", "rcnn.grid_size=4",
        "rcnn.max_local=64"],
}
SMALL_IMAGE = {"nusc": (64, 112), "kitti": (96, 320)}


def small_preset(name):
    """The preset `name` from the registry narrowed to its family's small
    config (`SMALL_OVERRIDES`; `centerpoint_tiny_smoke` as it is) ->
    (preset, the overrides)."""
    from df3d_torch.config import apply_preset_overrides, get_preset
    from df3d_torch.models.detectors.transfusion import TransFusionConfig
    from df3d_torch.models.detectors.voxel_rcnn import VoxelRCNNConfig

    preset = get_preset(name)
    if name == "centerpoint_tiny_smoke":
        return preset, []
    fused = isinstance(preset, dict)
    lidar = preset["lidar"] if fused else preset
    family = ("voxelrcnn" if isinstance(lidar, VoxelRCNNConfig) else
              "transfusion" if isinstance(lidar, TransFusionConfig) else
              "centerpoint")
    sets = [("lidar." if fused else "") + o for o in SMALL_OVERRIDES[family]]
    if fused:
        sets.append("actr.lt_npoint=64")
    return apply_preset_overrides(preset, sets), sets
PRESET_TIMED_FRAMES = 3
# bf16 against the CPU's bf16 (phase 51's small inputs): the card's conv
# sums and the CPU's differ in order, so a bf16 output lands an ulp apart
# at a rounding boundary and the later bf16 layers carry it on; held to
# this share of each map's largest value, and a decision the card replays
# to this gap (tests/test_torch_profile_presets.py measures the same
# effect between the port and the JAX package on the CPU)
PROFILE_MAP_REL = 5e-2
PROFILE_TIE = 1e-2


def serving_preset(name):
    """The preset `name` from the registry; the nuScenes ones with the
    serving caps the ray-cast frames were fitted to (REALISTIC_STAGE_CAPS),
    set as `--set` overrides, the others as they are."""
    from df3d_torch.config import apply_preset_overrides, get_preset

    preset = get_preset(name)
    if not name.endswith("_nusc"):
        return preset
    lidar = "lidar." if isinstance(preset, dict) else ""
    return apply_preset_overrides(preset, [
        f"{lidar}max_voxels={REALISTIC_STAGE_CAPS[0]}",
        f"{lidar}stage_caps={list(REALISTIC_STAGE_CAPS)}"])


def preset_small_inputs(name, ns):
    """CPU tensors (points, valid[, images, proj]) of a small input for a
    built small preset: 2000 random points over +-25 m (nuScenes, 5
    features) or phase 24's 1500 in front of the car (KITTI, 4), and for
    a fused preset seeded normalized images at its image shape with the
    rig (or KITTI's front camera scaled to the image)."""
    from df3d_torch.entry import random_points

    rng = np.random.RandomState(0)
    if ns.family == "voxelrcnn":
        n = 1500
        pts = np.concatenate([rng.uniform(0, 31, (n, 1)),
                              rng.uniform(-15, 15, (n, 1)),
                              rng.uniform(-1.8, 1.8, (n, 1)),
                              rng.uniform(0, 1, (n, 1))],
                             -1).astype(np.float32)
        ins = kitti_inputs(pts, ns.image_shape or KITTI_IMAGE, "cpu", 0,
                           scale=(ns.image_shape or KITTI_IMAGE)[1]
                           / KITTI_IMAGE[1])
        return list(ins if ns.fused else ins[:2])
    pts = random_points(rng, 1, 2000, ns.lidar_cfg.num_point_features)[0]
    if not ns.fused:
        return [torch.from_numpy(pts[None]),
                torch.ones(1, len(pts), dtype=torch.bool)]
    return list(fused_inputs(pts, ns.num_cams, ns.image_shape, "cpu", 0))


def _on_device(ns, cpu):
    """`build(device)` for the card-against-CPU helpers: the built
    preset's model (Voxel R-CNN: (first stage, head)) on the card, or its
    copy `cpu` on the CPU."""
    card = (ns.model, ns.head) if ns.family == "voxelrcnn" else ns.model
    return lambda d: card if torch.device(d).type == "cuda" else cpu


def _cpu_copy(ns):
    import copy

    if ns.family == "voxelrcnn":
        return copy.deepcopy(ns.model).cpu(), copy.deepcopy(ns.head).cpu()
    return copy.deepcopy(ns.model).cpu()


def phase_presets_by_name(dev):
    """Phase 50: every preset of the registry, by name and narrowed to its
    family's small config (`small_preset`), built through
    `models.build.build_detector` on the card, serves one small input in
    "exact", card against a CPU copy of the same model (the plain
    versions): phases 3, 9 and 24's checks by family, near ties replayed
    and counted. Returns the built presets, which phase 51 reuses."""
    from df3d_torch.config import PRESETS
    from df3d_torch.models.build import build_detector

    built = {}
    for name in PRESETS:
        t = time.perf_counter()
        preset, sets = small_preset(name)
        fused = isinstance(preset, dict)
        small = SMALL_IMAGE["kitti" if "kitti" in name else "nusc"]
        ns = build_detector(preset, device=dev, seed=0,
                            image_shape=small if fused else None)
        cpu = _cpu_copy(ns)
        inputs = preset_small_inputs(name, ns)
        label = f"{name} by name, small input"
        build = _on_device(ns, cpu)
        if ns.family == "centerpoint":
            card_vs_cpu(label, build, ns.lidar_cfg, inputs, ns.serve, dev)
        elif ns.family == "transfusion":
            transfusion_card_vs_cpu(label, build, ns.lidar_cfg, inputs,
                                    ns.serve, dev)
        else:
            kitti_card_vs_cpu(label, build, ns.lidar_cfg, inputs, ns.serve,
                              dev)
        log(f"{name}: family {ns.family}, fused {ns.fused}, cameras "
            f"{ns.num_cams}, image {ns.image_shape}, --set {sets}; built "
            f"and checked in {time.perf_counter() - t:.1f} s")
        built[name] = (ns, cpu, inputs)
    return built


def _float_maps(preds):
    """The float head maps of a forward's predictions, flat."""
    if isinstance(preds, (list, tuple)):
        return {f"task{i}.{k}": v for i, p in enumerate(preds)
                for k, v in _float_maps(p).items()}
    return {k: v for k, v in preds.items()
            if torch.is_tensor(v) and v.is_floating_point()}


def profile_card_vs_cpu(label, ns, cpu, inputs, dev):
    """A built preset in "tpu_v5e" on a small input, card against its CPU
    copy (both set to the profile): the CPU run records its decisions,
    the card replays them where its own differ (any number, each a tie
    within `PROFILE_TIE` of the score or cost it replaces; Voxel R-CNN's
    second stage reads the CPU's proposals once the card's own are held
    within `PROFILE_MAP_REL` of them, as phase 29 does, since a RoI moved
    by the bf16 stages' rounding moves its neighbour sets); cap overflows,
    kept sets and labels equal; every head map, box and score within
    `PROFILE_MAP_REL` of the largest value of its kind. Logs the largest
    gaps and the replays."""
    from df3d_torch import entry

    decide = {"centerpoint": centerpoint_decisions,
              "transfusion": functools.partial(transfusion_decisions,
                                               peaks=True),
              "voxelrcnn": functools.partial(
                  proposal_decisions, module=entry, rel=PROFILE_MAP_REL,
                  floor=0.0)}[ns.family]
    build = _on_device(ns, cpu)
    store, runs = [], []
    for d, replay in (("cpu", False), (dev, True)):
        model = build(d)
        first = model[0] if ns.family == "voxelrcnn" else model
        seen = []
        handle = first.register_forward_hook(
            lambda m, a, o: seen.append(o[0]))
        args = [t.to(d) for t in inputs]
        try:
            with torch.no_grad(), decide(store, replay) as replays:
                det, overflow = (ns.serve(*model, ns.lidar_cfg, *args)
                                 if ns.family == "voxelrcnn" else
                                 ns.serve(model, ns.lidar_cfg, *args))
        finally:
            handle.remove()
        runs.append(to_cpu((_float_maps(seen[0]), det, overflow)))
    (c_maps, c_det, c_ov), (g_maps, g_det, g_ov) = runs
    check(all(g < PROFILE_TIE for *_, g in replays),
          f"{label}: a replayed decision is no tie within {PROFILE_TIE}: "
          f"{replays}")
    for k in c_ov:
        check(torch.equal(c_ov[k], g_ov[k]), f"{label}: {k} differs")
    # the kept detections (TransFusion keeps every query)
    kept = c_det.get("valid", torch.ones_like(c_det["labels"], dtype=bool))
    for k in ("valid", "roi_mask"):
        if k in c_det:
            check(torch.equal(c_det[k], g_det[k]), f"{label}: {k} differs")
    check(torch.equal(c_det["labels"][kept], g_det["labels"][kept]),
          f"{label}: kept labels differ")
    gaps = {}
    for tree_c, tree_g, rows in ((c_maps, g_maps, None),
                                 (c_det, g_det, kept)):
        for k, t in tree_c.items():
            if not t.is_floating_point():
                continue
            g = tree_g[k]
            if rows is not None and t.shape[:2] == rows.shape:
                t, g = t[rows], g[rows]
            check(torch.isfinite(g).all(), f"{label}: non-finite {k}")
            top = max(t.abs().max().item(), 1e-30) if t.numel() else 1.0
            gaps[k] = ((g - t).abs().max().item() / top if t.numel()
                       else 0.0)
    worst = max(gaps, key=gaps.get)
    check(gaps[worst] <= PROFILE_MAP_REL,
          f"{label}: {worst} {gaps[worst]:.3g} of its largest value apart")
    log(f"{label}: card vs CPU in tpu_v5e agree: largest gap {worst} "
        f"{gaps[worst]:.3g} of its largest value (bev maps and detections: "
        + ", ".join(f"{k} {v:.2g}" for k, v in gaps.items()) + "); "
        f"{sum(map(len, store)) if ns.family == 'voxelrcnn' else len(store)}"
        " decisions recorded, replays "
        f"{sum(n for _, n, _ in replays)} entries {replays}; cap overflow "
        + ", ".join(f"{k}={int(v.sum())}" for k, v in c_ov.items()))


K1_BF16_KITTI_EDGE_CASES = [
    # (B, N_in, N_out, K, Cin, Cout, hit share) at KITTI's shapes: the
    # submanifold 32- and 64-channel stacks, the strided downsamples
    # (N_out < N_in), conv_out's 3 taps from 64 to 128 channels, rows with
    # every tap missing, and a batch of two
    (1, 12000, 12000, 27, 32, 32, (0.3,)),
    (1, 12000, 8000, 27, 32, 64, (0.2,)),
    (1, 8000, 8000, 27, 64, 64, (0.3,)),
    (1, 8000, 4000, 27, 64, 64, (0.1,)),
    (1, 4000, 4000, 3, 64, 128, (0.5,)),
    (1, 4000, 2500, 3, 64, 128, (0.02,)),
    (2, 4000, 4000, 3, 64, 128, (0.0, 0.4)),
]


def k1_bf16_kitti_edge_cases():
    """K1's bf16 form against its plain version at KITTI's shapes
    (`K1_BF16_KITTI_EDGE_CASES`, `k1_bf16_check`: one bf16 ulp, repeat
    launches bit for bit); an all-miss sample must give zeros."""
    from df3d_torch.ops import sparse_conv_kernel as K

    g = torch.Generator(device="cuda").manual_seed(5)
    for b, n_in, n_out, k, cin, cout, shares in K1_BF16_KITTI_EDGE_CASES:
        f = torch.randn(b, n_in, cin, device="cuda", generator=g).bfloat16()
        w = (0.3 * torch.randn(k, cin, cout, device="cuda",
                               generator=g)).bfloat16()
        rows = torch.randint(0, n_in, (b, k * n_out), device="cuda",
                             generator=g, dtype=torch.int32)
        idx = torch.full_like(rows, n_in)
        for i, share in enumerate(shares):
            keep = torch.rand(k * n_out, device="cuda", generator=g)
            idx[i] = torch.where(keep < share, rows[i], idx[i])
        out = k1_bf16_check(
            f"K1 bf16 KITTI edge case B={b} N_in={n_in} N_out={n_out} K={k} "
            f"Cin={cin} Cout={cout} hits={shares}", K.sparse_conv_bf16_cuda,
            K.sparse_conv_bf16_plain, f, idx, w)[0]
        for i, share in enumerate(shares):
            check(share > 0 or not out[i].any(),
                  "K1 bf16 KITTI edge case: an all-miss sample gave "
                  "non-zeros")
    log(f"K1 bf16 at KITTI's shapes ({len(K1_BF16_KITTI_EDGE_CASES)} cases: "
        "Cin 32 and 64, strided N_out < N_in, conv_out's 3 taps to 128, "
        "all-miss rows, B = 2): agree with the plain version within one "
        "bf16 ulp, repeat launches bit for bit")


def full_preset_inputs(ns, frames, dev):
    """Full-width inputs on `dev` for a built preset: the ray-cast frames
    (nuScenes) or KITTI frames, with random normalized images at the
    preset's cameras for a fused one."""
    if ns.family == "voxelrcnn":
        return [kitti_inputs(f, KITTI_IMAGE, dev, 10 + i)[:4 if ns.fused
                                                           else 2]
                for i, f in enumerate(frames["kitti"])]
    if not ns.fused:
        return [(torch.from_numpy(f[None]).to(dev),
                 torch.ones(1, len(f), dtype=torch.bool, device=dev))
                for f in frames["nusc"]]
    return [fused_inputs(f, ns.num_cams, ns.image_shape, dev, 10 + i)
            for i, f in enumerate(frames["nusc"])]


def phase_presets_profile(dev, built, frames):
    """Phase 51: "tpu_v5e" on every preset but `centerpoint_nusc`. First
    each of them (and `centerpoint_tiny_smoke`) as phase 50 built it, on
    its small input, card against CPU in the profile
    (`profile_card_vs_cpu`). Then K1's bf16 form at KITTI's shapes
    (`k1_bf16_kitti_edge_cases`). Then each of the six presets built by
    name at full width (six 448x800 cameras on nuScenes, one 384x1280 on
    KITTI) serves one full-width frame in the profile with every K1 and K2
    launch captured (`check_launches`): K1's f32 and bf16 launches and
    K2's counted against `PROFILE_PRESETS`, each f32 launch held as in
    phase 4, each bf16 one within one bf16 ulp of the plain version and
    bit for bit on a repeat launch, each K2 launch as in phase 7. Returns
    the full-width models and each preset's captured bf16 launches."""
    from df3d_torch import serving
    from df3d_torch.models.build import build_detector

    for name in ("centerpoint_tiny_smoke", *PROFILE_PRESETS):
        ns, cpu, inputs = built.pop(name)
        for m in (ns.model, *(cpu if isinstance(cpu, tuple) else (cpu,))):
            serving.apply_profile(m, "tpu_v5e")
        profile_card_vs_cpu(f"{name} by name, small input, tpu_v5e", ns, cpu,
                            inputs, dev)
        del ns, cpu
    built.clear()
    torch.cuda.empty_cache()
    k1_bf16_kitti_edge_cases()

    full, bf16, err = {}, {}, {"k1": 0.0, "k2": 0.0, "k1_bf16": 0.0}
    for name, (n32, n16, nk2) in PROFILE_PRESETS.items():
        ns = build_detector(serving_preset(name), device=dev, seed=0,
                            profile="tpu_v5e")
        inputs = full_preset_inputs(ns, frames, dev)
        bf16[name] = []
        counts, e = check_launches(f"{name} tpu_v5e frame",
                                   lambda: ns.infer(*inputs[0]),
                                   bf16=bf16[name])
        err = {k: max(err[k], e[k]) for k in err}
        want = {"k1_fwd": n32, "k1_bwd": 0, "k1_bf16": n16, "k2_fwd": nk2,
                "k2_bwd": 0}
        check(counts == want, f"{name} tpu_v5e frame: launches {counts}, "
              f"expected {want}")
        check(all(f.shape[-1] >= 32 for f, _, _ in bf16[name]),
              f"{name}: a bf16 launch under the 32-channel gate")
        full[name] = (ns, inputs)
    return full, bf16, err


def phase_presets_timed(full, bf16):
    """Phase 52: each of the six presets at full width in "exact" and in
    "tpu_v5e" in this process, the same model (its profile switched by
    `serving.apply_profile`), weights and frames: `timed_path` each (a
    warm-up pass over the frames, `PRESET_TIMED_FRAMES` timed frames with
    the launch counts set to 0 just before and read just after: K1 16 (12
    on KITTI) f32 launches a frame in "exact", `PROFILE_PRESETS`' f32 and
    bf16 ones in "tpu_v5e", K2 the same in both; the split, peak memory
    and a one-frame profile). Then K1's bf16 launches of one
    `transfusion_l_nusc` and one `voxel_rcnn_car_kitti` frame per launch
    (`k1_bf16_table`, phase 37's bound). Returns each run's launches, the
    two tables and the ms/frame of each preset and profile."""
    from df3d_torch import serving
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1

    launches, summary = {}, {}
    for name, (n32, n16, nk2) in PROFILE_PRESETS.items():
        ns, inputs = full.pop(name)
        kitti = ns.family == "voxelrcnn"
        n_boxes = (ns.lidar_cfg.final_max_boxes if kitti else
                   ns.lidar_cfg.head.num_proposals
                   if ns.family == "transfusion" else
                   len(ns.lidar_cfg.tasks) * ns.lidar_cfg.nms_post_max_size)
        for profile in ("exact", "tpu_v5e"):
            serving.apply_profile(ns.model, profile)
            want = ({K1: K1_PER_KITTI_FRAME if kitti else K1_PER_FRAME,
                     (K1, "bf16_launches"): 0, K2: nk2}
                    if profile == "exact" else
                    {K1: n32, (K1, "bf16_launches"): n16, K2: nk2})
            stats = {}
            got = timed_path(f"{name} {profile}",
                             lambda *a: ns.infer(*a), n_boxes, inputs,
                             PRESET_TIMED_FRAMES, want,
                             box_dim=7 if kitti else 9, stats=stats)
            launches[name, profile] = got
            summary[name, profile] = stats
        e, b = summary[name, "exact"], summary[name, "tpu_v5e"]
        log(f"{name}: ms/frame exact {e['ms']:.3f}, tpu_v5e {b['ms']:.3f} "
            f"({b['ms'] / e['ms']:.3f}x); peak GiB {e['peak_gib']:.3f} / "
            f"{b['peak_gib']:.3f}; device kernels per frame "
            f"{e['busy_ms']:.3f} / {b['busy_ms']:.3f} ms, idle share "
            f"{e['idle']:.3f} / {b['idle']:.3f}")
        del ns, inputs
        torch.cuda.empty_cache()
    tables = {key: k1_bf16_table(f"a {name} tpu_v5e frame", bf16[name])
              for key, name in (("transfusion", "transfusion_l_nusc"),
                                ("kitti", "voxel_rcnn_car_kitti"))}
    return launches, tables, summary


# Training and evaluation from a dataset on disk (phases 53-55): the train
# and test CLIs (`df3d_torch.tools.train`, `.test`) run in this process on
# datasets written into a temporary directory laid out as the JAX
# package's tools/create_data.py lays them out (`utils.synth.
# write_nuscenes_dataset`, `write_kitti_dataset`)
CLI_EXTRA_SEEDS = (4,)  # with TRAIN_SEEDS and SERVING_SEEDS, phase 54's 8
CLI_SMALL_POINTS = 3000
# `voxel_rcnn_car_kitti` narrowed to the CPU tests' training grid and
# proposal counts (tests/torch_port_helpers.KITTI_SMALL_SETS)
CLI_KITTI_SMALL_SETS = [
    "pc_range=[0.0, -16.0, -2.4, 32.0, 16.0, 2.4]",
    "voxel_size=[0.5, 0.5, 0.2]", "grid_size=[24, 64, 64]",
    "max_voxels=256", "stage_caps=[256, 192, 128, 96]",
    "train_pre_nms=64", "train_post_nms=16", "test_pre_nms=64",
    "test_post_nms=16", "rcnn.grid_size=3", "rcnn.max_local=32",
    "rcnn.roi_per_image=8"]
CLI_LR = 1e-3  # the train CLI's default --lr, the schedule's peak
# Phase 53's limits on the CLI's second step, card against CPU, in
# relative L2: (its update of the trainable parameters, its change of the
# batch statistics), by preset. 1.5-2.5 times the largest readings of
# sound runs on the card (PERF.md §6: CenterPoint 0.131 and 2.4e-4, the
# LiDAR-only KITTI preset 0.45 and 0.20, the fused one 0.45 and 0.061);
# each run also computes two controls from the card's own run, its second
# step skipped (1.0 and 1.0) and sign-flipped (~2 and ~2), which must
# fail them.
CLI_STEP2_L2 = {"centerpoint_tiny_smoke": (0.25, 5e-4),
                "voxel_rcnn_car_kitti": (0.7, 0.5),
                "voxel_rcnn_3ddf_kitti": (0.7, 0.15)}


def relu_flip_limit(masks):
    """Phase 14's limit of 4 replayed ReLU decisions, set on its config's
    794,624 ReLU inputs a step, as a density over the step's ReLU inputs
    (`relu_decisions`' recorded `masks`): 4 per 2**20, at least 4.
    `centerpoint_tiny_smoke` at its own widths (six tasks over +-25.6 m)
    has 3,964,928 a step, so 16."""
    n = sum(m.numel() for m in masks)
    return max(4, -(-4 * n // 2**20))


def nusc_samples(seeds, n_points=None):
    """(frame, its scene's 79 boxes, their nuScenes names) of each ray-cast
    frame of `seeds`, cut to its first `n_points` rows (random already)."""
    from df3d_torch.data.nuscenes_eval import NUSC_CLASSES

    names = np.asarray(NUSC_CLASSES)[list(SCENE_CLASSES)]
    return [(raycast_frame(s)[:n_points], scene_boxes(s), names)
            for s in seeds]


def kitti_samples(n, n_points=None):
    """(points, cars in view) of `utils.synth.make_kitti_sample` for seeds
    100.., the frames of phase 25 (the first `n_points` rows when given,
    cut evenly)."""
    from df3d_torch.utils.synth import make_kitti_sample

    out = []
    for i in range(n):
        pts, boxes, _, valid = make_kitti_sample(np.random.RandomState(100 + i))
        if n_points:
            pts = pts[np.linspace(0, len(pts) - 1, n_points).astype(int)]
        out.append((pts, boxes[valid]))
    return out


@contextlib.contextmanager
def quiet_stdout(label):
    """The block's standard output (the CLIs' metric lines) logged with the
    script's seconds instead of printed bare, so that the JSON lines at the
    end stay the only bare ones."""
    import io

    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            yield
    finally:
        for line in buf.getvalue().splitlines():
            log(f"{label}: {line}")


def cli_state(runner_or_state):
    state = getattr(runner_or_state, "state", runner_or_state)
    return ({k: v.detach().cpu().clone()
             for k, v in state.model.state_dict().items()},
            [t.cpu().clone() for t in state.opt_state.mu + state.opt_state.nu],
            state.opt_state.count, state.step)


def cli_logs(work_dir):
    with open(Path(work_dir) / "train_log.jsonl") as f:
        return [json.loads(line) for line in f]


def compare_cli_runs(label, cpu, card, trainable, relu_limit, limits):
    """The train CLI's two steps on the card against the CPU's. Both runs
    must have trained on the same batches, bit for bit (the data path).
    The first step (same weights, same batch) is held as phase 14 holds
    it: the card replays the CPU's decisions at near ties (at most
    `relu_limit` ReLU inputs, each within 1e-4 of 0, and at most 4 of the
    path's near ties, each within 1e-4), every log within rtol 1e-4, and
    the batch statistics after it within 1e-4 * max|cpu| + 1e-6. After it
    the runs part: Adam's first update g / (|g| + eps) jumps by 2 lr where
    g is rounding noise (a bias ahead of a BatchNorm, whose gradients
    differ by ~1.4 of their size between the devices), so the second step
    starts from other weights and its decisions differ beyond near ties
    (an earlier design that replayed both steps met 70 ReLU disagreements
    up to 1.9e-3). Held after the second step: every log finite; the
    second step's update of the trainable parameters and its change of
    the batch statistics each within its limit (`limits`, CLI_STEP2_L2)
    of the CPU's in relative L2. Two controls made from the card's own
    run, its second step skipped and its second step's sign flipped, must
    fail both limits, or the check could not tell a sound step from
    either. Phase 14's check of the first step's gradients, parameters
    and statistics runs on the same first batch just before
    (`small_step_card_vs_cpu`)."""
    flips, picks = card["replays"]
    check(sum(n for n, _ in flips) <= relu_limit
          and all(z < 1e-4 for _, z in flips),
          f"{label}: first step: ReLU decisions replayed beyond "
          f"{relu_limit}, or one past 1e-4 of 0: {flips}")
    check(sum(n for _, n, _ in picks) <= 4
          and all(gap < 1e-4 for *_, gap in picks),
          f"{label}: first step: near ties replayed beyond 4: {picks}")
    check(len(cpu["fed"]) == len(card["fed"]) == 2,
          f"{label}: {len(cpu['fed'])} and {len(card['fed'])} batches fed")
    for a, b in zip(cpu["fed"], card["fed"]):
        check(a.keys() == b.keys() and all(np.array_equal(a[k], b[k])
                                           for k in a),
              f"{label}: the card's run was fed other batches")
    c_logs, g_logs = cli_logs(cpu["dir"]), cli_logs(card["dir"])
    check(len(c_logs) == len(g_logs) == 2, f"{label}: two logged steps")
    for i, (c, g) in enumerate(zip(c_logs, g_logs)):
        for k, v in c.items():
            if k.endswith("_ms") or k in ("epoch", "step"):
                continue
            check(np.isfinite(g[k]), f"{label} step {i}: {k} {g[k]}")
            check(i > 0 or abs(g[k] - v) <= 1e-4 * abs(v),
                  f"{label} step 0: {k} {g[k]} against the CPU's {v}")

    c1, c2 = cpu["first"][0], cli_state(cpu["runner"])[0]
    g1, g2 = card["first"][0], cli_state(card["runner"])[0]
    stats = [k for k in c2 if k.endswith(("running_mean", "running_var"))]
    over = []
    for k in stats:
        tol = 1e-4 * c1[k].abs().max().item() + 1e-6
        err = (g1[k] - c1[k]).abs().max().item()
        if err > tol:
            over.append(f"{k} off by {err} > {tol}")
    check(not over, f"{label}: batch statistics after the first step: "
          + "; ".join(over[:10]))

    def change(after, before, keys):
        return torch.cat([(after[k] - before[k]).double().flatten()
                          for k in keys])

    flipped = {k: 2 * g1[k] - g2[k] for k in g2}
    readings = {
        "update": (limits[0], change(c2, c1, trainable), {
            "card": change(g2, g1, trainable),
            "second step skipped": change(g1, g1, trainable),
            "second step sign-flipped": change(flipped, g1, trainable)}),
        "statistics": (limits[1], change(c2, c1, stats), {
            "card": change(g2, g1, stats),
            "second step skipped": change(g1, g1, stats),
            "second step sign-flipped": change(flipped, g1, stats)})}
    got = {(what, run): rel_l2(x, ref)
           for what, (_, ref, runs) in readings.items()
           for run, x in runs.items()}
    log(f"{label}: the CLI's two steps on the card beside the CPU's, the "
        f"same batches: losses {[round(r['loss'], 6) for r in g_logs]} (CPU "
        f"{[round(r['loss'], 6) for r in c_logs]}); first step replays "
        f"{sum(n for n, _ in flips)} ReLU (limit {relu_limit}), {picks}; "
        f"{len(stats)} batch statistics within phase 14's tolerance after "
        f"it; relative L2 against the CPU's of the second step's update "
        f"of {len(trainable)} parameters (limit {limits[0]}) / of its "
        f"change of the statistics (limit {limits[1]}): "
        + "; ".join(f"{run} {got['update', run]:.4g} / "
                    f"{got['statistics', run]:.4g}"
                    for run in readings["update"][2]))
    for what, (limit, _, runs) in readings.items():
        check(got[what, "card"] <= limit,
              f"{label}: the second step's {what} differs from the CPU's "
              f"by {got[what, 'card']} in relative L2 > {limit}")
        for run in runs:
            check(run == "card" or got[what, run] > limit,
                  f"{label}: the control '{run}' passes the {what} limit "
                  f"{limit} ({got[what, run]})")


def phase_cli_small(dev, root):
    """Phase 53: tiny datasets on disk, the train CLI on the CPU and on the
    card, for `centerpoint_tiny_smoke` at its own widths (a tiny
    nuScenes-layout dataset: two ray-cast frames cut to CLI_SMALL_POINTS
    rows, split into a key frame and nine sweeps, with their scenes'
    boxes), and `voxel_rcnn_car_kitti` and `voxel_rcnn_3ddf_kitti`
    narrowed by `--set` (tiny KITTI-layout datasets: two KITTI frames with
    their cars, the fused one with a 375x1242 PNG each, resized to 96x320;
    pcdet's three RoI pooling scales). For each, first phase 14's check of
    one step (`small_step_card_vs_cpu`) on the CLI's model
    (`build_detector`) and the loader's first batch from disk, for KITTI
    with the CLI's RoI sampler noise of step 0, `kitti_train_decisions`
    and the f64 witness; ReLU replays up to `relu_flip_limit`. Then the
    CLI itself for 2 steps (batch 2, 2 epochs) on both devices, the card
    replaying the CPU's decisions in the first step (`compare_cli_runs`);
    each checkpoint of the card run restored into a fresh state bit for
    bit; and a resumed run (one more epoch) that starts at the saved step.
    Returns the card runs' launch counts."""
    from df3d_torch.config import apply_preset_overrides, get_preset
    from df3d_torch.data.pipeline import PrefetchLoader
    from df3d_torch.models.build import build_detector
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1
    from df3d_torch.tools import train as train_cli
    from df3d_torch.train import checkpoint as C
    from df3d_torch.train.loop import Hook
    from df3d_torch.train.schedules import adam_onecycle
    from df3d_torch.utils.synth import (
        write_kitti_dataset, write_nuscenes_dataset,
    )

    nusc_root, kitti_root = root / "nusc_small", root / "kitti_small"
    nusc_info = write_nuscenes_dataset(
        nusc_root, nusc_samples(TRAIN_SEEDS[:2], CLI_SMALL_POINTS))
    kitti_info = write_kitti_dataset(kitti_root,
                                     kitti_samples(2, CLI_SMALL_POINTS))
    kitti_img_root = root / "kitti_small_images"
    kitti_img_info = write_kitti_dataset(
        kitti_img_root, kitti_samples(2, CLI_SMALL_POINTS), images=True,
        image_rng=np.random.RandomState(21))
    kitti_counts = (K1_PER_KITTI_FRAME, K1_BWD_PER_KITTI_STEP)
    # (label, preset, --set, dataset, info pkl, decisions, K1's launches a
    # step, --image-shape, K2's launches a step)
    cases = [
        ("CLI centerpoint_tiny_smoke", "centerpoint_tiny_smoke", [],
         nusc_root, nusc_info, centerpoint_decisions,
         (K1_PER_FRAME, K1_BWD_PER_STEP), None, 0),
        ("CLI voxel_rcnn_car_kitti narrowed", "voxel_rcnn_car_kitti",
         CLI_KITTI_SMALL_SETS, kitti_root, kitti_info,
         kitti_train_decisions, kitti_counts, None, 0),
        ("CLI voxel_rcnn_3ddf_kitti narrowed", "voxel_rcnn_3ddf_kitti",
         [f"lidar.{o}" for o in CLI_KITTI_SMALL_SETS]
         + ["actr.lt_npoint=64"], kitti_img_root, kitti_img_info,
         kitti_train_decisions, kitti_counts, SMALL_IMAGE["kitti"],
         K2_PER_KITTI_FUSED_FRAME)]
    counts = {}
    for (label, name, sets, data_root, info, decisions, k1_counts,
         image_shape, k2) in cases:
        def cli_argv(epochs, device, work_dir=None):
            argv = ["--preset", name, "--data-root", str(data_root),
                    "--info-path", str(info), "--batch-size", "2",
                    "--epochs", str(epochs), "--steps-per-epoch", "1",
                    "--log-interval", "1", "--max-points",
                    str(CLI_SMALL_POINTS), "--device", str(device)]
            if work_dir is not None:
                argv += ["--work-dir", str(work_dir)]
            if image_shape is not None:
                argv += ["--image-shape", *map(str, image_shape)]
            return argv + (["--set", *sets] if sets else [])

        def build(d):
            built = build_detector(preset, adam_onecycle(CLI_LR, 2),
                                   image_shape=image_shape, device=d)
            return built.state, built.step

        args = train_cli.parse_args(cli_argv(2, "cpu"))
        preset = apply_preset_overrides(get_preset(name), sets)
        lidar = preset["lidar"] if isinstance(preset, dict) else preset
        extra = (1, image_shape) if image_shape is not None else None
        dataset, max_points = train_cli.build_dataset(args, extra, lidar)
        max_gt = min(args.max_gt, getattr(lidar, "max_objs", args.max_gt))
        loader = PrefetchLoader(dataset, 2, train_cli.make_collate(
            extra, max_points, max_gt, lidar.num_point_features))
        it = iter(loader)
        first = next(it)
        it.close()
        if extra is not None:  # one camera: the step takes (B, H, W, 3)
            first = dict(first, images=first["images"][:, 0],
                         proj=first["proj"][:, 0])

        noise = ({"noise": train_cli.roi_noise(0, 2, lidar.train_post_nms)}
                 if hasattr(lidar, "rcnn") else None)
        small_step_card_vs_cpu(
            f"{label}, first batch from disk", build,
            lambda d: train_cli.to_device(first, d), dev, k2_per_step=k2,
            decisions=decisions, grads_kwargs=noise, k1_counts=k1_counts,
            relu_limit=relu_flip_limit,
            witness_f64=noise is not None)

        masks, picks, runs = [], [], {}
        to_device = train_cli.to_device
        for d, replay in (("cpu", False), (dev, True)):
            wd = root / f"{name}_{'card' if replay else 'cpu'}"
            fed, seen = [], {}
            stack = contextlib.ExitStack()

            def first_step_decisions(runner, replay=replay):
                if runner.epoch == 0:
                    seen["flips"] = stack.enter_context(
                        relu_decisions(masks, replay))
                    seen["picks"] = stack.enter_context(
                        decisions(picks, replay))

            def after_first(runner):
                if runner.global_step == 1:
                    stack.close()
                    seen["first"] = cli_state(runner)

            def recording(batch, device, fed=fed):
                fed.append({k: v.copy() for k, v in batch.items()})
                return to_device(batch, device)

            K1.launches = K1.bwd_launches = K2.launches = K2.bwd_launches = 0
            train_cli.to_device = recording
            try:
                with stack, quiet_stdout(label):
                    runner = train_cli.main(cli_argv(2, d, wd), hooks=[
                        Hook(0, "decisions", before_epoch=first_step_decisions,
                             after_iter=after_first)])
            finally:
                train_cli.to_device = to_device
            runs["card" if replay else "cpu"] = dict(
                dir=wd, runner=runner, first=seen["first"],
                fed=fed, replays=(seen["flips"], seen["picks"]),
                counts=(K1.launches, K1.bwd_launches, K2.launches,
                        K2.bwd_launches))
        got = runs["card"]["counts"]
        check(got == (2 * k1_counts[0], 2 * k1_counts[1], 2 * k2, 2 * k2),
              f"{label}: launches {got} in two steps, expected "
              f"{k1_counts} and K2's {k2} a step")
        counts[name] = got
        trainable = runs["cpu"]["runner"].state.param_names
        compare_cli_runs(label, runs["cpu"], runs["card"], trainable,
                         relu_flip_limit(masks), CLI_STEP2_L2[name])

        card = runs["card"]["runner"]
        saved = C.list_checkpoints(runs["card"]["dir"] / "ckpt")
        check([s for s, _ in saved] == [1, 2],
              f"{label}: checkpoints {saved}")
        fresh = build(dev)[0]
        t0 = time.perf_counter()
        C.restore_checkpoint(saved[-1][1], fresh)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        want, got_state = cli_state(card), cli_state(fresh)
        check(all(torch.equal(want[0][k], got_state[0][k]) for k in want[0])
              and all(torch.equal(a, b) for a, b in zip(want[1],
                                                        got_state[1]))
              and want[2:] == got_state[2:],
              f"{label}: the checkpoint of step 2 does not restore bit for "
              "bit")
        with quiet_stdout(label):
            resumed = train_cli.main(cli_argv(3, dev, runs["card"]["dir"]))
        check(resumed.global_step == 3
              and [t[0] for t in resumed.timings] == [2],
              f"{label}: the resumed run took steps "
              f"{[t[0] for t in resumed.timings]}, expected [2]")
        log(f"{label}: checkpoints {[s for s, _ in saved]} saved in "
            f"{[round(s, 4) for s in card.ckpt_seconds]} s; step 2 restored "
            f"bit for bit in {restore_s:.4f} s; resumed at step 2, epoch 2 "
            f"(restore {resumed.restore_seconds:.4f} s)")
    return counts


def cli_launches(label, run, bf16=None, hold=True):
    """`run()` under `check_launches` (every launch held against its plain
    version afterwards; not with `hold=False`), with the counters also set
    to 0 just before and read just after the run (forward, backward, K2,
    K2 backward, bf16); the two counts must agree. -> (counts, largest
    errors, what `run` returned)."""
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1

    seen = {}

    def counted():
        K1.launches = K1.bwd_launches = K1.bf16_launches = 0
        K2.launches = K2.bwd_launches = 0
        with quiet_stdout(label):
            seen["out"] = run()
        seen["counts"] = dict(k1_fwd=K1.launches, k1_bwd=K1.bwd_launches,
                              k2_fwd=K2.launches, k2_bwd=K2.bwd_launches,
                              k1_bf16=K1.bf16_launches)

    if not hold:
        counted()
        return seen["counts"], {}, seen["out"]
    captured, err = check_launches(label, counted, bf16)
    got = seen["counts"]
    for k, v in captured.items():
        check(got[k] == v, f"{label}: counter {k} {got[k]}, captured {v}")
    return got, err, seen["out"]


def phase_cli_nusc_full(dev, root):
    """Phase 54: `centerpoint_nusc` at full width and its training caps
    from disk. Eight ray-cast frames (TRAIN_SEEDS, CLI_EXTRA_SEEDS,
    SERVING_SEEDS; 260k points each, split into a key frame and nine
    sweeps with identity transforms, ~42 MB) with their scenes' boxes; the
    train CLI at batch 4 for 2 epochs of 2 steps: the first epoch under
    `check_launches` (every K1 launch of both steps held against its plain
    version, K1 16 + 15 a step) and stopped after its checkpoint, then the
    run resumed for the second epoch; the counts set to 0 just before and
    read just after each (16 + 15 a step); each logged step's data ms and
    step ms, the checkpoints' save and restore seconds. Then the test CLI
    on the last checkpoint over four of the frames in "exact" (K1 16 a
    frame) and "tpu_v5e" (6 f32 and 10 bf16 a frame), every launch held
    against its plain version, the metrics JSON written. Returns the
    launch counts by run and the largest errors."""
    from df3d_torch.tools import test as test_cli
    from df3d_torch.tools import train as train_cli
    from df3d_torch.train.loop import Hook
    from df3d_torch.utils.synth import write_nuscenes_dataset

    data = root / "nusc_full"
    seeds = TRAIN_SEEDS + CLI_EXTRA_SEEDS + SERVING_SEEDS
    t0 = time.perf_counter()
    samples = nusc_samples(seeds)
    info = write_nuscenes_dataset(data, samples, "train")
    val = write_nuscenes_dataset(data, samples[:4], "val")
    size = sum(p.stat().st_size for p in data.rglob("*.bin"))
    log(f"CLI centerpoint_nusc: {len(seeds)} frames written in "
        f"{time.perf_counter() - t0:.2f} s ({size / 1e6:.1f} MB of .bin)")
    wd = root / "centerpoint_nusc_cli"
    argv = ["--preset", "centerpoint_nusc", "--data-root", str(data),
            "--info-path", str(info), "--batch-size", str(TRAIN_BATCH),
            "--epochs", "2", "--steps-per-epoch", "2", "--log-interval", "1",
            "--work-dir", str(wd), "--device", str(dev)]

    class Stop(Exception):
        pass

    def stop(runner):
        raise Stop

    def first_epoch():
        try:
            train_cli.main(argv, hooks=[Hook(0, "stop", after_epoch=stop)])
        except Stop:
            pass

    err = {"k1": 0.0, "k2": 0.0, "k1_bf16": 0.0}
    counts = {}
    got, e, _ = cli_launches("CLI centerpoint_nusc epoch 1", first_epoch)
    counts["cli_train_centerpoint_nusc"] = got
    err.update({k: max(err[k], v) for k, v in e.items()})
    got, _, runner = cli_launches("CLI centerpoint_nusc epoch 2 (resumed)",
                                  lambda: train_cli.main(argv), hold=False)
    for k, v in got.items():
        counts["cli_train_centerpoint_nusc"][k] += v
    c = counts["cli_train_centerpoint_nusc"]
    check((c["k1_fwd"], c["k1_bwd"], c["k2_fwd"], c["k1_bf16"])
          == (4 * K1_PER_FRAME, 4 * K1_BWD_PER_STEP, 0, 0),
          f"CLI centerpoint_nusc: launches {c} in 4 steps, expected "
          f"{K1_PER_FRAME} + {K1_BWD_PER_STEP} a step")
    logs = cli_logs(wd)
    check(len(logs) == 4 and all(np.isfinite(r["loss"]) for r in logs),
          f"CLI centerpoint_nusc: logs {logs}")
    check([t[0] for t in runner.timings] == [2, 3],
          f"CLI centerpoint_nusc: resumed steps {runner.timings}")
    log("CLI centerpoint_nusc (NVIDIA card, batch 4, 260k points a frame): "
        "per step data ms / step ms as the Runner logs them "
        + ", ".join(f"step {r['step']} {r['data_ms']:.1f} / "
                    f"{r['step_ms']:.1f}" for r in logs)
        + f"; losses {[round(r['loss'], 4) for r in logs]}; checkpoint "
        f"save {runner.ckpt_seconds[0]:.3f} s (epoch 2), restore "
        f"{runner.restore_seconds:.3f} s")

    for profile, per_frame in (("exact", (K1_PER_FRAME, 0)),
                               ("tpu_v5e", (K1_F32_PER_PROFILE_FRAME,
                                            K1_BF16_PER_FRAME))):
        out = root / f"metrics_{profile}.json"
        t0 = time.perf_counter()
        got, e, step = cli_launches(
            f"CLI test centerpoint_nusc {profile}",
            lambda: test_cli.main([
                "--preset", "centerpoint_nusc", "--data-root", str(data),
                "--info-path", str(val), "--ckpt", str(wd / "ckpt"),
                "--out", str(out), "--serving-profile", profile,
                "--device", str(dev)]), bf16=[])
        seconds = time.perf_counter() - t0
        err.update({k: max(err[k], v) for k, v in e.items()})
        check((got["k1_fwd"], got["k1_bf16"], got["k1_bwd"], got["k2_fwd"])
              == (4 * per_frame[0], 4 * per_frame[1], 0, 0),
              f"CLI test {profile}: launches {got} on 4 frames, expected "
              f"{per_frame} a frame")
        metrics = json.loads(out.read_text())
        check(step == 4 and metrics["step"] == 4
              and np.isfinite(metrics["mAP"]) and np.isfinite(metrics["NDS"]),
              f"CLI test {profile}: {step}, {metrics.get('mAP')}")
        counts[f"cli_test_centerpoint_nusc_{profile}"] = got
        log(f"CLI test centerpoint_nusc {profile}: 4 frames in "
            f"{seconds:.2f} s (the model's build and the launch checks "
            f"included), mAP {metrics['mAP']:.4f}, NDS "
            f"{metrics['NDS']:.4f} (random weights), metrics JSON written")
    return counts, err


def phase_cli_kitti_full(dev, root, pillow):
    """Phase 55: `voxel_rcnn_3ddf_kitti` at full width, batch 2, from disk:
    two KITTI frames with their cars and 375x1242 PNGs in image_2 (decoded
    and resized to 384x1280 by Pillow through `finalize_camera_sample`);
    the train CLI for 2 steps (2 epochs of one) with every K1 and K2
    launch held against its plain version (K1 12 + 11, K2 1 + 1 on its
    general path a step), then the test CLI once over both frames (K1 12,
    K2 1 a frame). Without Pillow on this machine, the same preset trains
    through the CLI's `--synthetic` (no image decoded) and the test CLI is
    not run. Returns the launch counts and the largest errors."""
    from df3d_torch.tools import test as test_cli
    from df3d_torch.tools import train as train_cli
    from df3d_torch.utils.synth import write_kitti_dataset

    data = root / "kitti_full"
    wd = root / "kitti_full_cli"
    common = ["--preset", "voxel_rcnn_3ddf_kitti", "--max-points", "40000",
              "--device", str(dev)]
    if pillow:
        info = write_kitti_dataset(data, kitti_samples(KITTI_TRAIN_BATCH),
                                   images=True,
                                   image_rng=np.random.RandomState(20))
        source = ["--data-root", str(data), "--info-path", str(info)]
    else:
        source = ["--synthetic", "--synthetic-points", "20000"]
        log("CLI voxel_rcnn_3ddf_kitti: Pillow is not installed here; the "
            "preset trains on the CLI's --synthetic samples instead")
    argv = common + source + [
        "--batch-size", str(KITTI_TRAIN_BATCH), "--epochs", "2",
        "--steps-per-epoch", "1", "--log-interval", "1", "--work-dir",
        str(wd)]
    counts, err = {}, {}
    got, e, runner = cli_launches("CLI voxel_rcnn_3ddf_kitti train",
                                  lambda: train_cli.main(argv))
    err.update(e)
    check((got["k1_fwd"], got["k1_bwd"], got["k2_fwd"], got["k2_bwd"])
          == (2 * K1_PER_KITTI_FRAME, 2 * K1_BWD_PER_KITTI_STEP, 2, 2),
          f"CLI voxel_rcnn_3ddf_kitti: launches {got} in 2 steps")
    counts["cli_train_voxel_rcnn_3ddf_kitti"] = got
    logs = cli_logs(wd)
    check(len(logs) == 2 and all(np.isfinite(r["loss"]) for r in logs),
          f"CLI voxel_rcnn_3ddf_kitti: logs {logs}")
    log("CLI voxel_rcnn_3ddf_kitti (batch 2"
        + (", 375x1242 PNGs resized to 384x1280" if pillow else
           ", --synthetic") + "): data ms / step ms "
        + ", ".join(f"step {r['step']} {r['data_ms']:.1f} / "
                    f"{r['step_ms']:.1f}" for r in logs)
        + f"; losses {[round(r['loss'], 4) for r in logs]}; checkpoint "
        f"save {[round(s, 3) for s in runner.ckpt_seconds]} s")
    if pillow:
        out = root / "metrics_kitti.json"
        got, e, step = cli_launches(
            "CLI test voxel_rcnn_3ddf_kitti",
            lambda: test_cli.main(common + source + [
                "--ckpt", str(wd / "ckpt"), "--out", str(out)]))
        err = {k: max(err[k], v) for k, v in e.items()}
        check((got["k1_fwd"], got["k2_fwd"], got["k1_bwd"])
              == (2 * K1_PER_KITTI_FRAME, 2, 0),
              f"CLI test voxel_rcnn_3ddf_kitti: launches {got} on 2 frames")
        metrics = json.loads(out.read_text())
        check(step == 2 and "Car_3d_moderate" in metrics,
              f"CLI test voxel_rcnn_3ddf_kitti: {sorted(metrics)[:5]}")
        counts["cli_test_voxel_rcnn_3ddf_kitti"] = got
        log(f"CLI test voxel_rcnn_3ddf_kitti: Car 3D AP moderate "
            f"{metrics['Car_3d_moderate']:.4f}, final recall at 0.7 "
            f"{metrics.get('final_recall_0.7', 0.0):.4f} (random weights)")
    return counts, err


# Dataset preparation and the remaining tools (phases 56-60): raw KITTI and
# nuScenes files written into the phases' temporary directory
# (`utils.synth.write_kitti_raw`, `write_nuscenes_raw`), turned into infos
# by `df3d_torch.tools.create_data`, then the train and test CLIs on them;
# the train CLI over 2 ranks, the demo and fit_caps
FIT_CAPS_SEEDS = (5, 6, 7)  # with TRAIN_SEEDS and CLI_EXTRA_SEEDS: 0-7
RAW_NUSC_VERSION = "v1.0-trainval"
# Phase 58's limits on each step of the 2-rank CLI run against a
# one-process step from the same state, in relative L2 (the step's update
# of the trainable parameters, its change of the batch statistics; on the
# card, with the first step's ReLU near ties replayed, the first step read
# 0.0034-0.056 and 8.8e-7-1.0e-6, the second 0.0021-0.0061 and
# 6.6e-7-8.1e-7), and on each statistic after the first step (phase 35's
# per-leaf bound); the controls (a step skipped: 1.0; sign-flipped: ~2)
# must fail the first two. The second step of the unbroken runs, which
# start it from weights that Adam's first signs on rounding noise set
# apart, read 0.072-0.20 and 7.5e-5-2.1e-3.
RANKS_STEP_L2 = (0.3, 1e-3)
RANKS_STAT_L2 = 1e-3
# phase 59: the tiny demo's replays of the CPU's top-k and NMS decisions on
# the card, each a near tie within 1e-4
DEMO_MAX_REPLAYS = 16


def jpeg_works(tmp):
    """Whether this machine's Pillow writes a JPEG and reads it back (one
    small colour gradient, its pixels within 3 of the original on the
    mean)."""
    from df3d_torch.data.images import decode_image, write_jpeg

    y, x = np.mgrid[0:90, 0:160]
    img = np.stack([x * 255 // 159, y * 255 // 89, np.full_like(x, 128)],
                   -1).astype(np.uint8)
    try:
        write_jpeg(tmp / "probe.jpg", img)
        back = decode_image(tmp / "probe.jpg")
    except (ImportError, OSError) as e:
        log(f"JPEG probe: {type(e).__name__}: {e}")
        return False
    return back.shape == img.shape and np.abs(
        back.astype(int) - img).mean() < 3


def phase_create_data_nusc(dev, root):
    """Phase 56: raw nuScenes tables for 8 samples (the ray-cast frames of
    TRAIN_SEEDS, CLI_EXTRA_SEEDS and SERVING_SEEDS, each a key frame and 9
    sweeps in their own LiDAR frames, six 1600x900 JPEG cameras on the
    rig of `utils.synth.camera_rig`, the scenes' boxes under raw nuScenes
    category names), `create_data nuscenes` on them, then the train CLI
    on `centerpoint_3ddf_nusc` (448x800 after the loader's resize, batch
    4) for 2 steps, every K1 and K2 launch held against its plain version
    (16 + 15 and 1 + 1 a step), each step's step ms beside its data ms
    (the loader's wait: 40 .bin reads and 24 JPEG decodes a batch), and
    the test CLI on 4 of the frames (K1 16, K2 1 a frame). Returns the
    launch counts by run and the largest errors."""
    from df3d_torch.data.images import read_image_shape
    from df3d_torch.data.nuscenes import NUSC_CLASSES
    from df3d_torch.tools import create_data
    from df3d_torch.tools import test as test_cli
    from df3d_torch.tools import train as train_cli
    from df3d_torch.utils.synth import NUSC_CATEGORY, write_nuscenes_raw

    data = root / "nusc_raw"
    data.mkdir()
    check(jpeg_works(data), "Pillow on this machine does not write and "
          "read JPEG; the raw nuScenes cameras are JPEGs (no PNG stand-in)")
    seeds = TRAIN_SEEDS + CLI_EXTRA_SEEDS + SERVING_SEEDS
    raw_names = [NUSC_CATEGORY[NUSC_CLASSES[c]] for c in SCENE_CLASSES]
    t0 = time.perf_counter()
    write_nuscenes_raw(data, [(raycast_frame(s), scene_boxes(s), raw_names)
                              for s in seeds], RAW_NUSC_VERSION,
                       image_rng=np.random.RandomState(30))
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    with quiet_stdout("create_data nuscenes"):
        infos = create_data.main(["nuscenes", "--root", str(data),
                                  "--version", RAW_NUSC_VERSION])
    convert_s = time.perf_counter() - t0
    info = data / f"df3d_nusc_infos_{RAW_NUSC_VERSION}.pkl"
    val = data / "infos_val.pkl"
    with open(val, "wb") as f:
        pickle.dump({"infos": infos[:4], "version": RAW_NUSC_VERSION}, f)
    check(len(infos) == 8 and all(
        len(i["sweeps"]) == 9 and len(i["cams"]) == 6
        and set(i["gt_names"]) == {"car", "truck", "pedestrian"}
        for i in infos), "create_data nuscenes: infos")
    cam = infos[0]["cams"]["CAM_FRONT"]
    check(read_image_shape(data / cam["data_path"]) == (900, 1600),
          "create_data nuscenes: the cameras are not 1600x900")
    size = sum(p.stat().st_size for p in data.rglob("*") if p.is_file())
    log(f"create_data nuscenes: 8 samples of raw tables, 80 .bin and 48 "
        f"1600x900 JPEGs written in {write_s:.2f} s ({size / 1e6:.1f} MB); "
        f"infos in {convert_s:.2f} s")

    wd = root / "create_data_nusc_cli"
    argv = ["--preset", "centerpoint_3ddf_nusc", "--data-root", str(data),
            "--info-path", str(info), "--batch-size", str(TRAIN_BATCH),
            "--epochs", "1", "--steps-per-epoch", "2", "--log-interval", "1",
            "--work-dir", str(wd), "--device", str(dev)]
    counts, err = {}, {}
    got, e, _ = cli_launches("create_data centerpoint_3ddf_nusc train",
                             lambda: train_cli.main(argv))
    err.update(e)
    check((got["k1_fwd"], got["k1_bwd"], got["k2_fwd"], got["k2_bwd"])
          == (2 * K1_PER_FRAME, 2 * K1_BWD_PER_STEP, 2, 2),
          f"create_data centerpoint_3ddf_nusc: launches {got} in 2 steps")
    counts["create_data_train_centerpoint_3ddf_nusc"] = got
    logs = cli_logs(wd)
    check(len(logs) == 2 and all(np.isfinite(r["loss"]) for r in logs),
          f"create_data centerpoint_3ddf_nusc: logs {logs}")
    log("create_data centerpoint_3ddf_nusc (batch 4, six 1600x900 JPEGs a "
        "sample decoded and resized to 448x800 by the loader's one thread)"
        ": data ms / step ms " + ", ".join(
            f"step {r['step']} {r['data_ms']:.1f} / {r['step_ms']:.1f}"
            for r in logs) + f"; losses {[round(r['loss'], 4) for r in logs]}")

    out = root / "metrics_create_data.json"
    t0 = time.perf_counter()
    got, e, step = cli_launches(
        "create_data test centerpoint_3ddf_nusc",
        lambda: test_cli.main(["--preset", "centerpoint_3ddf_nusc",
                               "--data-root", str(data), "--info-path",
                               str(val), "--ckpt", str(wd / "ckpt"),
                               "--out", str(out), "--device", str(dev)]))
    seconds = time.perf_counter() - t0
    err = {k: max(err.get(k, 0.0), v) for k, v in e.items()}
    check((got["k1_fwd"], got["k2_fwd"], got["k1_bwd"])
          == (4 * K1_PER_FRAME, 4, 0),
          f"create_data test centerpoint_3ddf_nusc: launches {got}")
    metrics = json.loads(out.read_text())
    check(step == 2 and np.isfinite(metrics["mAP"])
          and np.isfinite(metrics["NDS"]),
          f"create_data test: {step}, {metrics.get('mAP')}")
    counts["create_data_test_centerpoint_3ddf_nusc"] = got
    log(f"create_data test centerpoint_3ddf_nusc: 4 frames in {seconds:.2f} "
        f"s (the build and the launch checks included), mAP "
        f"{metrics['mAP']:.4f}, NDS {metrics['NDS']:.4f} (random weights)")
    return counts, err


def phase_create_data_kitti(dev, root):
    """Phase 57: raw KITTI files (4 frames of `make_kitti_sample`, their
    cars in label_2, 375x1242 PNGs), `create_data kitti
    --with-gt-database --with-image-crops` on them, then the train CLI on
    `voxel_rcnn_3ddf_kitti` (batch 2) for 2 steps, every K1 and K2 launch
    held against its plain version (12 + 11 and 1 + 1 a step). Returns
    the launch counts and the largest errors."""
    from df3d_torch.tools import create_data
    from df3d_torch.tools import train as train_cli
    from df3d_torch.utils.synth import KITTI_IMAGE as RAW, write_kitti_raw

    data = root / "kitti_raw"
    samples = kitti_samples(4)
    t0 = time.perf_counter()
    write_kitti_raw(data, samples, image_rng=np.random.RandomState(21))
    with quiet_stdout("create_data kitti"):
        infos = create_data.main(["kitti", "--root", str(data),
                                  "--with-gt-database", "--with-image-crops"])
    with open(data / "kitti_dbinfos_train.pkl", "rb") as f:
        db = pickle.load(f)["Car"]
    check(len(infos) == 4 and all(
        i["image"]["image_shape"].tolist() == list(RAW)
        and len(i["annos"]["name"]) == len(s[1])
        and {"location", "dimensions", "rotation_y"} <= set(i["annos"])
        for i, s in zip(infos, samples)), "create_data kitti: infos")
    crops = sum("image_crop_path" in d for d in db)
    check(len(db) > 0 and crops > 0, f"create_data kitti: {len(db)} gt "
          f"objects, {crops} crops")
    log(f"create_data kitti: 4 frames, {sum(len(s[1]) for s in samples)} "
        f"labelled cars, gt database of {len(db)} objects ({crops} image "
        f"crops, {sum(d['num_points'] for d in db)} points) in "
        f"{time.perf_counter() - t0:.2f} s")

    wd = root / "create_data_kitti_cli"
    argv = ["--preset", "voxel_rcnn_3ddf_kitti", "--max-points", "40000",
            "--device", str(dev), "--data-root", str(data), "--info-path",
            str(data / "kitti_infos_train.pkl"), "--batch-size",
            str(KITTI_TRAIN_BATCH), "--epochs", "1", "--steps-per-epoch",
            "2", "--log-interval", "1", "--work-dir", str(wd)]
    got, err, _ = cli_launches("create_data voxel_rcnn_3ddf_kitti train",
                               lambda: train_cli.main(argv))
    check((got["k1_fwd"], got["k1_bwd"], got["k2_fwd"], got["k2_bwd"])
          == (2 * K1_PER_KITTI_FRAME, 2 * K1_BWD_PER_KITTI_STEP, 2, 2),
          f"create_data voxel_rcnn_3ddf_kitti: launches {got} in 2 steps")
    logs = cli_logs(wd)
    check(len(logs) == 2 and all(np.isfinite(r["loss"]) for r in logs),
          f"create_data voxel_rcnn_3ddf_kitti: logs {logs}")
    log("create_data voxel_rcnn_3ddf_kitti (batch 2, 375x1242 PNGs): data "
        "ms / step ms " + ", ".join(f"step {r['step']} {r['data_ms']:.1f} / "
                                    f"{r['step_ms']:.1f}" for r in logs)
        + f"; losses {[round(r['loss'], 4) for r in logs]}")
    return {"create_data_train_voxel_rcnn_3ddf_kitti": got}, err


RELU_TIE_BAND = 1e-4  # phase 58: a ReLU input this close to 0 is a near tie


@contextlib.contextmanager
def relu_near_ties(store, shard=None, band=RELU_TIE_BAND):
    """Patch `torch.relu` as `relu_decisions` does, for its near ties
    only: record each call's input size and the positions and signs of
    its inputs within `band` of 0 but not 0 (a padded row's inputs are 0
    on every rank) in `store`, in call order; or, with
    `shard` = (rank, world), give this rank's inputs the recorded sign
    where theirs differs, at their own magnitude. A rank of a loader
    shard holds the global batch's rows rank, rank + world, ...: a call
    whose rows are the recorded call's divided by `world` takes those
    rows of the record, any other call all of it. Yields the replays,
    (elements, largest |x|) per call that had any."""
    relu, flips = torch.relu, []
    recorded = iter(store)

    def patched(x):
        z = x.detach()
        if shard is None:
            near = ((z.abs() < band) & (z != 0)).nonzero()
            store.append((tuple(z.shape), near.cpu(),
                          (z[tuple(near.T)] > 0).cpu()))
            return relu(x)
        shape, near, want = next(recorded)
        rank, world = shard
        if shape != tuple(z.shape):
            check(shape[0] == z.shape[0] * world and shape[1:] == z.shape[1:],
                  f"ReLU near ties: a call of {tuple(z.shape)} against the "
                  f"recorded {shape}")
            keep = near[:, 0] % world == rank
            near, want = near[keep].clone(), want[keep]
            near[:, 0] //= world
        idx = tuple(near.to(z.device).T)
        want = want.to(z.device)
        at = z[idx]
        flip = (at > 0) != want
        if not flip.any():
            return relu(x)
        flips.append((int(flip.sum()), float(at[flip].abs().max())))
        nudge = torch.zeros_like(z)
        nudge[idx] = torch.where(flip, torch.where(want, at.abs(),
                                                   -at.abs()) - at, 0.0)
        return relu(x + nudge)

    torch.relu = patched
    try:
        yield flips
    finally:
        torch.relu = relu


class RankRecord:
    """A train-CLI hook that every rank of phase 58 runs: the first step
    under `relu_near_ties` replaying this rank's rows of the one-process
    run's near ties (read from `ties_path`), the second step's host-clock
    split (`stages.recording`, with the all-reduces' `allreduce` stage),
    the steps' ms and the rank's kernel launch counts (the ranks are new
    processes: counted from 0), saved with the replays to
    `out_dir/rank<r>.pt` after the last step."""

    def __init__(self, out_dir, steps, ties_path):
        self.out_dir, self.steps = str(out_dir), steps
        self.ties_path = str(ties_path)
        self.rec, self.split, self.ms, self.t0 = None, None, [], None
        self.ties, self.flips = None, None

    @staticmethod
    def _sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def before_epoch(self, runner):
        if self.t0 is None:
            dist = torch.distributed
            self.ties = relu_near_ties(
                torch.load(self.ties_path),
                (dist.get_rank(), dist.get_world_size()))
            self.flips = self.ties.__enter__()
            self._sync()
            self.t0 = time.perf_counter()

    def __call__(self, runner):
        from df3d_torch.ops import msda_kernel as K2
        from df3d_torch.ops import sparse_conv_kernel as K1
        from df3d_torch.utils import stages

        self._sync()
        now = time.perf_counter()
        self.ms.append(1e3 * (now - self.t0))
        self.t0 = now
        step = runner.global_step  # steps taken
        if step == 1:
            self.ties.__exit__(None, None, None)
        if self.rec is not None:
            self.rec.__exit__(None, None, None)
            self.rec = None
        if step == self.steps - 1:  # record the last step
            self.rec = stages.recording()
            self.split = self.rec.__enter__()
        if step == self.steps:
            torch.save({"ms": self.ms, "split": dict(self.split),
                        "flips": self.flips,
                        "counts": dict(k1_fwd=K1.launches,
                                       k1_bwd=K1.bwd_launches,
                                       k2_fwd=K2.launches,
                                       k2_bwd=K2.bwd_launches)},
                       Path(self.out_dir)
                       / f"rank{torch.distributed.get_rank()}.pt")


def phase_cli_ranks(dev, root):
    """Phase 58: the train CLI over 2 ranks sharing the card (`--nprocs 2`:
    gloo, as phase 34), `centerpoint_nusc` at global batch 4 (2 samples a
    rank) for 2 steps (2 epochs of one: phase 54's four val frames),
    against the one-process CLI on the same infos and global batch. Each
    step is held against a one-process step from the same state: the
    first against the one-process run's first step, the second against
    the one-process CLI resumed from the 2-rank run's own step-1
    checkpoint (after the first step the runs part, as phase 53's do:
    Adam's first update of a gradient of rounding noise takes either
    sign, and the second step of an unbroken one-process run read 7.5e-5
    to 2.1e-3 in its statistics' change). Held: each step's logs within
    rtol 1e-4 (cap overflow equal); after the first step every batch
    statistic within RANKS_STAT_L2 of the one process's in relative L2
    (phase 35's bound); each step's update of the trainable parameters
    and its change of the batch statistics within RANKS_STEP_L2 in
    relative L2, with the controls of a skipped and a sign-flipped step
    failing them. The second step of the unbroken one-process run is
    printed beside it. In the first step each rank replays the one process's
    ReLU decisions at near ties on its rows (`relu_near_ties`, inputs
    within RELU_TIE_BAND of 0; at most `relu_flip_limit` of the step's
    ReLU inputs, as phase 53).
    Each rank launches K1 16 + 15 a step; a rank's ms/step and its split
    with the `allreduce` stage are printed (two ranks on one card take
    turns on it: not a two-card number). Returns each rank's counts."""
    from df3d_torch.tools import train as train_cli
    from df3d_torch.train.loop import Hook

    data = root / "nusc_full"
    info = data / "infos_val.pkl"
    check(info.exists(), "phase 58 reads phase 54's frames")
    argv = ["--preset", "centerpoint_nusc", "--data-root", str(data),
            "--info-path", str(info), "--batch-size", str(TRAIN_BATCH),
            "--epochs", "2", "--steps-per-epoch", "1", "--log-interval", "1",
            "--device", str(dev)]
    initial, ties, recording = {}, [], []

    def first_step(runner):  # the initial state; the step's near ties
        if not initial:
            initial.update({k: v.detach().cpu().clone() for k, v in
                            runner.state.model.state_dict().items()})
            recording.append(relu_near_ties(ties))
            recording[0].__enter__()

    def after_step(runner):
        if runner.global_step == 1:
            recording[0].__exit__(None, None, None)

    t0 = time.perf_counter()
    with quiet_stdout("CLI 1 process"):
        one = train_cli.main(argv + ["--work-dir", str(root / "ranks_one")],
                             hooks=[Hook(0, "ties", before_epoch=first_step,
                                         after_iter=after_step)])
    one_s = time.perf_counter() - t0
    ties_path = root / "ranks_ties.pt"
    torch.save(ties, ties_path)
    n_inputs = sum(int(np.prod(shape)) for shape, _, _ in ties)
    flip_limit = max(4, -(-4 * n_inputs // 2**20))
    trainable = [n for n, _ in one.state.model.named_parameters()
                 if _.requires_grad]
    del one
    torch.cuda.empty_cache()
    out_dir = root / "ranks_out"
    out_dir.mkdir()
    record = RankRecord(out_dir, 2, ties_path)
    t0 = time.perf_counter()
    with quiet_stdout("CLI 2 ranks"):
        train_cli.main(argv + ["--work-dir", str(root / "ranks_two"),
                               "--nprocs", "2"],
                       hooks=[Hook(0, "record", after_iter=record,
                                   before_epoch=record.before_epoch)])
    two_s = time.perf_counter() - t0
    ranks = [torch.load(out_dir / f"rank{r}.pt") for r in range(DP_WORLD)]
    for r, got in enumerate(ranks):
        check(got["counts"] == dict(k1_fwd=2 * K1_PER_FRAME,
                                    k1_bwd=2 * K1_BWD_PER_STEP, k2_fwd=0,
                                    k2_bwd=0),
              f"CLI rank {r}: launches {got['counts']} in 2 steps")
        check(sum(n for n, _ in got["flips"]) <= flip_limit,
              f"CLI rank {r}: ReLU near ties replayed beyond {flip_limit}: "
              f"{got['flips']}")
        log(f"CLI rank {r} of 2 sharing one card (not a two-card number): "
            f"ms/step {[round(x, 3) for x in got['ms']]} (from one step's "
            "end to the next's: the first with the rank's cuDNN algorithm "
            "search, each with its epoch's first batch, the second with "
            "rank 0's checkpoint); the second step's split (ms, host "
            f"clock, synchronised): " + ", ".join(
                f"{k} {v:.3f}" for k, v in got["split"].items())
            + f"; launches {got['counts']}; first step's ReLU near ties "
            f"replayed {sum(n for n, _ in got['flips'])} (limit {flip_limit}"
            f", {sum(len(n) for _, n, _ in ties)} recorded within "
            f"{RELU_TIE_BAND} of {n_inputs} inputs)")

    def states(wd):
        out = [initial]
        for s in (1, 2):
            blob = torch.load(Path(wd) / "ckpt" / f"step_{s:08d}",
                              map_location="cpu", weights_only=True)
            out.append(blob["model"])
        return out

    # the second step's reference: the one-process CLI resumed from the
    # 2-rank run's step-1 checkpoint (same weights, moments and epoch)
    resumed = root / "ranks_resumed"
    (resumed / "ckpt").mkdir(parents=True)
    (resumed / "ckpt" / "step_00000001").write_bytes(
        (root / "ranks_two" / "ckpt" / "step_00000001").read_bytes())
    t0 = time.perf_counter()
    with quiet_stdout("CLI 1 process from the 2 ranks' step 1"):
        train_cli.main(argv + ["--work-dir", str(resumed)])
    resumed_s = time.perf_counter() - t0
    c, g = states(root / "ranks_one"), states(root / "ranks_two")
    r2 = torch.load(resumed / "ckpt" / "step_00000002", map_location="cpu",
                    weights_only=True)["model"]
    stats = [k for k in c[1] if k.endswith(("running_mean", "running_var"))]
    over = []
    for k in stats:
        err, norm = ((g[1][k] - c[1][k]).double().norm().item(),
                     c[1][k].double().norm().item())
        if err > RANKS_STAT_L2 * norm + 1e-6 * c[1][k].numel() ** 0.5:
            over.append(f"{k}: L2 gap {err:.4g}, L2 {norm:.4g}")
    check(not over, "CLI 2 ranks: statistics after step 1: "
          + "; ".join(over[:10]))
    c_logs, g_logs = cli_logs(root / "ranks_one"), cli_logs(root
                                                            / "ranks_two")
    r_logs = cli_logs(resumed)
    check(len(c_logs) == len(g_logs) == 2 and len(r_logs) == 1,
          "CLI 2 ranks: two logged steps, one resumed")
    for i, (a, b) in enumerate(zip((c_logs[0], r_logs[0]), g_logs)):
        for k, v in a.items():
            if k.endswith("_ms") or k in ("epoch", "step"):
                continue
            check(np.isfinite(b[k]), f"CLI 2 ranks step {i}: {k} {b[k]}")
            check(abs(b[k] - v) <= 1e-4 * abs(v) if k != "cap_overflow"
                  else b[k] == v,
                  f"CLI 2 ranks step {i}: {k} {b[k]} against {v}")

    def change(after, before, keys):
        return torch.cat([(after[k] - before[k]).double().flatten()
                          for k in keys])

    # (reference after, reference before) of each step: the same state
    refs = {1: (c[1], c[0]), 2: (r2, g[1])}
    unbroken = []
    for what, keys in (("update", trainable), ("statistics", stats)):
        gap = rel_l2(change(g[2], g[1], keys), change(c[2], c[1], keys))
        unbroken.append(f"{what} {gap:.4g}")
    readings = []
    for s in (1, 2):
        for what, keys, limit in (("update", trainable, RANKS_STEP_L2[0]),
                                  ("statistics", stats, RANKS_STEP_L2[1])):
            ref = change(*refs[s], keys)
            runs = {"2 ranks": change(g[s], g[s - 1], keys),
                    "step skipped": torch.zeros_like(ref),
                    "step sign-flipped": -change(g[s], g[s - 1], keys)}
            got = {run: rel_l2(x, ref) for run, x in runs.items()}
            readings.append(f"step {s} {what} " + ", ".join(
                f"{run} {v:.4g}" for run, v in got.items())
                + f" (limit {limit})")
            check(got["2 ranks"] <= limit,
                  f"CLI 2 ranks: step {s}'s {what} differs from the one "
                  f"process's by {got['2 ranks']} in relative L2 > {limit}")
            for run, v in got.items():
                check(run == "2 ranks" or v > limit,
                      f"CLI 2 ranks: control '{run}' passes {limit} ({v})")
    log(f"CLI 2 ranks against 1 process (centerpoint_nusc, global batch 4, "
        f"2 steps; {one_s:.1f} s and {two_s:.1f} s with the ranks' start, "
        f"{resumed_s:.1f} s for the resumed step): losses "
        f"{[round(r['loss'], 6) for r in g_logs]} (1 process "
        f"{[round(r['loss'], 6) for r in (c_logs[0], r_logs[0])]}); "
        f"{len(stats)} statistics within {RANKS_STAT_L2} after step 1; "
        "relative L2 against the one process from the same state: "
        + "; ".join(readings) + "; step 2 against the unbroken one-process "
        "run (not held): " + ", ".join(unbroken))
    return [r["counts"] for r in ranks]


def phase_demo(dev, root):
    """Phase 59: the demo on the card. `centerpoint_nusc` on one 260k-point
    .bin (serving frame 100) with the checkpoint phase 54's train CLI
    wrote: its detections equal the test CLI's eval step on the same
    frame and weights (`tools.test.build_eval`; the eval step's top-k and
    NMS decisions replayed at near ties within 1e-4; boxes and scores
    within phase 3's 1e-3 * |ref| + 1e-3), K1 16 launches, each held
    against its plain version. Then `centerpoint_tiny_smoke` (seed-0
    weights) on 20000 of the frame's points on the card against the CPU:
    equal kept sets and labels, boxes and scores to 1e-3, the CPU's
    decisions replayed at near ties (at most DEMO_MAX_REPLAYS, each within
    1e-4). Returns the launch counts and the largest errors."""
    import argparse

    from df3d_torch.config import get_preset
    from df3d_torch.tools import demo
    from df3d_torch.tools import test as test_cli
    from df3d_torch.tools.train import make_collate, to_device
    from df3d_torch.train.checkpoint import restore_latest

    frame = raycast_frame(SERVING_SEEDS[0])
    path = root / "frame.bin"
    frame.tofile(path)
    ckpt_dir = root / "centerpoint_nusc_cli" / "ckpt"
    args = argparse.Namespace(image_shape=None, aux_loss=False, tta=None,
                              serving_profile="exact")
    state, eval_step, cfg, _, _ = test_cli.build_eval(
        args, get_preset("centerpoint_nusc"), dev)
    _, step = restore_latest(ckpt_dir, state)
    batch = make_collate(None, NUM_POINTS, 500, 5)([{"points": frame}])
    store = []
    with centerpoint_decisions(store, False):
        want = to_cpu(eval_step(to_device(batch, dev)))
    del state, eval_step

    def run_demo(argv, device, replay):
        t = time.perf_counter()
        with centerpoint_decisions(store, replay) as replays:
            det = demo.main(argv + ["--device", str(device)])
        return det, replays, time.perf_counter() - t

    got_counts, err, (det, replays, seconds) = cli_launches(
        "demo centerpoint_nusc", lambda: run_demo(
            ["--preset", "centerpoint_nusc", "--bin", str(path), "--ckpt",
             str(ckpt_dir)], dev, True))
    check(got_counts["k1_fwd"] == K1_PER_FRAME and got_counts["k1_bwd"] == 0,
          f"demo centerpoint_nusc: launches {got_counts}")
    check(all(gap < 1e-4 for *_, gap in replays),
          f"demo centerpoint_nusc: decisions differ beyond near ties "
          f"{replays}")
    m = want["valid"][0].numpy()
    check(np.array_equal(det["valid"], m)
          and np.array_equal(det["labels"][m], want["labels"][0][m].numpy()),
          "demo centerpoint_nusc: kept sets or labels differ from the test "
          "CLI's eval step")
    # within phase 3's 1e-3 * |ref| + 1e-3 (a few steps from random weights
    # leave box sizes of ~1e9, exponentials of the head's outputs; the
    # voxels' mean features sum with atomics, so two runs on one card
    # round apart): the largest gap as a share of that bound
    gap = max(float((np.abs(det[k][m] - want[k][0][m].numpy())
                     / (1e-3 * np.abs(want[k][0][m].numpy()) + 1e-3)).max(
        initial=0.0)) for k in ("boxes", "scores"))
    check(gap <= 1, f"demo centerpoint_nusc: boxes or scores {gap} times "
          "1e-3 * |ref| + 1e-3 from the test CLI's eval step")
    log(f"demo centerpoint_nusc (checkpoint step {step}, 260k points): "
        f"{int(m.sum())} kept detections equal to the test CLI's eval step "
        f"(largest gap {gap:.3g} of 1e-3 * |ref| + 1e-3, replays "
        f"{replays}); the demo's run {seconds:.3f} s (the model's build, "
        "the checkpoint's restore, the .bin read, one frame); K1 "
        f"{got_counts['k1_fwd']} launches")

    small = frame[np.linspace(0, len(frame) - 1, 20000).astype(int)]
    small_path = root / "frame_small.bin"
    small.tofile(small_path)
    argv = ["--preset", "centerpoint_tiny_smoke", "--bin", str(small_path),
            "--score-thresh", "0.0"]
    store = []
    with quiet_stdout("demo centerpoint_tiny_smoke CPU"):
        cpu, _, _ = run_demo(argv, "cpu", False)
    tiny_counts, e, (card, replays, _) = cli_launches(
        "demo centerpoint_tiny_smoke", lambda: run_demo(argv, dev, True))
    err = {k: max(err.get(k, 0.0), v) for k, v in e.items()}
    n_replayed = sum(n for _, n, _ in replays)
    check(n_replayed <= DEMO_MAX_REPLAYS
          and all(gap < 1e-4 for *_, gap in replays),
          f"demo centerpoint_tiny_smoke: replays {replays}")
    check(tiny_counts["k1_fwd"] == K1_PER_FRAME,
          f"demo centerpoint_tiny_smoke: launches {tiny_counts}")
    m = cpu["valid"]
    check(np.array_equal(card["valid"], m)
          and np.array_equal(card["labels"][m], cpu["labels"][m]),
          "demo centerpoint_tiny_smoke: kept sets or labels differ")
    gap = max(float(np.abs(card[k][m] - cpu[k][m]).max(initial=0.0))
              for k in ("boxes", "scores"))
    check(gap <= 1e-3, f"demo centerpoint_tiny_smoke: card {gap} from CPU")
    log(f"demo centerpoint_tiny_smoke, card against CPU: {int(m.sum())} "
        f"kept detections, largest gap {gap:.3g}, {n_replayed} decisions "
        f"replayed ({replays})")
    return {"demo_centerpoint_nusc": got_counts,
            "demo_centerpoint_tiny_smoke": tiny_counts}, err


def phase_fit_caps(dev):
    """Phase 60: fit_caps on the card, `centerpoint_nusc --synthetic
    --frames 8` (ray-cast frames 0-7, cast once a run), its plans built on
    the card; each frame's four occupancies equal the CPU's
    (`fit_caps.stage_occupancy` on the CPU), integers, exactly. Prints the
    fitted caps beside bench.py's REALISTIC_STAGE_CAPS."""
    from df3d_torch.config import get_preset
    from df3d_torch.tools import fit_caps

    cast = fit_caps.synthetic_frame

    def cached(seed, n_points, extra):
        check((n_points, extra) == (NUM_POINTS, 2),
              f"fit_caps asked for {n_points} points, {extra} features")
        return raycast_frame(seed)

    fit_caps.synthetic_frame = cached
    try:
        t0 = time.perf_counter()
        with quiet_stdout("fit_caps"):
            out = fit_caps.main(["--preset", "centerpoint_nusc",
                                 "--synthetic", "--frames", "8",
                                 "--max-points", str(NUM_POINTS),
                                 "--device", str(dev)])
        card_s = time.perf_counter() - t0
    finally:
        fit_caps.synthetic_frame = cast
    cfg = get_preset("centerpoint_nusc")
    t0 = time.perf_counter()
    with torch.no_grad():
        cpu = np.stack([fit_caps.stage_occupancy(cfg, raycast_frame(s),
                                                 NUM_POINTS, "cpu")
                        for s in range(8)])
    cpu_s = time.perf_counter() - t0
    check(np.array_equal(out["per_frame"], cpu),
          f"fit_caps: the card's occupancies {out['per_frame'].tolist()} "
          f"differ from the CPU's {cpu.tolist()}")
    log(f"fit_caps centerpoint_nusc --synthetic --frames 8 on the card "
        f"({card_s:.2f} s; the CPU's {cpu_s:.2f} s): occupancies equal the "
        f"CPU's, per stage max "
        f"{out['per_frame'].max(0).tolist()}, mean "
        f"{[round(float(v), 1) for v in out['per_frame'].mean(0)]}; fitted "
        f"caps {out['stage_caps']} (p99 x 1.05) beside bench.py's "
        f"REALISTIC_STAGE_CAPS {list(REALISTIC_STAGE_CAPS)}")


# PV-RCNN, PointPillars and the TransFusion LC decoder (phases 61-63).
# PV-RCNN serves KITTI frames (the seeds of `kitti_frames`, with their
# scenes' cars); its K1 launches a frame are Voxel R-CNN's 12
PV_RCNN_SEEDS = (100, 101, 102)
# the LC decoder's cameras and their feature maps: 448x800 images at the
# image branch's stride 4, 256 channels (transfusion_3ddf_nusc's FPN P2)
LC_CAMS, LC_FEATURE_HW, LC_CHANNELS = 6, (112, 200), 256
LC_TIMED_RUNS = 5


def small_pvrcnn_config():
    """tests/test_torch_pvrcnn.py's tiny PV-RCNN, wider: the 64x64 grid,
    128 keypoints, every VSA scale, 16 RoIs on a 3^3 grid."""
    from df3d_torch.models.detectors.pv_rcnn import PVRCNNConfig
    from df3d_torch.models.detectors.voxel_rcnn import VoxelRCNNConfig
    from df3d_torch.models.pfe import VSAConfig, VSAScaleCfg

    base = VoxelRCNNConfig(
        pc_range=(0.0, -16.0, -2.4, 32.0, 16.0, 2.4),
        voxel_size=(0.5, 0.5, 0.2), grid_size=(24, 64, 64), max_voxels=512,
        stage_caps=(512, 384, 256, 128), test_pre_nms=128, test_post_nms=16)
    scales = tuple(VSAScaleCfg(k, ds, r, nsample=8, mlp=(16, 16))
                   for k, ds, r in (("conv1", 1, 0.8), ("conv2", 2, 1.2),
                                    ("conv3", 4, 1.6), ("conv4", 8, 2.4)))
    return PVRCNNConfig(
        base=base, vsa=VSAConfig(num_keypoints=128, raw_radius=1.0,
                                 raw_nsample=8, scales=scales,
                                 out_channels=32),
        roi_grid_size=3, roi_max_local=64, roi_radius=2.0, roi_nsample=8)


def phase_pvrcnn_small(dev):
    """PV-RCNN's path on a small input (`small_pvrcnn_config`, two samples
    of 1500 points, half of them in clusters), card against CPU, the same
    weights: the card replays the CPU's proposal and final NMS and RoI
    neighbour decisions where its own differ, each a near tie within 1e-4,
    at most 4 calls (`voxelrcnn_decisions`). Keypoints, cap overflows,
    roi_mask, valid and labels equal; keypoint features, fg logits, RoIs,
    the head's cls and reg, boxes and scores to atol = rtol = 1e-3."""
    from df3d_torch.entry import build_pvrcnn, infer_pvrcnn
    from df3d_torch.models.detectors import pv_rcnn as PV

    cfg = small_pvrcnn_config()
    rng = np.random.RandomState(0)
    n = 1500
    pts = np.concatenate([rng.uniform(0, 31, (2, n, 1)),
                          rng.uniform(-15, 15, (2, n, 1)),
                          rng.uniform(-1.8, 1.8, (2, n, 1)),
                          rng.uniform(0, 1, (2, n, 1))], -1)
    centres = np.array([[8.0, 0.0, 0.0], [20.0, 5.0, -0.5], [12.0, -8.0, 0.5],
                        [25.0, 10.0, 0.0]])
    pts[:, n // 2:, :3] = (centres[rng.randint(0, 4, (2, n - n // 2))]
                           + 0.6 * rng.randn(2, n - n // 2, 3))
    pts = torch.from_numpy(pts.astype(np.float32))
    valid = torch.ones(pts.shape[:2], dtype=torch.bool)
    store, out = [], []
    for d, replay in (("cpu", False), (dev, True)):
        model, head = build_pvrcnn(cfg, d)
        with voxelrcnn_decisions(store, replay, PV) as replays:
            out.append(to_cpu(infer_pvrcnn(model, head, cfg, pts.to(d),
                                           valid.to(d))))
    (c_det, c_ov), (g_det, g_ov) = out
    check(len(replays) <= 4 and all(g < 1e-4 for *_, g in replays),
          f"small PV-RCNN: more than 4 decisions differ from the CPU's, or "
          f"one is no tie within 1e-4: {replays}")
    for k in c_ov:
        check(torch.equal(c_ov[k], g_ov[k]), f"small PV-RCNN: {k} differs")
    for k in ("keypoints", "roi_mask", "valid", "labels"):
        check(torch.equal(c_det[k], g_det[k]), f"small PV-RCNN: {k} differs")
    check(bool(c_det["roi_mask"].any()), "small PV-RCNN: no RoI")
    worst = 0.0
    for k, t in c_det.items():
        if t.is_floating_point():
            check(bool(torch.isfinite(g_det[k]).all()),
                  f"small PV-RCNN: non-finite {k}")
            torch.testing.assert_close(g_det[k], t, atol=1e-3, rtol=1e-3)
            worst = max(worst, (g_det[k] - t).abs().max().item())
    log(f"small PV-RCNN, card against CPU: keypoints equal, "
        f"{len(store)} NMS and neighbour decisions recorded, replays "
        f"{replays}; {int(c_det['roi_mask'].sum())} RoIs and "
        f"{int(c_det['valid'].sum())} kept boxes equal; max diff of the "
        f"keypoint features, fg logits, RoIs, RCNN head, boxes and scores "
        f"{worst:.3g}")


def phase_pvrcnn(dev):
    """Phase 61: PV-RCNN. The small input card against CPU
    (`phase_pvrcnn_small`); then `PVRCNNConfig()` at full KITTI width
    (0.05 m voxels, 16 000 voxels, stage caps 16k/12k/8k/4k, 2048
    keypoints over the frame's points, 100 RoIs) on the three KITTI frames
    of `make_kitti_sample` (seeds `PV_RCNN_SEEDS`, the frames of
    `kitti_frames`): every K1 launch of one frame against its plain
    version (`phase_k1`, 12 a frame), then the path timed on the three
    frames (`timed_path`: K1 12 and K2 0 launches a frame, the stage split
    voxelize, backbone_3d, neck, rpn, pfe_fps, pfe_ball_query,
    pfe_bev_sample, point_head, proposal, roi_head, post, a one-frame
    profile, peak memory), and each frame's keypoints labelled against its
    cars (`point_fg_labels`) with the point loss finite. Returns (K1's
    entry at PV-RCNN's shapes, the timed launches)."""
    from df3d_torch.entry import build_pvrcnn, infer_pvrcnn
    from df3d_torch.models.detectors.pv_rcnn import PVRCNNConfig
    from df3d_torch.models.heads.point_head import (
        point_cls_loss, point_fg_labels,
    )
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1
    from df3d_torch.utils.synth import make_kitti_sample

    phase_pvrcnn_small(dev)
    cfg = PVRCNNConfig()
    model, head = build_pvrcnn(cfg, dev, seed=0)
    samples = [make_kitti_sample(np.random.RandomState(s))
               for s in PV_RCNN_SEEDS]
    frames = [s[0] for s in samples]
    run = lambda m, c, p, v: infer_pvrcnn(m, head, c, p, v)
    k1 = phase_k1(model, cfg, frames[0], dev, run, edge_cases=False,
                  per_frame=K1_PER_KITTI_FRAME)
    inputs = [kitti_inputs(f, KITTI_IMAGE, dev, 10 + i)[:2]
              for i, f in enumerate(frames)]
    stats = {}
    launches = timed_path("KITTI PV-RCNN path",
                          lambda *a: run(model, cfg, *a),
                          cfg.base.final_max_boxes, inputs, len(frames),
                          {K1: K1_PER_KITTI_FRAME, K2: 0}, box_dim=7,
                          stats=stats)
    for i, ((pts, valid), (_, boxes, _, bvalid)) in enumerate(
            zip(inputs, samples)):
        det, _ = run(model, cfg, pts, valid)
        gt = torch.from_numpy(boxes[None]).to(dev)
        labels = point_fg_labels(det["keypoints"], gt,
                                 torch.from_numpy(bvalid[None]).to(dev))
        loss = point_cls_loss(det["point_fg_logits"], labels)
        check(bool(torch.isfinite(loss)), f"PV-RCNN frame {i}: point loss")
        check(bool(torch.isfinite(det["kp_feats"]).all()),
              f"PV-RCNN frame {i}: non-finite keypoint features")
        n = pts.shape[1]
        log(f"PV-RCNN frame {i}: {n} points, FPS of "
            f"{cfg.vsa.num_keypoints} keypoints (sequential steps), ball "
            f"queries over {cfg.vsa.num_keypoints} x {n} raw pairs and the "
            f"four stages' rows; {int(labels.sum())} keypoints inside "
            f"{int(bvalid.sum())} cars (enlarged 0.2 m), point loss "
            f"{loss.item():.4f}; {int(det['roi_mask'].sum())} RoIs, "
            f"{int(det['valid'].sum())} kept boxes")
    split = stats["split"]
    pfe = sum(v for k, v in split.items() if k.startswith("pfe"))
    log(f"PV-RCNN per frame: {stats['ms']:.3f} ms, peak "
        f"{stats['peak_gib']:.3f} GiB, device kernels {stats['busy_ms']:.3f} "
        f"of {stats['wall_ms']:.3f} ms (idle share {stats['idle']:.3f}); "
        f"pfe {pfe:.3f} ms of the split (fps {split.get('pfe_fps', 0):.3f}, "
        f"ball queries {split.get('pfe_ball_query', 0):.3f}, BEV sample "
        f"{split.get('pfe_bev_sample', 0):.3f})")
    return k1, launches


def pillar_inputs(points, cfg):
    """A frame (N, F) -> the pillars PointPillars takes, as numpy: (V, P, F)
    points, (V,) counts, (V, 3) (z, y, x) coords, V = max_voxels and P =
    max_points_per_voxel: the first P points of each pillar in frame
    order, the pillars in key order (y * X + x), -1 rows padding (the JAX
    package has no pillar voxelizer; its tests build pillars so)."""
    vs, pcr = np.asarray(cfg.voxel_size), np.asarray(cfg.pc_range)
    _, gy, gx = cfg.grid_size
    v, p = cfg.max_voxels, cfg.max_points_per_voxel
    ij = np.floor((points[:, :2] - pcr[:2]) / vs[:2]).astype(np.int64)
    ok = (((ij >= 0) & (ij < [gx, gy])).all(1) & (points[:, 2] >= pcr[2])
          & (points[:, 2] < pcr[5]))
    pts, keys = points[ok], ij[ok, 1] * gx + ij[ok, 0]
    order = np.argsort(keys, kind="stable")
    keys, pts = keys[order], pts[order]
    uniq, start, counts = np.unique(keys, return_index=True,
                                    return_counts=True)
    row = np.repeat(np.arange(len(uniq)), counts)
    rank = np.arange(len(keys)) - start[row]
    keep = (rank < p) & (row < v)
    out = np.zeros((v, p, points.shape[1]), np.float32)
    out[row[keep], rank[keep]] = pts[keep]
    n = min(len(uniq), v)
    num = np.zeros(v, np.int32)
    num[:n] = np.minimum(counts[:n], p)
    coords = -np.ones((v, 3), np.int32)
    coords[:n] = np.stack([np.zeros(n), uniq[:n] // gx, uniq[:n] % gx], 1)
    return out, num, coords


def phase_pointpillars(dev):
    """Phase 62: PointPillars at full width (`PointPillarConfig()`: KITTI's
    432 x 496 pillars of 0.16 m, 16 000 pillars of 32 points, the 3/5/5
    neck, 248 x 216 x 2 anchors) on `PV_RCNN_SEEDS`' frames, their pillars
    built with numpy (`pillar_inputs`): the card against the CPU on the
    first frame, same weights (anchor-head maps to atol = rtol = 1e-3),
    then ms/frame on the card (warm-up, then the frames timed), a
    host-clock split and peak memory. No kernel of the port runs here."""
    from df3d_torch.models.detectors.pointpillar import (
        PointPillarConfig, PointPillars,
    )
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1
    from df3d_torch.utils import stages
    from df3d_torch.utils.synth import make_kitti_frame

    cfg = PointPillarConfig()
    inputs = []
    for s in PV_RCNN_SEEDS:
        frame = make_kitti_frame(np.random.RandomState(s))
        pts, num, coords = pillar_inputs(frame, cfg)
        inputs.append(tuple(torch.from_numpy(x[None])
                            for x in (pts, num, coords)))
        log(f"PointPillars frame {s}: {len(frame)} points, "
            f"{int((num > 0).sum())} pillars of max_voxels {cfg.max_voxels}, "
            f"{int((num == cfg.max_points_per_voxel).sum())} full at "
            f"{cfg.max_points_per_voxel} points")
    g = torch.Generator().manual_seed(0)
    cpu_model = PointPillars(cfg).init_weights(g).eval()
    card_model = PointPillars(cfg).to(dev).eval()
    card_model.load_state_dict(cpu_model.state_dict())
    with torch.no_grad():
        t0 = time.perf_counter()
        want = cpu_model(*inputs[0])
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        got = to_cpu(card_model(*[t.to(dev) for t in inputs[0]]))
    worst = 0.0
    for k, t in want.items():
        check(bool(torch.isfinite(got[k]).all()), f"PointPillars: {k}")
        torch.testing.assert_close(got[k], t, atol=1e-3, rtol=1e-3)
        worst = max(worst, (got[k] - t).abs().max().item())
    card_inputs = [[t.to(dev) for t in x] for x in inputs]
    with torch.no_grad():
        for x in card_inputs:
            card_model(*x)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K1.launches = K2.launches = 0
        times = []
        for x in card_inputs:
            t0 = time.perf_counter()
            card_model(*x)
            torch.cuda.synchronize()
            times.append(1e3 * (time.perf_counter() - t0))
        check(K1.launches == 0 and K2.launches == 0,
              "PointPillars launched K1 or K2")
        with stages.recording() as split:
            card_model(*card_inputs[0])
    log(f"PointPillars, card against CPU: cls, box and dir agree (max diff "
        f"{worst:.3g}); the CPU's forward {cpu_ms:.1f} ms")
    log(f"PointPillars on the card: {len(times)} frames, ms/frame mean "
        f"{np.mean(times):.3f} min {np.min(times):.3f}; per frame "
        f"{[round(x, 3) for x in times]}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB; split (ms, "
        "host clock, synchronised) "
        + ", ".join(f"{k} {v:.3f}" for k, v in split.items()))


def lc_inputs(cfg, nc, hw, channels, seed):
    """Seeded full-width inputs of the LC decoder on the CPU: the LiDAR
    decoder's queries (B 1), their BEV positions, first-stage predictions,
    `nc` cameras' (Hc, Wc) = `hw` feature maps of `channels`, projected
    centres in feature pixels, a visibility where query p sees p % 3
    cameras (0, 1 or 2, chosen at random) and projected radii of 1 to 8
    feature pixels."""
    g = torch.Generator().manual_seed(seed)
    p, d = cfg.num_proposals, cfg.hidden_channel
    (hc, wc), k = hw, cfg.num_classes
    first = {"center": torch.rand(1, p, 2, generator=g) * 180,
             "height": torch.randn(1, p, generator=g),
             "dim": torch.randn(1, p, 3, generator=g),
             "rot": torch.randn(1, p, 2, generator=g),
             "vel": torch.randn(1, p, 2, generator=g),
             "cls": torch.randn(1, p, k, generator=g)}
    vis = torch.zeros(1, nc, p, dtype=torch.bool)
    for q in range(p):
        cams = torch.randperm(nc, generator=g)[:q % 3]
        vis[0, cams, q] = True
    uv = torch.rand(1, nc, p, 2, generator=g) * torch.tensor([wc, hc])
    return (torch.randn(1, p, d, generator=g),
            torch.rand(1, p, 2, generator=g) * 180, first,
            torch.randn(1, nc, hc, wc, channels, generator=g), uv, vis,
            1.0 + 7.0 * torch.rand(1, nc, p, generator=g))


def phase_lc_decoder(dev):
    """Phase 63: the TransFusion LC image decoder at `transfusion_3ddf_nusc`'s
    head width (200 queries, hidden 128, 8 heads, ten classes) on six
    cameras' 112 x 200 feature maps of 256 channels (448 x 800 images at
    the image branch's stride 4), seeded inputs (`lc_inputs`): the card
    against the CPU, same weights (every refined key to atol = rtol =
    1e-3; queries no camera sees keep the first stage's predictions,
    exactly), then ms a call on the card and peak memory. No kernel of
    the port runs here."""
    from df3d_torch.models.heads.transfusion_head import TransFusionHeadCfg
    from df3d_torch.models.heads.transfusion_lc import TransFusionLCDecoder
    from df3d_torch.models.layers import flax_dense_init_
    from df3d_torch.ops import msda_kernel as K2
    from df3d_torch.ops import sparse_conv_kernel as K1

    cfg, nc, hw, ci = TransFusionHeadCfg(), LC_CAMS, LC_FEATURE_HW, LC_CHANNELS
    g = torch.Generator().manual_seed(0)
    cpu_model = TransFusionLCDecoder(cfg, ci, num_cams=nc)
    flax_dense_init_(cpu_model, g)
    cpu_model.eval()
    card_model = TransFusionLCDecoder(cfg, ci, num_cams=nc).to(dev).eval()
    card_model.load_state_dict(cpu_model.state_dict())
    args = lc_inputs(cfg, nc, hw, ci, seed=63)

    def on(d, a):
        return [{k: v.to(d) for k, v in x.items()} if isinstance(x, dict)
                else x.to(d) for x in a]

    with torch.no_grad():
        t0 = time.perf_counter()
        want = cpu_model(*args)
        cpu_ms = 1e3 * (time.perf_counter() - t0)
        card_args = on(dev, args)
        got = to_cpu(card_model(*card_args))
    unseen = ~args[5].any(1)
    worst = 0.0
    for k, t in want.items():
        check(bool(torch.isfinite(got[k]).all()), f"LC decoder: {k}")
        torch.testing.assert_close(got[k], t, atol=1e-3, rtol=1e-3)
        check(torch.equal(got[k][unseen], args[2][k][unseen]),
              f"LC decoder: an unseen query's {k} moved")
        worst = max(worst, (got[k] - t).abs().max().item())
    with torch.no_grad():
        card_model(*card_args)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        K1.launches = K2.launches = 0
        ms = cuda_ms(lambda: card_model(*card_args), LC_TIMED_RUNS)
        check(K1.launches == 0 and K2.launches == 0,
              "the LC decoder launched K1 or K2")
    log(f"TransFusion LC decoder, card against CPU: {int(unseen.sum())} of "
        f"{cfg.num_proposals} queries seen by no camera keep the first "
        f"stage, the rest agree (max diff {worst:.3g}); the CPU's call "
        f"{cpu_ms:.1f} ms; on the card {ms:.3f} ms a call (mean of "
        f"{LC_TIMED_RUNS}, CUDA events), peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB over "
        f"{nc} x {hw[0] * hw[1]} keys")


def pillow_available():
    import importlib.util

    return importlib.util.find_spec("PIL") is not None


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
    from df3d_torch.utils.synth import make_kitti_sample

    f32_backends()
    dev = torch.device("cuda")
    card = card_line()
    log(f"card: {card}")
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}; TF32 off (matmul and cuDNN), "
        f"cudnn.benchmark on")

    collect_frames = prefetch_frames(SERVING_SEEDS + TRAIN_SEEDS
                                     + CLI_EXTRA_SEEDS + FIT_CAPS_SEEDS)
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

    t0 = time.perf_counter()
    collect_frames()
    log(f"ray-cast frames (seeds "
        f"{SERVING_SEEDS + TRAIN_SEEDS + CLI_EXTRA_SEEDS + FIT_CAPS_SEEDS}, "
        "one worker "
        f"process each, begun before the build): ready "
        f"{time.perf_counter() - t0:.2f} s after the build")

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
    kframes = kitti_frames(3)
    kk1, kk2, klidar, kfused = phase_kitti_paths(dev, kframes)
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
    torch.cuda.empty_cache()

    # the "tpu_v5e" profile: K1's bf16 form; "launches" counts phase 39's
    # "tpu_v5e" runs (K1's f32 launches there go to K1's own entry)
    model = build_centerpoint(cfg, dev, seed=0, profile="tpu_v5e")
    k1_bf16 = phase_profile_k1(model, cfg, frames[0], dev)
    del model
    phase_profile_small(dev)
    profile_counts = phase_profile_paths(cfg, frames, dev)
    k1_bf16["launches_by_path"] = {"lidar_tpu_v5e": profile_counts["bf16"]}
    k1["launches_by_path"]["lidar_tpu_v5e"] = profile_counts["f32"]
    torch.cuda.empty_cache()

    # the evaluation path: reference checkpoints, double-flip TTA at batch
    # 4, recalibration and the metrics; "tta" holds phases 41's (K1) and
    # 42's (K2) kernel numbers at the batch-4 shapes
    kpts, kboxes, _, kvalid = make_kitti_sample(np.random.RandomState(100))
    k1["launches_by_path"]["imported"], kitti_det = phase_imported_weights(
        dev, frames, kpts)
    tta_k1, tta_lidar, tta_dets = phase_tta_lidar(dev, cfg, frames)
    torch.cuda.empty_cache()
    tta_k2, tta_fused = phase_tta_fused(dev, frames)
    torch.cuda.empty_cache()
    phase_recalibrate(dev)
    phase_metrics(tta_dets, kitti_det, kboxes[kvalid])
    for entry, kernel, extra in ((k1, K1, tta_k1), (k2, K2, tta_k2)):
        entry["launches_by_path"]["tta_lidar"] = tta_lidar[kernel]
        entry["launches_by_path"]["tta_fused"] = tta_fused[kernel]
        entry["tta"] = {k: v for k, v in extra.items()
                        if k not in ("name", "route", "source", "replaces",
                                     "library_ms")}
        entry["max_abs_err"] = max(entry["max_abs_err"],
                                   extra["max_abs_err"])
    k2["launches_by_path"]["imported"] = 0
    torch.cuda.empty_cache()

    # the aux objectives (phases 44-46) and the Swin-T preset (47-49):
    # "aux_<preset>" counts phase 45's timed aux steps, "swin" phase 48's
    # timed frames, "swin_train" phase 49's timed steps
    def timed_phase(n, fn, *args):
        t = time.perf_counter()
        out = fn(*args)
        log(f"phase {n}: {time.perf_counter() - t:.1f} s")
        return out

    timed_phase(44, phase_aux_small_train, dev)
    aux_runs, aux_err = timed_phase(45, phase_aux_full, dev)
    timed_phase(46, phase_aux_dp, dev)
    timed_phase(47, phase_swin_small, dev)
    swin_launches, swin_err = timed_phase(48, phase_swin_full, dev, frames)
    swin_train, swin_train_err = timed_phase(49, phase_swin_train, dev)
    for entry, kernel, name in ((k1, K1, "k1"), (k2, K2, "k2")):
        for preset, (_, on) in aux_runs.items():
            entry["launches_by_path"][f"aux_{preset}"] = (
                on[f"{name}_fwd"] + on[f"{name}_bwd"])
        entry["launches_by_path"]["swin"] = swin_launches[kernel]
        entry["launches_by_path"]["swin_train"] = (
            swin_train[f"{name}_fwd"] + swin_train[f"{name}_bwd"])
        entry["max_abs_err"] = max(entry["max_abs_err"], aux_err[name],
                                   swin_err[name], swin_train_err[name])
    torch.cuda.empty_cache()

    # every preset by name (phases 50-52): "<preset>_<profile>" counts
    # phase 52's timed frames of each preset in each profile (K1's f32
    # launches under K1, its bf16 ones under K1_bf16), and K1_bf16's
    # "transfusion" and "kitti" hold phase 52's per-launch numbers at
    # TransFusion-L's and Voxel R-CNN's shapes
    built = timed_phase(50, phase_presets_by_name, dev)
    full, bf16, preset_err = timed_phase(
        51, phase_presets_profile, dev, built,
        {"nusc": frames[:2], "kitti": kframes[:2]})
    preset_launches, bf16_tables, _ = timed_phase(
        52, phase_presets_timed, full, bf16)
    for (preset, profile), got in preset_launches.items():
        k1["launches_by_path"][f"{preset}_{profile}"] = got[K1]
        k2["launches_by_path"][f"{preset}_{profile}"] = got[K2]
        if profile == "tpu_v5e":
            k1_bf16["launches_by_path"][f"{preset}_{profile}"] = got[
                K1, "bf16_launches"]
    k1_bf16.update(bf16_tables)
    k1["max_abs_err"] = max(k1["max_abs_err"], preset_err["k1"])
    k2["max_abs_err"] = max(k2["max_abs_err"], preset_err["k2"])
    k1_bf16["max_abs_err"] = max(
        k1_bf16["max_abs_err"], preset_err["k1_bf16"],
        *(t["max_abs_err"] for t in bf16_tables.values()))
    torch.cuda.empty_cache()

    # training and evaluation from a dataset on disk through the CLIs
    # (phases 53-55): "cli_small_<preset>" counts phase 53's card runs,
    # "cli_train_<preset>" and "cli_test_<preset>[_<profile>]" phases 54's
    # and 55's runs (the launches of phase 54's first epoch and of both
    # phases' test runs each held against their plain versions)
    pillow = pillow_available()
    log(f"Pillow on this machine: {pillow}")
    build_dir = Path(__file__).resolve().parent / "build"
    build_dir.mkdir(exist_ok=True)
    with tempfile.TemporaryDirectory(prefix="cli_", dir=build_dir) as tmp:
        small = timed_phase(53, phase_cli_small, dev, Path(tmp))
        nusc_cli, nusc_err = timed_phase(54, phase_cli_nusc_full, dev,
                                         Path(tmp))
        kitti_cli, kitti_err = timed_phase(55, phase_cli_kitti_full, dev,
                                           Path(tmp), pillow)
        # dataset preparation from raw files and the remaining tools
        # (phases 56-60): "create_data_<run>_<preset>" counts phases 56's
        # and 57's CLI runs, "cli_ranks" phase 58's launches over both
        # ranks, "demo_<preset>" phase 59's demo runs (every launch of
        # phases 56, 57 and 59 held against its plain version)
        torch.cuda.empty_cache()
        nusc_raw, nusc_raw_err = timed_phase(56, phase_create_data_nusc, dev,
                                             Path(tmp))
        torch.cuda.empty_cache()
        kitti_raw, kitti_raw_err = timed_phase(57, phase_create_data_kitti,
                                               dev, Path(tmp))
        torch.cuda.empty_cache()
        rank_counts = timed_phase(58, phase_cli_ranks, dev, Path(tmp))
        demo_counts, demo_err = timed_phase(59, phase_demo, dev, Path(tmp))
        timed_phase(60, phase_fit_caps, dev)
    for name, (fwd, bwd, k2f, k2b) in small.items():
        k1["launches_by_path"][f"cli_small_{name}"] = fwd + bwd
        k2["launches_by_path"][f"cli_small_{name}"] = k2f + k2b
    for path, got in {**nusc_cli, **kitti_cli, **nusc_raw, **kitti_raw,
                      **demo_counts}.items():
        k1["launches_by_path"][path] = got["k1_fwd"] + got["k1_bwd"]
        k2["launches_by_path"][path] = got["k2_fwd"] + got["k2_bwd"]
        if got["k1_bf16"]:
            k1_bf16["launches_by_path"][path] = got["k1_bf16"]
    for entry, kernel in ((k1, "k1"), (k2, "k2")):
        entry["launches_by_path"]["cli_ranks"] = sum(
            c[f"{kernel}_fwd"] + c[f"{kernel}_bwd"] for c in rank_counts)
    for err in (nusc_err, kitti_err, nusc_raw_err, kitti_raw_err, demo_err):
        k1["max_abs_err"] = max(k1["max_abs_err"], err.get("k1", 0.0))
        k2["max_abs_err"] = max(k2["max_abs_err"], err.get("k2", 0.0))
        k1_bf16["max_abs_err"] = max(k1_bf16["max_abs_err"],
                                     err.get("k1_bf16", 0.0))
    torch.cuda.empty_cache()

    # PV-RCNN, PointPillars and the TransFusion LC decoder (phases 61-63):
    # "pv_rcnn" counts phase 61's timed KITTI frames, and K1's "pv_rcnn"
    # holds phase 61's per-launch numbers at PV-RCNN's shapes
    pv_k1, pv_launches = timed_phase(61, phase_pvrcnn, dev)
    torch.cuda.empty_cache()
    timed_phase(62, phase_pointpillars, dev)
    torch.cuda.empty_cache()
    timed_phase(63, phase_lc_decoder, dev)
    k1["launches_by_path"]["pv_rcnn"] = pv_launches[K1]
    k2["launches_by_path"]["pv_rcnn"] = pv_launches[K2]
    k1["pv_rcnn"] = {k: v for k, v in pv_k1.items()
                     if k not in ("name", "route", "source", "replaces",
                                  "library_ms")}
    k1["max_abs_err"] = max(k1["max_abs_err"], pv_k1["max_abs_err"])
    for entry in (k1, k2, k1_bf16):
        entry["launches"] = sum(entry["launches_by_path"].values())

    print(f"card: {card}", flush=True)
    print(json.dumps({"kernels": [k1, k2, k1_bf16]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
