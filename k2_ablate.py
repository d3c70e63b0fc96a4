#!/usr/bin/env python3
"""Where K2's device time goes: its kernel against copies with one part
taken out, on the K2 launch of one full-width fused frame, or (--bwd) on
the backward launches of three full-width fused training steps.

    python3 k2_ablate.py [PARENT_TREE]
    python3 k2_ablate.py --bwd [PARENT_TREE]

Run from the root of a checkout on a machine with a CUDA card (an H100)
and the CUDA toolkit. It captures the K2 launch of one full-width
camera+LiDAR frame (the configuration of chip_smoke.py's phase 7), builds
`df3d_torch/csrc/msda.cu` and copies of it with one edit each (one nvcc
per copy, all started together, into build/k2_ablate/), and prints each
build's time on that launch: the stream time of back-to-back calls and the
device time (calls queued while the card spins), CUDA events, 20 calls:

* kernel: the source as it is;
* general: every shape sent to the general path (one thread per output
  element);
* no_exit: no early exit for a query whose samples all miss the map;
* l2_only: the value rows read through L2 only (ld.global.cg), not the
  read-only L1 path: what hits among neighbouring queries save;
* interleaved: the cameras interleaved in block order (warp i takes query
  i / B of camera i % B) instead of camera-major: what keeping one
  camera's table in L2 saves;
* no_gather: no value-row loads (the sample arithmetic, the shuffles, the
  location, weight and output traffic);
* parent: PARENT_TREE's msda.cu as it is, where a tree is given (an
  unpacked earlier commit), to compare the two in one process.

The builds run in turns, in order and then in reverse (with a parent:
parent, kernel, ..., kernel, parent). With a parent it then times the
fused path itself (`infer_fused` on the captured frame, host clock around
work that ends in a synchronise) with K2 taken from the parent's build and
from this one in turns, blocks of PATH_FRAMES frames in the order P, C, C,
P, twice, all in one process: the kernel's effect on ms/frame apart from
which tree or process runs. Every build but no_gather computes
the full function and is held against the plain version; no_gather
computes a wrong result and exists only in build/ to be timed.

With --bwd it captures the K2 backward launches of one training step of
`centerpoint_3ddf_nusc` (chip_smoke.py's phase 18: L 3, the warp path),
`transfusion_3ddf_nusc` (phase 23: L 1, two launches) and
`voxel_rcnn_3ddf_kitti` (phase 32: the general path at D 8), each step
built as its phase builds it, and times, per step, the sum of its
launches for every build of BWD_VARIANTS (edits to the current
`msda.cu`) and, with a parent, the parent's `msda.cu` as it is and
PARENT_BWD_VARIANTS (edits to that source: its f32 atomics as plain
stores, its memset of dvalue taken out, its zero writes for queries
whose g is 0 taken out), in turns, in order then reversed, through each
tree's own wrapper. bwd_kernel and parent compute the full function and
are held against autograd of the plain version once per step (and
bwd_kernel against itself on a repeat launch, bit for bit; a failure is
raised after the timings); the other builds compute wrong results and
exist only in build/ to be timed.
Exits non-zero without a CUDA device.
"""

import ctypes
import importlib.util
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "k2_ablate"
LOADS = ("      if (c & 1) v00 = __ldg(rows + off);\n"
         "      if (c & 2) v01 = __ldg(rows + off + kRow4);\n"
         "      if (c & 4) v10 = __ldg(rows + off + down);\n"
         "      if (c & 8) v11 = __ldg(rows + off + down + kRow4);\n")
VARIANTS = {
    "kernel": [],
    "general": [("  if (df3d_msda_warp_path(",
                 "  if (false && df3d_msda_warp_path(")],
    "no_exit": [("  if (!__any_sync(kFull, any)) {", "  if (false) {")],
    "no_gather": [(LOADS, "")],
    "l2_only": [(LOADS, LOADS.replace("__ldg", "__ldcg"))],
    "interleaved": [(
        "  const int bq = blockIdx.x * kWarps + (threadIdx.x >> 5);",
        "  const int idx = blockIdx.x * kWarps + (threadIdx.x >> 5);\n"
        "  if (idx >= n_queries) return;\n"
        "  const int n_cams = n_queries / q_len;\n"
        "  const int bq = (idx % n_cams) * q_len + idx / n_cams;")],
}
EXACT = ("kernel", "general", "no_exit", "l2_only", "interleaved", "parent")
PATH_FRAMES = 5

# The backward (--bwd): edits to the current msda.cu (each build still
# launches every pass and stays in bounds) ...
WARP_ROW_READS = (
    "        if (c & 1) s00 = dot4(g4, __ldg(rows + off));\n"
    "        if (c & 2) s01 = dot4(g4, __ldg(rows + off + kRow4));\n"
    "        if (c & 4) s10 = dot4(g4, __ldg(rows + off + down));\n"
    "        if (c & 8) s11 = dot4(g4, __ldg(rows + off + down + kRow4));\n")
BWD_VARIANTS = {
    "bwd_kernel": [],
    # dead queries' dloc and dattn left unwritten
    "no_dead_writes": [
        ("      const int i = static_cast<int>(e % (n4 + a4));\n"
         "      if (is_live(sc.live_bits, u)) continue;\n",
         "      const int i = static_cast<int>(e % (n4 + a4));\n"
         "      if (true) continue;\n"),
        ("      const int i = static_cast<int>(e % (3 * per_unit));\n"
         "      if (is_live(sc.live_bits, u)) continue;\n",
         "      const int i = static_cast<int>(e % (3 * per_unit));\n"
         "      if (true) continue;\n")],
    # pass A2 without the value rows (g . v_c = 0)
    "no_value_reads": [
        (WARP_ROW_READS, "        (void)off;\n        (void)down;\n"),
        ("            for (int d = 0; d < head_dim; ++d) "
         "acc = fmaf(g[d], v[d], acc);\n", "            (void)v;\n")],
    # pass C writes zeros without reading a record
    "no_dvalue_sum": [("  int k = begin;\n", "  int k = end;\n")],
}
# ... and to the parent's (an msda.cu whose dvalue is zeroed by a memset,
# then summed into with f32 atomics)
PARENT_SCATTER = ("  atomicAdd(row, g.x * w);\n"
                  "  atomicAdd(row + 1, g.y * w);\n"
                  "  atomicAdd(row + 2, g.z * w);\n"
                  "  atomicAdd(row + 3, g.w * w);\n")
PARENT_BWD_VARIANTS = {
    "parent_no_atomics": [
        (PARENT_SCATTER, "  row[0] = g.x * w;\n  row[1] = g.y * w;\n"
                         "  row[2] = g.z * w;\n  row[3] = g.w * w;\n"),
        ("            atomicAdd(dv + d, g[d] * w[k]);\n",
         "            dv[d] = g[d] * w[k];\n")],
    "parent_no_memset": [(
        "  cudaError_t err = cudaMemsetAsync(dvalue, 0, value_bytes, s);\n"
        "  if (err != cudaSuccess) return static_cast<int>(err);\n",
        "  (void)value_bytes;\n")],
    "parent_no_dead_writes": [
        ("  if (!__any_sync(kFull, live)) {\n"
         "    zero_query<L, P>(dloc_q, dattn_q, head, point);\n"
         "    return;\n  }\n",
         "  if (!__any_sync(kFull, live)) return;\n"),
        ("  if (!live) {\n    for (int s = 0; s < lp; ++s) {\n"
         "      dattn_t[s] = 0.f;\n"
         "      dloc_t[2 * s] = dloc_t[2 * s + 1] = 0.f;\n    }\n"
         "    return;\n  }\n",
         "  if (!live) return;\n")],
}
BWD_EXACT = ("bwd_kernel", "parent")
BWD_REPS = 10


def build_libraries(parent):
    """One library per build, nvcc started for all at once, each bound as
    the wrapper binds its own (the parent's has only the launch entry
    point); prints the compiler's register and stack lines of the kernel
    and the parent."""
    from df3d_torch.ops import build
    from df3d_torch.ops import msda_kernel as K2

    extra = ({} if parent is None else
             {"parent": parent / "df3d_torch" / "csrc" / "msda.cu"})
    built = build.build_variants(K2.SOURCE, VARIANTS, OUT, extra)
    for name in ("parent", "kernel"):
        for line in built.get(name, (None, ""))[1].splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"  ptxas {name}: {line.strip()}")
    return {name: K2.bind(lib, ["df3d_msda_f32"] if name == "parent"
                          else K2.ENTRY_POINTS)
            for name, (lib, _) in built.items()}


def capture_launch():
    """(value, shapes, locations, weights) of the K2 launch of one
    full-width fused frame, and a function that runs that frame."""
    import chip_smoke
    from df3d_torch.entry import build_centerpoint3ddf, infer_fused

    cfg, fcfg = chip_smoke.full_fused_configs()
    model = build_centerpoint3ddf(cfg, fcfg, "cuda", seed=0)
    frame = chip_smoke.full_width_frames(1)[0]
    inputs = chip_smoke.fused_inputs(frame, fcfg.num_cams, fcfg.image_shape,
                                     "cuda", 10)
    captured = chip_smoke.capture_k2(model, cfg, inputs)
    if len(captured) != 1:
        raise RuntimeError(f"expected 1 K2 launch, saw {len(captured)}")
    return captured[0][:4], lambda: infer_fused(model, cfg, *inputs)


def path_turns(libs, run_frame):
    """ms/frame of the fused path with K2 from the parent's build and from
    this one, in blocks of PATH_FRAMES frames, turns P, C, C, P twice."""
    from df3d_torch.ops import msda_kernel as K2

    own = K2._library()
    print(f"fused path ms/frame, blocks of {PATH_FRAMES} frames (host clock, "
          "synchronised), K2 from each build:")
    try:
        for name in ("parent", "kernel", "kernel", "parent") * 2:
            K2._lib = libs[name]
            run_frame()
            torch.cuda.synchronize()
            ms = []
            for _ in range(PATH_FRAMES):
                t0 = time.perf_counter()
                run_frame()
                torch.cuda.synchronize()
                ms.append(1e3 * (time.perf_counter() - t0))
            print(f"  {name:<10} mean {np.mean(ms):.3f} median "
                  f"{np.median(ms):.3f} min {np.min(ms):.3f}", flush=True)
    finally:
        K2._lib = own


def parent_module(parent, name):
    """The parent tree's wrapper module `df3d_torch/ops/<name>.py`, loaded
    under another name beside the current one (it imports the current
    package's `build`, which it uses only to load its library)."""
    path = parent / "df3d_torch" / "ops" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"parent_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def record_bwd(step, state, batch, *step_args):
    """Clones of the (value, shapes, locations, weights, grad) of every K2
    backward launch of one `step.grads` call."""
    from df3d_torch.ops import msda_kernel as K2

    captured, launch = [], K2.msda_bwd_cuda

    def recording(value, shapes, locs, attn, grad):
        captured.append((value.clone(), tuple(shapes), locs.clone(),
                         attn.clone(), grad.clone()))
        return launch(value, shapes, locs, attn, grad)

    K2.msda_bwd_cuda = recording
    try:
        step.grads(state, batch, *step_args)
    finally:
        K2.msda_bwd_cuda = launch
    torch.cuda.synchronize()
    return captured


def capture_bwd_launches():
    """{step: its K2 backward launches}: one step each of the three fused
    trainers, built as chip_smoke.py's phases 18, 23 and 32 build them."""
    import chip_smoke
    from df3d_torch.config.presets import fused_config, voxel_rcnn_3ddf_kitti
    from df3d_torch.entry import build_voxelrcnn3ddf_trainer

    sets = {}
    for label, transfusion in (("phase 18 step (L 3, warp path)", False),
                               ("phase 23 step (L 1, warp path)", True)):
        _, _, state, step, batch = chip_smoke.full_fused_train_setup(
            "cuda", transfusion=transfusion)
        sets[label] = record_bwd(step, state, batch)
        del state, step, batch
        torch.cuda.empty_cache()
    preset = voxel_rcnn_3ddf_kitti()
    state, step = build_voxelrcnn3ddf_trainer(
        preset["lidar"], fused_config(preset), "cuda", seed=0)
    batch = chip_smoke.kitti_train_batch("cuda", fused=True)
    gen = torch.Generator(device="cuda").manual_seed(7)
    sets["phase 32 step (KITTI, general path, D 8)"] = record_bwd(
        step, state, batch, gen)
    del state, step, batch
    torch.cuda.empty_cache()
    return sets


def bwd_main(parent, chip_smoke):
    """The backward's builds on the captured launches of three steps."""
    from df3d_torch.ops import build
    from df3d_torch.ops import msda_kernel as K2

    extra, bases, variants = {}, {}, dict(BWD_VARIANTS)
    if parent is not None:
        src = parent / "df3d_torch" / "csrc" / "msda.cu"
        extra["parent"] = src
        for name, edits in PARENT_BWD_VARIANTS.items():
            variants[name] = edits
            bases[name] = src
    built = build.build_variants(K2.SOURCE, variants, OUT / "bwd", extra,
                                 bases)
    for name in ("parent", "bwd_kernel"):
        for line in built.get(name, (None, ""))[1].splitlines():
            if "bwd" in line and ("entry function" in line
                                  or "registers" in line or "spill" in line):
                print(f"  ptxas {name}: {line.strip()}")
    mods = {}
    for name, (lib, _) in built.items():
        mod = K2 if name in BWD_VARIANTS else parent_module(parent,
                                                            "msda_kernel")
        mods[name] = (mod, mod.bind(lib))
    sets = capture_bwd_launches()
    order = list(built) + list(built)[::-1]
    failures = []
    for label, launches in sets.items():
        v, shapes, locs, attn, grad = launches[0]
        print(f"{label}: {len(launches)} launch(es), value "
              f"{tuple(v.shape)}, locations {tuple(locs.shape)}, levels "
              f"{list(shapes)}", flush=True)

        def caller(name):
            mod, lib = mods[name]

            def call():
                own = mod._lib
                mod._lib = lib
                try:
                    return [mod.msda_bwd_cuda(*args) for args in launches]
                finally:
                    mod._lib = own
            return call

        wants = [K2.msda_bwd_plain(*args) for args in launches]
        failed = []
        for name in BWD_EXACT:
            if name not in built:
                continue
            got = caller(name)()
            again = caller(name)()
            torch.cuda.synchronize()
            worst = 0.0
            for gs, ags, ws in zip(got, again, wants):
                for g, a, w in zip(gs, ags, ws):
                    tol = 1e-4 * w.abs().max().item() + 1e-5
                    err = (g - w).abs().max().item()
                    worst = max(worst, err / tol)
                    if name == "bwd_kernel" and not torch.equal(g, a):
                        failed.append(f"{label}: {name}: a repeat launch "
                                      "differs")
            if not worst <= 1.0:
                failed.append(f"{label}: {name}: max abs err {worst:.3g} "
                              "tolerances")
            print(f"  {name:<22} worst err / tolerance {worst:.3g}",
                  flush=True)
        del wants
        print("  ms per step (its launches summed), turns in order then "
              "reversed: back-to-back (stream) / device")
        for name in order:
            call = caller(name)
            ms = chip_smoke.cuda_ms(call, BWD_REPS)
            dev = chip_smoke.device_ms(call, BWD_REPS)
            print(f"  {name:<22} {ms:.4f} / {dev:.4f}", flush=True)
        del launches
        torch.cuda.empty_cache()
        failures.extend(failed)
    if failures:  # after the timings, which a wrong build does not stop
        raise RuntimeError("\n".join(failures))


def main():
    if not torch.cuda.is_available():
        print("k2_ablate: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from df3d_torch.ops import msda_kernel as K2

    chip_smoke.f32_backends()
    args = sys.argv[1:]
    bwd = "--bwd" in args
    args = [a for a in args if a != "--bwd"]
    parent = Path(args[0]).resolve() if args else None
    print(f"card: {chip_smoke.card_line()}", flush=True)
    if bwd:
        bwd_main(parent, chip_smoke)
        print(f"card: {chip_smoke.card_line()}")
        return 0
    libs = build_libraries(parent)
    (value, shapes, locs, attn), run_frame = capture_launch()
    b, len_v, nh, d = value.shape
    q, nl, npnt = locs.shape[1], locs.shape[3], locs.shape[4]
    flat = (ctypes.c_int * (2 * nl))(*[v for hw in shapes for v in hw])
    out = torch.empty(b, q, nh * d, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream
    ref = K2.msda_plain(value, shapes, locs, attn)
    tol = 1e-4 * ref.abs().max().item() + 1e-5
    print(f"K2 launch: value {tuple(value.shape)}, locations "
          f"{tuple(locs.shape)}, levels {list(shapes)}; tolerance {tol:.3g}")

    def caller(name):
        fn = libs[name].df3d_msda_f32
        args = (value.data_ptr(), locs.data_ptr(), attn.data_ptr(),
                out.data_ptr(), flat, nl, b, len_v, q, nh, d, npnt, stream)

        def call():
            if fn(*args):
                raise RuntimeError(f"{name}: launch failed")
        return call

    for name in libs:
        caller(name)()
        torch.cuda.synchronize()
        err = (out - ref).abs().max().item()
        if name in EXACT and not err <= tol:
            raise RuntimeError(f"{name}: max abs err {err} > {tol}")
        print(f"  {name:<10} max abs err {err:.3g}", flush=True)

    order = list(libs) + list(libs)[::-1]
    print("ms per launch, turns in order then reversed: back-to-back "
          "(stream) / device")
    for name in order:
        call = caller(name)
        ms = chip_smoke.cuda_ms(call, 20)
        dev = chip_smoke.device_ms(call, 20)
        print(f"  {name:<10} {ms:.4f} / {dev:.4f}", flush=True)
    if parent is not None:
        path_turns(libs, run_frame)
    print(f"card: {chip_smoke.card_line()}")
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
