#!/usr/bin/env python3
"""Where K2's device time goes: its kernel against copies with one part
taken out, on the K2 launch of one full-width fused frame.

    python3 k2_ablate.py [PARENT_TREE]

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
Exits non-zero without a CUDA device.
"""

import ctypes
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


def main():
    if not torch.cuda.is_available():
        print("k2_ablate: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from df3d_torch.ops import msda_kernel as K2

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cudnn.benchmark = True
    parent = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else None
    print(f"card: {chip_smoke.card_line()}", flush=True)
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
