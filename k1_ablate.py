#!/usr/bin/env python3
"""Where K1's device time goes: its kernel against copies with one part
taken out, on the launches of one full-width LiDAR frame.

    python3 k1_ablate.py

Run from the root of a checkout on a machine with a CUDA card (an H100)
and the CUDA toolkit. It captures the 16 K1 launches of one full-width
nuScenes frame (the configuration of chip_smoke.py's phase 4), builds
`df3d_torch/csrc/sparse_conv.cu` and copies of it with one edit each (one
nvcc per copy, all started together, into build/k1_ablate/), and prints
each build's device time per launch (CUDA events, calls queued while the
card spins) for one launch of each shape:

* kernel: the source as it is;
* cvt_split: the 3xTF32 split by cvt.rna.tf32.f32 instead of masking;
* hi_only: only the hi*hi product (1xTF32): the cost of the two other
  products;
* no_product: no product and no accumulation: the gather, W staging and
  the tap walk;
* walk_only: no product and no row gather: the tap walk and W staging.

The copies compute wrong results; they exist only in build/ and only to
be timed. Exits non-zero without a CUDA device.
"""

import ctypes
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "k1_ablate"
# one launch of each shape of the frame: conv_input, res1, down2, res2,
# down3, res3, down4
LAUNCHES = (0, 1, 5, 6, 10, 11, 15)
PRODUCTS = ("          mma_tf32(e[i], al, bh);\n"
            "          mma_tf32(e[i], ah, bl);\n")
ROW_COPY = ("        if (UNIT == 4)\n          cp_async16(dst, src);\n"
            "        else\n          cp_async4(dst, src);\n")
COMPUTE = "    compute(i % S, h_cur);\n"
MASK_SPLIT = ("  hi = __float_as_uint(x) & kTf32;\n"
              "  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32;\n")
CVT_SPLIT = ("  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(hi) : \"f\"(x));\n"
             "  asm(\"cvt.rna.tf32.f32 %0, %1;\" : \"=r\"(lo)\n"
             "      : \"f\"(x - __uint_as_float(hi)));\n")
VARIANTS = {
    "kernel": [],
    "cvt_split": [(MASK_SPLIT, CVT_SPLIT)],
    "hi_only": [(PRODUCTS, "")],
    "no_product": [(COMPUTE, "")],
    "walk_only": [(COMPUTE, ""),
                  (ROW_COPY, "        (void)dst;\n        (void)src;\n")],
}


def build_variants():
    """One shared library per variant, nvcc started for all at once."""
    from df3d_torch.ops import build

    src = (build.CSRC / "sparse_conv.cu").read_text()
    OUT.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f"{name}: the edit no longer applies")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        jobs[name] = subprocess.Popen(
            [build._nvcc(), *build.NVCC_FLAGS, "-o", str(OUT / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    fns = {}
    for name, proc in jobs.items():
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).df3d_sparse_conv_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        fns[name] = fn
    return fns


def capture_launches():
    """The (features, gather_idx, weights) of every K1 launch of one
    full-width LiDAR frame."""
    import chip_smoke
    from df3d_torch.entry import build_centerpoint, infer
    from df3d_torch.models.detectors.centerpoint import CenterPointConfig
    from df3d_torch.ops import sparse_conv_kernel as K

    caps = chip_smoke.REALISTIC_STAGE_CAPS
    cfg = CenterPointConfig(max_voxels=caps[0], stage_caps=caps)
    model = build_centerpoint(cfg, "cuda", seed=0)
    frame = chip_smoke.full_width_frames(1)[0]
    captured = []
    launch = K.sparse_conv_cuda

    def recording(features, gather_idx, weights):
        captured.append((features.clone(), gather_idx.clone(),
                         weights.clone()))
        return launch(features, gather_idx, weights)

    pts = torch.from_numpy(frame[None]).cuda()
    K.sparse_conv_cuda = recording
    try:
        infer(model, cfg, pts, torch.ones(pts.shape[:2], dtype=torch.bool,
                                          device="cuda"))
    finally:
        K.sparse_conv_cuda = launch
    torch.cuda.synchronize()
    return captured


def main():
    if not torch.cuda.is_available():
        print("k1_ablate: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {chip_smoke.card_line()}", flush=True)
    fns = build_variants()
    captured = capture_launches()
    stream = torch.cuda.current_stream().cuda_stream
    print("device ms per launch (launch #: N_in->N_out, Cin->Cout)")
    header = []
    for i in LAUNCHES:
        f, idx, w = captured[i]
        header.append(f"#{i}: {f.shape[1]}->{idx.shape[1] // w.shape[0]}, "
                      f"{w.shape[1]}->{w.shape[2]}")
    print("  " + " | ".join(header))
    for name, fn in fns.items():
        row = []
        for i in LAUNCHES:
            f, idx, w = captured[i]
            b, n_in, cin = f.shape
            k, _, cout = w.shape
            out = torch.empty(b, idx.shape[1] // k, cout, device="cuda")
            args = (f.data_ptr(), idx.data_ptr(), w.data_ptr(),
                    out.data_ptr(), b, n_in, idx.shape[1] // k, k, cin, cout,
                    stream)

            def call():
                if fn(*args):
                    raise RuntimeError(f"{name}: launch failed")

            row.append(chip_smoke.device_ms(call, 20))
        print(f"  {name:<11} " + " ".join(f"{x:.4f}" for x in row),
              flush=True)
    print(f"card: {chip_smoke.card_line()}")
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
