#!/usr/bin/env python3
"""Where K1's device time goes: its kernels against copies with one part
taken out, on the launches of one full-width LiDAR frame, in the "exact"
profile (K1's f32 form) and in "tpu_v5e" (its bf16 form).

    python3 k1_ablate.py [PARENT_TREE]

Run from the root of a checkout on a machine with a CUDA card (an H100)
and the CUDA toolkit. It captures the 16 K1 launches of one full-width
nuScenes frame (the configuration of chip_smoke.py's phase 4) and the 10
bf16 launches of the same frame in the "tpu_v5e" profile (phase 37),
builds `df3d_torch/csrc/sparse_conv.cu` and copies of it with one edit
each (one nvcc per copy, all started together, into build/k1_ablate/),
and prints each build's device time per launch (CUDA events, calls queued
while the card spins) for one launch of each shape. The f32 form:

* kernel: the source as it is;
* cvt_split: the 3xTF32 split by cvt.rna.tf32.f32 instead of masking;
* hi_only: only the hi*hi product (1xTF32): the cost of the two other
  products;
* no_product: no product and no accumulation: the gather, W staging and
  the tap walk;
* walk_only: no product and no row gather: the tap walk and W staging;
* parent: PARENT_TREE's sparse_conv.cu as it is, where a tree is given.

The bf16 form, on one launch each of res2, down3, res3 and down4:

* bf16_kernel: the source as it is (the kernel build's bf16 entry point);
* bf16_no_product: no wgmma: the tap list, the row gathers and the W
  copies;
* bf16_walk_only: no wgmma and no row gather: the tap list and the W
  copies;
* parent: PARENT_TREE's bf16 form as it is, and parent_no_product and
  parent_walk_only, its copies with the product, and the product and the
  row gather, taken out (a parent whose bf16 form shares the f32 form's
  template, so its edits are no_product's and walk_only's).

The builds run in turns, in order and then in reverse. Every launch goes
through its own tree's wrapper. The copies compute wrong results; they
exist only in build/ and only to be timed. kernel, bf16_kernel and the
parent's builds are held against the plain versions first. Exits
non-zero without a CUDA device.
"""

import importlib.util
import os
import sys
import types
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "build" / "k1_ablate"
# one launch of each shape of the frame: conv_input, res1, down2, res2,
# down3, res3, down4
LAUNCHES = (0, 1, 5, 6, 10, 11, 15)
PRODUCTS = ("            mma_tf32(e[i], al, bh);\n"
            "            mma_tf32(e[i], ah, bl);\n")
ROW_COPY = ("        if (UNIT == V)\n          cp_async16(dst, src);\n"
            "        else if (kBf16<E>)\n          *dst = *src;\n"
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
# edits to PARENT_TREE's sparse_conv.cu (one whose bf16 form is the f32
# form's template), timed on its bf16 form
PARENT_VARIANTS = {
    "parent_no_product": VARIANTS["no_product"],
    "parent_walk_only": VARIANTS["walk_only"],
}
# edits to the bf16 kernel (its own, on wgmma)
BF16_PRODUCT = ("        wgmma<N>(part[m], desc(st + m * 64 * KP * 2 + ks * "
                "256, kLbo, kSbo),\n                 bd, ks);\n")
BF16_VARIANTS = {
    "bf16_no_product": [(BF16_PRODUCT, "        (void)bd;\n")],
    "bf16_walk_only": [
        (BF16_PRODUCT, "        (void)bd;\n"),
        ("        cp_async16_zfill(a + kc * 128, x + kc * 8,\n"
         "                         src >= 0 && kc * 8 < cin ? 16 : 0);\n",
         "        (void)a;\n        (void)x;\n")],
}
F32_BUILDS = ("kernel", "cvt_split", "hi_only", "no_product", "walk_only",
              "parent")
BF16_BUILDS = {"bf16_kernel": "kernel", "bf16_no_product": "bf16_no_product",
               "bf16_walk_only": "bf16_walk_only", "parent": "parent",
               "parent_no_product": "parent_no_product",
               "parent_walk_only": "parent_walk_only"}
EXACT = ("kernel", "bf16_kernel", "parent")
REPS = 20


def parent_module(parent):
    """PARENT_TREE's `df3d_torch/ops/sparse_conv_kernel.py`, loaded under
    another name beside the current one."""
    path = parent / "df3d_torch" / "ops" / "sparse_conv_kernel.py"
    spec = importlib.util.spec_from_file_location("parent_k1", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build_libraries(parent):
    """{build: (wrapper module, library)}, nvcc started for all at once;
    prints the compiler's register and spill lines of the kernels."""
    from df3d_torch.ops import build
    from df3d_torch.ops import sparse_conv_kernel as K

    variants, extra, bases = dict(VARIANTS), {}, {}
    variants.update(BF16_VARIANTS)
    if parent is not None:
        src = parent / "df3d_torch" / "csrc" / "sparse_conv.cu"
        extra["parent"] = src
        for name, edits in PARENT_VARIANTS.items():
            variants[name] = edits
            bases[name] = src
    built = build.build_variants("sparse_conv.cu", variants, OUT, extra,
                                 bases)
    for name in ("parent", "kernel"):
        for line in built.get(name, (None, ""))[1].splitlines():
            if ("entry function" in line or "registers" in line
                    or "spill" in line):
                print(f"  ptxas {name}: {line.strip()}")
    pmod = None if parent is None else parent_module(parent)
    return {name: (pmod if name.startswith("parent") else K, lib)
            for name, (lib, _) in built.items()}


def launcher(mod, lib, fn):
    """`mod.<fn>` run with the library `lib`: the current wrapper keeps its
    library in `_lib`; an earlier one loaded it through `build.load`."""
    def call(*args):
        if hasattr(mod, "_lib"):
            own, mod._lib = mod._lib, mod.bind(lib)
            try:
                return getattr(mod, fn)(*args)
            finally:
                mod._lib = own
        own_build = mod.build
        mod.build = types.SimpleNamespace(load=lambda source: lib)
        try:
            return getattr(mod, fn)(*args)
        finally:
            mod.build = own_build
    return call


def capture_launches():
    """The (features, gather_idx, weights) of every K1 launch of one
    full-width LiDAR frame in the "exact" profile, and of every bf16 launch
    of the same frame in "tpu_v5e"."""
    import chip_smoke
    from df3d_torch.entry import build_centerpoint
    from df3d_torch.models.detectors.centerpoint import CenterPointConfig

    caps = chip_smoke.REALISTIC_STAGE_CAPS
    cfg = CenterPointConfig(max_voxels=caps[0], stage_caps=caps)
    frame = chip_smoke.full_width_frames(1)[0]
    model = build_centerpoint(cfg, "cuda", seed=0)
    f32 = chip_smoke.capture_k1(model, cfg, frame, "cuda")
    del model
    model = build_centerpoint(cfg, "cuda", seed=0, profile="tpu_v5e")
    bf16 = []
    chip_smoke.capture_k1(model, cfg, frame, "cuda", bf16=bf16)
    return f32, bf16


def one_of_each_shape(launches):
    """Indices of the first launch of each (N_in, N_out, Cin, Cout)."""
    seen, picked = set(), []
    for i, (f, idx, w) in enumerate(launches):
        key = (f.shape[1], idx.shape[1] // w.shape[0], w.shape[1],
               w.shape[2])
        if key not in seen:
            seen.add(key)
            picked.append(i)
    return picked


def time_builds(chip_smoke, title, builds, libs, fn, plain, launches,
                picked):
    """Each build's device ms per launch on launches[picked], in turns,
    in order then reversed; the exact builds held against `plain` first."""
    print(f"{title}: device ms per launch (launch #: N_in->N_out, "
          "Cin->Cout)")
    print("  " + " | ".join(
        f"#{i}: {launches[i][0].shape[1]}->"
        f"{launches[i][1].shape[1] // launches[i][2].shape[0]}, "
        f"{launches[i][2].shape[1]}->{launches[i][2].shape[2]}"
        for i in picked))
    calls = {name: launcher(*libs[lib], fn) for name, lib in builds.items()
             if lib in libs}
    for name in calls:
        if name not in EXACT:
            continue
        for i in picked:
            f, idx, w = launches[i]
            out, again, ref = calls[name](f, idx, w), calls[name](f, idx, w), \
                plain(f, idx, w)
            torch.cuda.synchronize()
            err = (out.float() - ref.float()).abs().max().item()
            tol = 1e-4 * ref.float().abs().max().item() + 1e-5
            if fn == "sparse_conv_bf16_cuda":  # phase 37's tolerance
                ok = bool(((chip_smoke.bf16_ulps(out, ref) <= 1)
                           | ((out.float() - ref.float()).abs() <= 1e-6)
                           ).all())
            else:
                ok = err <= tol
            if not ok or not torch.equal(out, again):
                raise RuntimeError(f"{name} launch {i}: max abs err {err}, "
                                   "or a repeat launch differs")
    order = list(calls) + list(calls)[::-1]
    for name in order:
        row = [chip_smoke.device_ms(lambda: calls[name](*launches[i]), REPS)
               for i in picked]
        print(f"  {name:<18} " + " ".join(f"{x:.4f}" for x in row)
              + f"  sum {sum(row):.4f}", flush=True)


def main():
    if not torch.cuda.is_available():
        print("k1_ablate: no CUDA device; nothing was run", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import chip_smoke
    from df3d_torch.ops import sparse_conv_kernel as K

    chip_smoke.f32_backends()
    parent = Path(sys.argv[1]).resolve() if len(sys.argv) > 1 else None
    print(f"card: {chip_smoke.card_line()}", flush=True)
    libs = build_libraries(parent)
    f32, bf16 = capture_launches()
    time_builds(chip_smoke, "f32 form", {n: n for n in F32_BUILDS}, libs,
                "sparse_conv_cuda", K.sparse_conv_plain, f32, LAUNCHES)
    time_builds(chip_smoke, "bf16 form", BF16_BUILDS, libs,
                "sparse_conv_bf16_cuda", K.sparse_conv_bf16_plain, bf16,
                one_of_each_shape(bf16))
    print(f"card: {chip_smoke.card_line()}")
    return 0


if __name__ == "__main__":
    os.chdir(ROOT)
    sys.exit(main())
