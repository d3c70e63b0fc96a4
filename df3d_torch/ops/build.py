"""Build the port's CUDA sources with nvcc into shared libraries.

Each source under `df3d_torch/csrc/` becomes a shared library with a plain
C interface, loaded with ctypes, in `build/df3d_torch/` at the root of the
checkout (listed in `.gitignore`). The library's file name carries a hash
of its source, so an edited source is rebuilt. `build_all()` starts one
nvcc per source, all at once; `load()` builds on first use;
`build_variants()` builds edited copies of a source for the measurement
scripts. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "df3d_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: dict[str, ctypes.CDLL] = {}
build_seconds: dict[str, float] = {}
build_log: dict[str, str] = {}


def sources() -> list[str]:
    return sorted(p.name for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a "
                       "machine with the CUDA toolkit")


def library_path(source: str) -> Path:
    src = CSRC / source
    digest = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"lib{src.stem}_{digest}.so"


def build_all(names: list[str] | None = None) -> dict[str, Path]:
    """Compile every source (default: all of `csrc/*.cu`) whose library is
    missing, one nvcc process per source, all started together. Raises if
    any compile fails. Safe when several processes build at once (each
    writes a temporary file and renames it into place)."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC / name)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        jobs[name] = (proc, tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in jobs.items():
        stdout, stderr = proc.communicate()
        build_seconds[name] = time.perf_counter() - t0
        build_log[name] = stderr
        if proc.returncode == 0:
            os.replace(tmp, out)
        else:
            os.remove(tmp)
            failed.append(f"nvcc failed for {name}:\n{stdout}\n{stderr}")
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: library_path(name) for name in names}


def apply_edits(text: str, edits: list[tuple[str, str]], name: str) -> str:
    """`text` with each (old, new) edit made; raises unless every `old` is
    found exactly once."""
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{name}: the edit no longer applies")
        text = text.replace(old, new)
    return text


def build_variants(source: str, variants: dict[str, list[tuple[str, str]]],
                   out_dir: Path, extra: dict[str, Path] | None = None,
                   bases: dict[str, Path] | None = None
                   ) -> dict[str, tuple[ctypes.CDLL, str]]:
    """Builds for measurement: for each variant a copy of `csrc/<source>`
    (or of its file in `bases`, e.g. an earlier commit's source) with its
    (old, new) edits made, each `old` found exactly once, and each file of
    `extra` as it is, compiled into `out_dir`, one nvcc each, all started
    together. Returns each build's loaded library and nvcc's ptxas report,
    `extra` first. Raises when an edit no longer applies or a compile
    fails."""
    bases = bases or {}
    texts = {name: path.read_text() for name, path in (extra or {}).items()}
    for name, edits in variants.items():
        texts[name] = apply_edits(
            bases.get(name, CSRC / source).read_text(), edits, name)
    out_dir.mkdir(parents=True, exist_ok=True)
    jobs = {}
    for name, body in texts.items():
        cu = out_dir / f"{name}.cu"
        cu.write_text(body)
        jobs[name] = subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True)
    reports = {name: proc.communicate()[1] for name, proc in jobs.items()}
    failed = [f"nvcc failed for {name}:\n{reports[name]}"
              for name, proc in jobs.items() if proc.returncode]
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: (ctypes.CDLL(str(out_dir / f"{name}.so")), report)
            for name, report in reports.items()}


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<source>`, built on first use."""
    lib = _loaded.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([source])[source]))
        _loaded[source] = lib
    return lib
