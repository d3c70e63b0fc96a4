"""ctypes binding of the C++ data-path library `csrc/pointio.cc` (port of
df3d/data/native.py).

The source is compiled with `g++ -O3 -fPIC -shared` at first use into
`build/df3d_torch/` at the root of the checkout, under a name that carries
a hash of the source, so an edited source is rebuilt. It is built for the
machine in general: no `-march=native`, and no contraction into fused
multiply-adds, so `transform_points` rounds as numpy's f32 arithmetic does
on any host. The library is written to a temporary file and renamed into
place, so several processes may build at once. Nothing is written next to
the source. A failed build or load raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import numpy as np

from df3d_torch.ops.build import BUILD_DIR

SOURCE = Path(__file__).resolve().parents[2] / "csrc" / "pointio.cc"
CXX_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-ffp-contract=off")

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"libpointio_{digest}.so"


def build() -> Path:
    """Compile `csrc/pointio.cc` unless its library exists; raises if g++
    is missing or fails."""
    out = library_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the point loader is built from "
                           f"{SOURCE.name} at first use")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode:
        os.remove(tmp)
        raise RuntimeError(f"g++ failed for {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


class NativeLoader:
    """The library's five functions on numpy arrays."""

    def __init__(self):
        lib = ctypes.CDLL(str(build()))
        lib.read_point_bin.restype = ctypes.c_int64
        lib.read_point_bin.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_int64]
        lib.transform_points.restype = None
        lib.transform_points.argtypes = [
            _f32p, ctypes.c_int64, ctypes.c_int64, _f32p]
        lib.cpu_voxelize.restype = ctypes.c_int64
        lib.cpu_voxelize.argtypes = [
            _f32p, ctypes.c_int64, ctypes.c_int64, _f32p, _f32p, _i32p,
            ctypes.c_int64, ctypes.c_int64, _f32p, _i32p, _i32p]
        lib.points_in_boxes_cpu.restype = None
        lib.points_in_boxes_cpu.argtypes = [
            _f32p, ctypes.c_int64, ctypes.c_int64, _f32p, ctypes.c_int64,
            _i32p]
        lib.fov_mask.restype = None
        lib.fov_mask.argtypes = [
            _f32p, ctypes.c_int64, ctypes.c_int64, _f32p,
            ctypes.c_int32, ctypes.c_int32, _u8p]
        self.lib = lib

    def read_point_bin(self, path: str, num_features: int = 4,
                       max_points: int = 400_000) -> np.ndarray:
        """A float32 .bin point file -> (N, num_features), at most
        `max_points` points; raises FileNotFoundError."""
        buf = np.empty(max_points * num_features, np.float32)
        n = self.lib.read_point_bin(str(path).encode(), buf, buf.size)
        if n < 0:
            raise FileNotFoundError(path)
        return buf[:n].reshape(-1, num_features).copy()

    def transform_points(self, pts: np.ndarray, tm: np.ndarray) -> np.ndarray:
        """xyz of (N, F) points through a 4x4 row-major transform, in place
        when `pts` is already contiguous float32."""
        pts = np.ascontiguousarray(pts, np.float32)
        self.lib.transform_points(
            pts, pts.shape[0], pts.shape[1],
            np.ascontiguousarray(tm, np.float32).reshape(-1))
        return pts

    def voxelize(self, pts, voxel_size, range_min, grid_zyx,
                 max_voxels: int, max_points: int = 10):
        """The hard voxelizer: (mean features (max_voxels, F), coords zyx
        (max_voxels, 3), points per voxel, number of voxels)."""
        pts = np.ascontiguousarray(pts, np.float32)
        n, f = pts.shape
        feats = np.zeros((max_voxels, f), np.float32)
        coords = np.full((max_voxels, 3), -1, np.int32)
        npts = np.zeros((max_voxels,), np.int32)
        nv = self.lib.cpu_voxelize(
            pts, n, f, np.asarray(voxel_size, np.float32),
            np.asarray(range_min, np.float32), np.asarray(grid_zyx, np.int32),
            max_voxels, max_points, feats, coords, npts)
        return feats, coords, npts, int(nv)

    def points_in_boxes(self, pts, boxes) -> np.ndarray:
        """(N,) int32: the first of the (M, 7) boxes holding each point, or
        -1."""
        pts = np.ascontiguousarray(pts, np.float32)
        boxes = np.ascontiguousarray(boxes, np.float32)
        out = np.empty((pts.shape[0],), np.int32)
        self.lib.points_in_boxes_cpu(pts, pts.shape[0], pts.shape[1], boxes,
                                     boxes.shape[0], out)
        return out

    def fov_mask(self, pts, proj, img_h: int, img_w: int) -> np.ndarray:
        """(N,) bool: the points a (3, 4) lidar -> image matrix projects
        into the image, at depth over 0.1."""
        pts = np.ascontiguousarray(pts, np.float32)
        keep = np.empty((pts.shape[0],), np.uint8)
        self.lib.fov_mask(
            pts, pts.shape[0], pts.shape[1],
            np.ascontiguousarray(proj, np.float32).reshape(-1),
            img_h, img_w, keep)
        return keep.astype(bool)
