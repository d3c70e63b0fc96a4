"""The port's datasets against the JAX package's: the C++ point loader
binding (`df3d_torch/data/native.py`), KITTI's calib parser and info-pkl
dataset (`kitti.py`) and nuScenes' sweep accumulation, dataset and CBGS
wrapper (`nuscenes.py`), on tiny datasets that the tests write
(`torch_port_helpers.write_tiny_kitti`, `write_tiny_nuscenes`). Equal bit
for bit; no JAX program is compiled.

The JAX package's loader loads the committed `csrc/libdf3dio.so`, built
with `-march=native`, whose `transform_points` contracts its sums into
fused multiply-adds; the port builds the same source without contraction,
so its `transform_points` equals numpy's f32 arithmetic and stays within
rounding of the JAX library's (the test states the bound)."""

import pickle

import numpy as np
import pytest

from df3d.data import kitti as JK
from df3d.data import nuscenes as JN
from df3d.data.native import NativeLoader as JNative
from df3d_torch.data import kitti as TK
from df3d_torch.data import native as tnative
from df3d_torch.data import nuscenes as TN
from df3d_torch.utils.synth import kitti_camera
from torch_port_helpers import assert_same as _equal
from torch_port_helpers import (  # noqa: F401
    one_torch_thread, write_tiny_kitti, write_tiny_nuscenes,
)


def test_native_loader_equal(tmp_path):
    """read_point_bin, voxelize, points_in_boxes and fov_mask equal the JAX
    loader's; transform_points equals numpy's f32 chain, and the JAX
    library's (fused multiply-adds) within three ulps of its largest
    partial sum."""
    port, jax_lib = tnative.NativeLoader(), JNative()
    rng = np.random.RandomState(0)
    pts = np.concatenate([rng.uniform(-40, 40, (20000, 3)),
                          rng.rand(20000, 1)], 1).astype(np.float32)
    path = tmp_path / "p.bin"
    pts.tofile(path)
    _equal(port.read_point_bin(str(path)), jax_lib.read_point_bin(str(path)))
    _equal(port.read_point_bin(str(path), 4, 1000),
           jax_lib.read_point_bin(str(path), 4, 1000))
    with pytest.raises(FileNotFoundError):
        port.read_point_bin(str(tmp_path / "missing.bin"))
    vox = ([0.5, 0.5, 0.2], [-40, -40, -3], [30, 160, 160], 5000, 5)
    _equal(port.voxelize(pts, *vox), jax_lib.voxelize(pts, *vox))
    boxes = np.concatenate([rng.uniform(-30, 30, (40, 3)),
                            rng.uniform(1, 5, (40, 3)),
                            rng.uniform(-3, 3, (40, 1))], 1).astype(np.float32)
    _equal(port.points_in_boxes(pts, boxes), jax_lib.points_in_boxes(pts,
                                                                     boxes))
    proj = kitti_camera()
    _equal(port.fov_mask(pts, proj, 375, 1242),
           jax_lib.fov_mask(pts, proj, 375, 1242))
    tm = rng.randn(4, 4).astype(np.float32)
    got = port.transform_points(pts.copy(), tm)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    want = np.stack([tm[i, 0] * x + tm[i, 1] * y + tm[i, 2] * z + tm[i, 3]
                     for i in range(3)], 1)
    _equal(got[:, :3], want)
    _equal(got[:, 3], pts[:, 3])
    fma = jax_lib.transform_points(pts.copy(), tm)[:, :3]
    # three roundings apart at most, each within an ulp of the largest
    # partial sum
    mag = (np.abs(tm[None, :3, :3] * pts[:, None, :3]).sum(-1)
           + np.abs(tm[:3, 3]))
    assert (np.abs(fma - got[:, :3]) <= 3 * np.spacing(mag)).all()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    """With no library built and no compiler, the loader and a KITTI
    dataset asked for the C++ loader raise; nothing falls back to numpy.
    The library goes under build/, never next to the source."""
    info = write_tiny_kitti(tmp_path, n=1)
    built = tnative.library_path()
    assert built.parent.parts[-2:] == ("build", "df3d_torch")
    monkeypatch.setattr(tnative, "library_path",
                        lambda: tmp_path / "absent" / "libpointio.so")
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match=r"g\+\+ not found"):
        tnative.NativeLoader()
    with pytest.raises(RuntimeError):
        TK.KittiDataset(tmp_path, info, use_cpp_loader=True)
    assert len(TK.KittiDataset(tmp_path, info, use_cpp_loader=False)) == 1


def test_parse_calib_file_equal(tmp_path):
    """KITTI calib files with R0_rect and Tr_velo_to_cam, and with R0 and
    Tr_velo2cam."""
    from test_kitti_data import CALIB_TXT

    alt = CALIB_TXT.replace("R0_rect", "R0").replace("Tr_velo_to_cam",
                                                     "Tr_velo2cam")
    no_r0 = "\n".join(l for l in CALIB_TXT.splitlines()
                      if not l.startswith("R0"))
    for i, text in enumerate((CALIB_TXT, alt, no_r0)):
        path = tmp_path / f"calib{i}.txt"
        path.write_text(text)
        _equal(TK.parse_calib_file(path), JK.parse_calib_file(path))


@pytest.mark.parametrize("cpp", [True, False], ids=["cpp", "numpy"])
def test_kitti_dataset_equal(tmp_path, cpp):
    """KittiDataset against the JAX class on the same branch (C++ loader
    or numpy): training (FOV crop, road plane), eval, the test split's
    folder, annos with and without lidar boxes, DontCare and other
    classes, and the raw image."""
    info = write_tiny_kitti(tmp_path, n=3, images=True)
    with open(info, "rb") as f:
        infos = pickle.load(f)
    # frame 1 keeps only the camera boxes and gains a DontCare and a
    # pedestrian; frame 2 has a road plane
    a = infos[1]["annos"]
    for k in ("name", "truncated", "occluded", "bbox", "alpha", "location",
              "dimensions", "rotation_y"):
        a[k] = np.concatenate([a[k], a[k][:2]])
    a["name"][-2:] = ["DontCare", "Pedestrian"]
    del a["gt_boxes_lidar"]
    del infos[2]["image"]
    with open(info, "wb") as f:
        pickle.dump(infos, f)
    planes = tmp_path / "training" / "planes"
    planes.mkdir()
    (planes / "000002.txt").write_text(
        "# Plane\nWidth 4\nHeight 1\n-1.0e-02 9.9e-01 2.0e-02 1.65e+00\n")
    jax_cpp = JNative() if cpp else None
    for kw in (dict(training=True), dict(training=False),
               dict(training=True, class_names=("Car", "Pedestrian"),
                    load_images=True)):
        port = TK.KittiDataset(tmp_path, info, use_cpp_loader=cpp, **kw)
        ref = JK.KittiDataset(tmp_path, info, use_cpp_loader=False, **kw)
        ref._cpp = jax_cpp
        assert (port._cpp is not None) == cpp
        assert len(port) == len(ref) == 3
        for i in range(3):
            _equal(port[i], ref[i])
        if kw["training"]:
            assert len(port[0]["points"]) < 400  # the crop dropped some
            assert "road_plane" in port[2]
    test_info = tmp_path / "kitti_infos_test.pkl"
    test_info.write_bytes(info.read_bytes())
    assert TK.KittiDataset(tmp_path, test_info,
                           use_cpp_loader=cpp).split_dir == "testing"


def test_nuscenes_dataset_equal(tmp_path):
    """NuScenesDataset against the JAX class: 10 sweeps and fewer, 7-dof
    boxes with velocities zero-filled to 9, the class filter, infos as a
    dict and as a list, and four cameras sorted by name with lidar2cam or
    lidar2cam_matrix, decoded, resized and their projections scaled."""
    info = write_tiny_nuscenes(tmp_path, n=2)
    cams = tmp_path / "with_cams"
    cams.mkdir()
    cam_info = write_tiny_nuscenes(cams, n=2, seed=1, cams=4)
    names = ("car", "truck", "bus", "pedestrian")
    for root, path, kw in (
            (tmp_path, info, {}), (tmp_path, info, dict(nsweeps=4)),
            (tmp_path, info, dict(class_names=names)),
            (cams, cam_info, dict(load_images=True, image_shape=(64, 112)))):
        port = TN.NuScenesDataset(root, path, **kw)
        ref = JN.NuScenesDataset(root, path, **kw)
        for i in range(len(ref)):
            _equal(port[i], ref[i])
    assert port[0]["images"].shape == (4, 64, 112, 3)
    assert TN.NUSC_CLASSES == JN.NUSC_CLASSES
    # the frames come back whole from their key frame and sweeps
    frame = TN.NuScenesDataset(tmp_path, info)[0]["points"]
    assert frame.shape == (600, 5) and len(np.unique(frame[:, 4])) == 10


def test_accumulate_sweeps_and_cbgs_equal(tmp_path):
    """accumulate_sweeps with max_points (the port draws from an explicit
    RandomState, the JAX package from numpy's global generator, seeded
    alike) and CBGSWrapper's draw counts and per-epoch redraws."""
    info = write_tiny_nuscenes(tmp_path, n=6)
    with open(info, "rb") as f:
        infos = pickle.load(f)["infos"]
    for seed, cap in ((0, 250), (5, 599), (9, None)):
        np.random.seed(seed)
        want = JN.accumulate_sweeps(infos[seed % 6], tmp_path, 10, cap)
        got = TN.accumulate_sweeps(infos[seed % 6], tmp_path, 10, cap,
                                   rng=np.random.RandomState(seed))
        _equal(got, want)
    with pytest.raises(ValueError):
        TN.accumulate_sweeps(infos[0], tmp_path, 10, 10)
    port = TN.CBGSWrapper(TN.NuScenesDataset(tmp_path, info))
    ref = JN.CBGSWrapper(JN.NuScenesDataset(tmp_path, info))
    for epoch in (0, 1, 7):
        port.resample(epoch)
        ref.resample(epoch)
        assert port.indices == ref.indices and len(port) == len(ref)
        _equal(port[3], ref[3])
