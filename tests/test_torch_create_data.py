"""Dataset preparation (`df3d_torch.tools.create_data`) against the JAX
package's tools/create_data.py (loaded by path: numpy only, no JAX
program), on tiny raw KITTI and nuScenes files that the port's writers
lay out as the distributions do (`utils.synth.write_kitti_raw`,
`write_nuscenes_raw`), from seeds.

Every field the JAX converter writes is equal: integers, names and paths
exactly, floats bit for bit (both run the same numpy arithmetic; stated
as atol 0), but `gt_names`, which equal the JAX names passed through
mmdet3d's NameMapping ("ignore" for the rest). The four faults of the JAX
converter that the port does not copy each have a test that shows both
results, and so does a fifth found on the way: nuScenes' `sample` table
has no `anns` column, which the JAX converter reads.

The gt database: the two packages' `points_in_boxes` differ only in
rounding (the JAX package's committed library contracts into fused
multiply-adds, ROADMAP §3; the port never loads it), so every point where
they disagree must lie within FACE_TOL of a box face; the frames carry
100 points on each box's faces, where rounding decides, and the test
prints how many points are disputed.

Then the port's infos are read back by the port's datasets (images too)
and train one step of the train CLI at `centerpoint_tiny_smoke` and at
the narrowed KITTI sets of tests/test_torch_runtime.py."""

import importlib.util
import json
import pickle
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from df3d.data import nuscenes as JN
from df3d.data.native import NativeLoader as JNative
from df3d_torch.data import kitti as TK
from df3d_torch.data import nuscenes as TN
from df3d_torch.data.native import NativeLoader
from df3d_torch.tools import create_data as port
from df3d_torch.tools import train as train_cli
from df3d_torch.train.evaluate import kitti_records
from df3d_torch.utils import synth
from torch_port_helpers import (  # noqa: F401
    KITTI_SMALL_SETS, NUSC_SMALL_SETS, one_torch_thread, tiny_kitti_samples,
    tiny_nusc_samples,
)

ROOT = Path(__file__).resolve().parents[1]
FACE_TOL = 1e-4  # m: a disputed point's distance to a box face
VERSION = "v1.0-mini"
NUSC_IMAGE = (90, 160)
KITTI_SHAPES = [(375, 1242), (370, 1224), (375, 1242)]
# raw categories: mapped, already a detection name, and unmapped
RAW_NAMES = ("vehicle.car", "human.pedestrian.child", "animal", "car",
             "vehicle.bus.bendy", "movable_object.trafficcone",
             "vehicle.construction", "human.pedestrian.wheelchair")


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_create_data", ROOT / "tools" / "create_data.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _add_anns(root):
    """The devkit's reverse index (`sample["anns"]`, in the annotation
    table's order), which the JAX converter reads from the table."""
    tdir = Path(root) / VERSION
    samples = json.loads((tdir / "sample.json").read_text())
    anns = json.loads((tdir / "sample_annotation.json").read_text())
    for s in samples:
        s["anns"] = [a["token"] for a in anns if a["sample_token"] ==
                     s["token"]]
    (tdir / "sample.json").write_text(json.dumps(samples))


@pytest.fixture(scope="module")
def nusc(tmp_path_factory):
    """Raw tables of three samples (a key frame and nine sweeps each, six
    cameras, boxes of RAW_NAMES), converted by both packages (each in its
    own copy: both write df3d_nusc_infos_<version>.pkl)."""
    rng = np.random.RandomState(0)
    samples = [(f, b, [RAW_NAMES[k % len(RAW_NAMES)] for k in range(
        len(b))]) for f, b, _ in tiny_nusc_samples(rng, 3, n_boxes=8)]
    raw = tmp_path_factory.mktemp("nusc_raw")
    synth.write_nuscenes_raw(raw, samples, VERSION,
                             image_rng=np.random.RandomState(1),
                             image_shape=NUSC_IMAGE)
    roots = {}
    for tag in ("port", "jax"):
        roots[tag] = tmp_path_factory.mktemp(f"nusc_{tag}")
        shutil.copytree(raw, roots[tag], dirs_exist_ok=True)
    _add_anns(roots["jax"])
    jax_tool = _jax_tool()
    return dict(
        samples=samples, raw=raw, roots=roots,
        port=port.main(["nuscenes", "--root", str(roots["port"]),
                        "--version", VERSION]),
        jax=jax_tool.create_nuscenes_infos(roots["jax"], VERSION),
        jax_tool=jax_tool)


def _assert_equal(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype, b.dtype)
    np.testing.assert_allclose(a, b, rtol=0, atol=0, err_msg=what) if (
        a.dtype.kind == "f") else np.testing.assert_array_equal(a, b, what)


def test_nuscenes_infos_equal_jax(nusc):
    """Every field of the JAX converter's infos, sweeps and cameras equal
    the port's; the names are the JAX names mapped."""
    assert len(nusc["port"]) == len(nusc["jax"]) == 3
    mapped = 0
    for p, j in zip(nusc["port"], nusc["jax"]):
        assert set(j) == set(p)
        for k in ("token", "scene_name", "scene_token", "lidar_path",
                  "timestamp", "gt_boxes", "gt_velocity"):
            _assert_equal(p[k], j[k], k)
        want = [port.detection_name(n) for n in j["gt_names"]]
        assert p["gt_names"].tolist() == want
        assert {"car", "pedestrian", "bus", "traffic_cone",
                "construction_vehicle", "ignore"} == set(want)
        mapped += sum(a != b for a, b in zip(want, j["gt_names"]))
        assert len(p["sweeps"]) == len(j["sweeps"]) == 9
        for ps, js in zip(p["sweeps"], j["sweeps"]):
            assert set(ps) == set(js)
            for k in js:
                _assert_equal(ps[k], js[k], f"sweep {k}")
        assert list(p["cams"]) == list(j["cams"]) == list(port.NUSC_CAMERAS)
        for cam, jc in j["cams"].items():
            assert set(p["cams"][cam]) == set(jc) | {"camera_intrinsics"}
            for k in jc:
                _assert_equal(p["cams"][cam][k], jc[k], f"{cam} {k}")
    assert mapped > 0


def test_nuscenes_round_trip(nusc):
    """The port's dataset on the port's infos gives each frame's points
    back (its sweeps moved through their pose chains: within 1e-5 m) and
    its boxes of detection classes with their velocities, in the frame's
    LiDAR frame."""
    ds = TN.NuScenesDataset(nusc["roots"]["port"],
                            nusc["roots"]["port"]
                            / f"df3d_nusc_infos_{VERSION}.pkl")
    for i, (frame, boxes, names) in enumerate(nusc["samples"]):
        got = ds[i]

        def rows(a):
            return a[np.lexsort(np.round(a[:, [4, 3]], 4).T)]

        assert got["points"].shape == frame.shape
        np.testing.assert_allclose(rows(got["points"]), rows(frame),
                                   rtol=0, atol=1e-5)
        keep = np.isin([port.detection_name(n) for n in names],
                       TN.NUSC_CLASSES)
        np.testing.assert_allclose(got["gt_boxes"], boxes[keep],
                                   rtol=0, atol=1e-5)


def test_fault_nuscenes_category_names(nusc):
    """JAX infos name boxes by raw category (`vehicle.car`): the dataset
    (the JAX package's and the port's alike) drops every box so named.
    The port's infos name them `car`, `pedestrian`, ..., and keep them."""
    jax_info = nusc["roots"]["jax"] / f"df3d_nusc_infos_{VERSION}.pkl"
    port_info = nusc["roots"]["port"] / f"df3d_nusc_infos_{VERSION}.pkl"
    for i, (_, boxes, names) in enumerate(nusc["samples"]):
        kept_jax = JN.NuScenesDataset(nusc["roots"]["jax"], jax_info)[i]
        kept_port = TN.NuScenesDataset(nusc["roots"]["port"], port_info)[i]
        raw_detection = sum(n in TN.NUSC_CLASSES for n in names)  # "car"
        assert len(kept_jax["gt_boxes"]) == raw_detection == 1
        assert len(kept_port["gt_boxes"]) == 6
        assert "vehicle.car" in names


def test_fault_nuscenes_camera_intrinsics(nusc):
    """The datasets read each camera's `camera_intrinsics`: with images,
    the JAX package's dataset raises on the JAX infos (`cam_intrinsic`
    only), and the port's reads the port's infos: six cameras at the
    loader's size, each box centre in front of some camera projecting
    where the intrinsics and lidar2cam say."""
    jax_info = nusc["roots"]["jax"] / f"df3d_nusc_infos_{VERSION}.pkl"
    with pytest.raises(KeyError, match="camera_intrinsics"):
        JN.NuScenesDataset(nusc["roots"]["jax"], jax_info,
                           load_images=True, image_shape=(45, 80))[0]
    root = nusc["roots"]["port"]
    ds = TN.NuScenesDataset(root, root / f"df3d_nusc_infos_{VERSION}.pkl",
                            load_images=True, image_shape=(45, 80))
    s = ds[0]
    assert s["images"].shape == (6, 45, 80, 3)
    cams = ds.infos[0]["cams"]
    for proj, name in zip(s["cam_projs"], sorted(cams)):
        c = cams[name]
        want = (np.vstack([c["camera_intrinsics"] @ c["lidar2cam"][:3],
                           [0, 0, 0, 1]]))[:3]
        np.testing.assert_allclose(proj, want, rtol=1e-6)
    # the rig's intrinsics at the raw images' size
    np.testing.assert_allclose(cams["CAM_FRONT"]["camera_intrinsics"],
                               synth.rig_intrinsics(NUSC_IMAGE), rtol=1e-6)


def test_fault_nuscenes_sample_anns(nusc, tmp_path):
    """nuScenes' `sample` rows carry no `anns` (the devkit indexes the
    annotations itself): the JAX converter raises on the tables as
    distributed, the port's reads them (the infos above)."""
    shutil.copytree(nusc["raw"], tmp_path, dirs_exist_ok=True)
    rows = json.loads((tmp_path / VERSION / "sample.json").read_text())
    assert rows and all("anns" not in r for r in rows)
    with pytest.raises(KeyError, match="anns"):
        nusc["jax_tool"].create_nuscenes_infos(tmp_path, VERSION)


# ---------------------------------------------------------------------------
# KITTI


def _kitti_samples():
    """Three frames of `tiny_kitti_samples` with, per box, 100 points on
    its faces (float32 rounding puts them on either side), a Pedestrian
    box and a DontCare line in the first frame's label."""
    rng = np.random.RandomState(0)
    out = []
    for i, (pts, boxes) in enumerate(tiny_kitti_samples(rng, 3, 2000)):
        faces = []
        for b in boxes:
            local = np.stack([
                rng.choice([-0.5, 0.5], 100) * b[3],
                rng.uniform(-0.45, 0.45, 100) * b[4],
                rng.uniform(-0.45, 0.45, 100) * b[5]], 1)
            c, s = np.cos(b[6]), np.sin(b[6])
            xy = local[:, :2] @ np.array([[c, s], [-s, c]])
            faces.append(np.concatenate(
                [xy + b[:2], local[:, 2:] + b[2], rng.rand(100, 1)], 1))
        pts = np.concatenate([pts] + faces).astype(np.float32)
        names = ["Car"] * len(boxes)
        if i == 0:
            names[-1] = "Pedestrian"
        out.append((pts, boxes, names))
    return out


@pytest.fixture(scope="module")
def kitti(tmp_path_factory):
    samples = _kitti_samples()
    raw = tmp_path_factory.mktemp("kitti_raw")
    synth.write_kitti_raw(raw, samples, image_rng=np.random.RandomState(1),
                          image_shapes=KITTI_SHAPES)
    label = raw / "training" / "label_2" / "000000.txt"
    label.write_text(label.read_text() + "DontCare -1 -1 -10 503.89 169.71 "
                     "590.61 190.13 -1 -1 -1 -1000 -1000 -1000 -10\n")
    roots, jax_tool = {}, _jax_tool()
    for tag in ("port", "jax"):
        roots[tag] = tmp_path_factory.mktemp(f"kitti_{tag}")
        shutil.copytree(raw, roots[tag], dirs_exist_ok=True)
    infos = {"port": port.main(["kitti", "--root", str(roots["port"]),
                                "--with-gt-database",
                                "--with-image-crops"]),
             "jax": jax_tool.create_kitti_infos(roots["jax"], "train")}
    jax_tool.create_gt_database(roots["jax"], "train",
                                with_image_crops=True)
    db = {tag: pickle.load(open(roots[tag] / "kitti_dbinfos_train.pkl",
                                "rb")) for tag in roots}
    return dict(samples=samples, roots=roots, infos=infos, db=db)


def test_kitti_infos_equal_jax(kitti):
    """Every field of the JAX converter's KITTI infos equals the port's
    (`image_shape` where the image is 375x1242); the port's annos add
    pcdet's location, dimensions (l, h, w), rotation_y and alpha, the
    labels' own columns."""
    for p, j, shape in zip(kitti["infos"]["port"], kitti["infos"]["jax"],
                           KITTI_SHAPES):
        assert set(p) == set(j)
        assert p["point_cloud"] == j["point_cloud"]
        for k in j["calib"]:
            _assert_equal(p["calib"][k], j["calib"][k], k)
        assert p["image"]["image_idx"] == j["image"]["image_idx"]
        _assert_equal(p["image"]["image_shape"], np.array(shape), "shape")
        assert set(p["annos"]) == set(j["annos"]) | {
            "location", "dimensions", "rotation_y", "alpha"}
        for k in j["annos"]:
            _assert_equal(p["annos"][k], j["annos"][k], k)
        cam = np.concatenate([p["annos"]["location"],
                              p["annos"]["dimensions"],
                              p["annos"]["rotation_y"][:, None]], 1)
        calib = TK.parse_calib_file(kitti["roots"]["port"] / "training"
                                    / "calib" / "000000.txt")
        _assert_equal(TK.camera_box_to_lidar(cam, calib),
                      p["annos"]["gt_boxes_lidar"], "gt_boxes_lidar")
    names = kitti["infos"]["port"][0]["annos"]["name"].tolist()
    assert names[-2:] == ["Pedestrian", "DontCare"]


def test_fault_kitti_annos_fields(kitti):
    """The test CLI's KITTI loop (`train.evaluate.kitti_records`, the port
    of tools/test.py:230-236) reads the annos' location, dimensions and
    rotation_y: it raises on the JAX infos and, on the port's, gives gt
    boxes equal to the infos' gt_boxes_lidar."""
    out = {"boxes": np.zeros((1, 1, 7), np.float32),
           "scores": np.zeros((1, 1), np.float32),
           "labels": np.zeros((1, 1), np.int32),
           "valid": np.zeros((1, 1), bool)}
    for tag in ("jax", "port"):
        root = kitti["roots"][tag]
        s = TK.KittiDataset(root, root / "kitti_infos_train.pkl",
                            training=False)[0]
        if tag == "jax":
            with pytest.raises(KeyError, match="location"):
                kitti_records(out, [s], ("Car",), {})
            continue
        gts, _ = kitti_records(out, [s], ("Car",), {})
        np.testing.assert_allclose(
            gts[0]["boxes_lidar"][:-1],
            kitti["infos"]["port"][0]["annos"]["gt_boxes_lidar"][:-1],
            rtol=0, atol=1e-6)


def test_fault_kitti_image_shape(kitti):
    """Frame 1's image is 370x1224: the port's infos say so and the
    training FOV crop keeps only points inside that image; the JAX
    infos say 375x1242 and keep points that project past its bottom and
    right edges."""
    assert kitti["infos"]["jax"][1]["image"]["image_shape"].tolist() == [
        375, 1242]
    assert kitti["infos"]["port"][1]["image"]["image_shape"].tolist() == [
        370, 1224]
    got = {}
    for tag in ("jax", "port"):
        root = kitti["roots"][tag]
        got[tag] = TK.KittiDataset(root, root / "kitti_infos_train.pkl",
                                   use_cpp_loader=False)[1]
    proj = got["port"]["proj"]

    def uv(p):
        h = np.concatenate([p[:, :3], np.ones_like(p[:, :1])], 1) @ proj.T
        return h[:, :2] / h[:, 2:]

    inside = lambda p: ((uv(p)[:, 0] < 1224) & (uv(p)[:, 1] < 370)).all()
    assert inside(got["port"]["points"])
    assert not inside(got["jax"]["points"])
    assert len(got["jax"]["points"]) > len(got["port"]["points"])


def _face_distance(p, box):
    """Distance (m) of point p to the nearest face of a 7-dof box."""
    d = p[:3] - box[:3]
    c, s = np.cos(-box[6]), np.sin(-box[6])
    local = np.array([d[0] * c - d[1] * s, d[0] * s + d[1] * c, d[2]])
    return float(np.min(np.abs(np.abs(local) - box[3:6] / 2)))


def test_gt_database_equal_jax(kitti):
    """The gt databases agree: the same entries, boxes and 2D crops
    (arrays equal, the crops cut from the decoded PNGs), and each
    object's points equal but where the two packages' `points_in_boxes`
    disagree, each such point within FACE_TOL of a box face (counted)."""
    roots, db = kitti["roots"], kitti["db"]
    assert set(db["port"]) == set(db["jax"]) == {"Car"}
    disputed = 0
    ds = TK.KittiDataset(roots["port"], roots["port"]
                         / "kitti_infos_train.pkl")
    tnative, jnative = NativeLoader(), JNative()
    frames = {ds[i]["sample_idx"]: ds[i] for i in range(len(ds))}
    for frame in frames.values():
        a = tnative.points_in_boxes(frame["points"], frame["gt_boxes"])
        b = jnative.points_in_boxes(frame["points"], frame["gt_boxes"])
        for i in np.flatnonzero(a != b):
            box = frame["gt_boxes"][max(a[i], b[i])]
            assert _face_distance(frame["points"][i], box) <= FACE_TOL
            disputed += 1
    print(f"points_in_boxes disputes: {disputed}")
    crops = 0
    assert len(db["port"]["Car"]) == len(db["jax"]["Car"]) > 4
    for p, j in zip(db["port"]["Car"], db["jax"]["Car"]):
        assert p.keys() == j.keys() and p["path"] == j["path"]
        _assert_equal(p["box3d_lidar"], j["box3d_lidar"], "box")
        pts_p = np.load(roots["port"] / p["path"])
        pts_j = np.load(roots["jax"] / j["path"])
        if p["num_points"] == j["num_points"]:
            _assert_equal(pts_p, pts_j, p["path"])
        assert abs(p["num_points"] - j["num_points"]) <= disputed
        if "image_crop_path" in j:
            crops += 1
            _assert_equal(p["bbox2d"], j["bbox2d"], "bbox2d")
            _assert_equal(np.load(roots["port"] / p["image_crop_path"]),
                          np.load(roots["jax"] / j["image_crop_path"]),
                          "crop")
    assert crops == len(db["port"]["Car"])


def test_infos_train_the_cli(nusc, kitti, tmp_path):
    """The port's infos through one train CLI step each: nuScenes at
    `centerpoint_tiny_smoke` (narrowed) and KITTI at the runtime tests'
    narrowed `voxel_rcnn_car_kitti`; and the KITTI dataset's images."""
    root = kitti["roots"]["port"]
    s = TK.KittiDataset(root, root / "kitti_infos_train.pkl",
                        load_images=True)[1]
    assert s["image"].shape == (370, 1224, 3)
    nroot = nusc["roots"]["port"]
    for data, info, preset, sets in (
            (nroot, nroot / f"df3d_nusc_infos_{VERSION}.pkl",
             "centerpoint_tiny_smoke", NUSC_SMALL_SETS),
            (root, root / "kitti_infos_train.pkl", "voxel_rcnn_car_kitti",
             KITTI_SMALL_SETS)):
        runner = train_cli.main([
            "--preset", preset, "--data-root", str(data), "--info-path",
            str(info), "--batch-size", "2", "--max-points", "2000",
            "--epochs", "1", "--steps-per-epoch", "1", "--log-interval", "1",
            "--device", "cpu", "--work-dir", str(tmp_path / preset),
            "--set", *sets])
        assert runner.global_step == 1
        rec = json.loads((tmp_path / preset / "train_log.jsonl").read_text())
        assert np.isfinite(rec["loss"]) and rec["loss"] > 0
        assert torch.isfinite(torch.cat([
            p.detach().flatten() for p in runner.state.params])).all()
