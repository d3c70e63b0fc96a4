"""Dataset preparation (port of the JAX package's tools/create_data.py):
raw KITTI and nuScenes files -> the info pkls the port's datasets read,
and KITTI's gt database for the copy-paste augmentor.

    python -m df3d_torch.tools.create_data kitti --root /data/kitti \\
        --split train [--with-gt-database [--with-image-crops]]
    python -m df3d_torch.tools.create_data nuscenes --root /data/nuscenes \\
        --version v1.0-trainval [--max-sweeps 10]

Every field the JAX converter writes is written with its value, and the
infos also carry what the port's loaders and test CLI read, where the JAX
converter leaves it out or names it otherwise (each pinned by
tests/test_torch_create_data.py):

* nuScenes: `gt_names` are detection names (mmdet3d's
  `NuScenesDataset.NameMapping`, det3d's `general_to_detection`;
  "ignore" for every other category), where the JAX converter keeps the
  raw category names (`vehicle.car`), which the dataset then drops; each
  camera carries `camera_intrinsics`, the key the dataset reads, beside
  `cam_intrinsic`; a sample's annotations are found through the
  `sample_annotation` table, as the devkit indexes them, since nuScenes'
  `sample` rows carry no `anns` (the JAX converter reads that key);
* KITTI: each anno carries pcdet's `location`, `dimensions` (l, h, w),
  `rotation_y` and `alpha`, which the test CLI's KITTI loop reads, and
  `image_shape` is the image's own, read from its header, where the JAX
  converter writes 375x1242 for every frame (375x1242 too when a frame
  has no image, as the JAX converter).

The conversion is host work (numpy, the point loader's `points_in_boxes`
and Pillow): it runs no model and launches nothing on a card, so it takes
no `--device`.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import pickle

import numpy as np

from df3d_torch.data.images import decode_image, read_image_shape
from df3d_torch.data.kitti import (
    KittiDataset, camera_box_to_lidar, parse_calib_file,
)
from df3d_torch.data.native import NativeLoader

KITTI_DEFAULT_SHAPE = (375, 1242)
NUSC_CAMERAS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
                "CAM_BACK", "CAM_BACK_RIGHT", "CAM_BACK_LEFT")
# raw nuScenes category -> detection class (mmdet3d NuScenesDataset.
# NameMapping); a name that is already a detection class passes through,
# any other becomes "ignore" (det3d general_to_detection)
NUSC_NAME_MAPPING = {
    "movable_object.barrier": "barrier",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.car": "car",
    "vehicle.construction": "construction_vehicle",
    "vehicle.motorcycle": "motorcycle",
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "human.pedestrian.police_officer": "pedestrian",
    "movable_object.trafficcone": "traffic_cone",
    "vehicle.trailer": "trailer",
    "vehicle.truck": "truck",
}
_DETECTION_NAMES = frozenset(NUSC_NAME_MAPPING.values())


def detection_name(category: str) -> str:
    """A raw nuScenes category name -> its detection class, or "ignore"."""
    if category in _DETECTION_NAMES:
        return category
    return NUSC_NAME_MAPPING.get(category, "ignore")


# ---------------------------------------------------------------------------
# KITTI


def _pad4(m3):
    out = np.eye(4, dtype=np.float32)
    out[:3, :3] = m3
    return out


def _read_label(path):
    """A label_2 file -> (names, truncated, occluded, alpha, bbox (n, 4),
    camera boxes (n, 7) x, y, z, l, h, w, ry)."""
    names, trunc, occ, alpha, bbox, cam_boxes = [], [], [], [], [], []
    for line in open(path):
        f = line.split()
        if not f:
            continue
        names.append(f[0])
        trunc.append(float(f[1]))
        occ.append(float(f[2]))
        alpha.append(float(f[3]))
        bbox.append([float(v) for v in f[4:8]])
        # h, w, l, x, y, z, ry -> cam (x, y, z, l, h, w, ry)
        h, w, l = float(f[8]), float(f[9]), float(f[10])
        x, y, z = float(f[11]), float(f[12]), float(f[13])
        cam_boxes.append([x, y, z, l, h, w, float(f[14])])
    return (names, trunc, occ, alpha, np.asarray(bbox, np.float32).reshape(
        -1, 4), np.asarray(cam_boxes, np.float32).reshape(-1, 7))


def create_kitti_infos(root, split: str = "train") -> list[dict]:
    """ImageSets/<split>.txt's frames under training/ -> kitti_infos_
    <split>.pkl under `root` (pcdet's layout) -> the infos."""
    root = pathlib.Path(root)
    ids = [l.strip() for l in open(root / "ImageSets" / f"{split}.txt")
           if l.strip()]
    infos = []
    for idx in ids:
        calib = parse_calib_file(root / "training" / "calib" / f"{idx}.txt")
        image = root / "training" / "image_2" / f"{idx}.png"
        shape = (read_image_shape(image) if image.exists()
                 else KITTI_DEFAULT_SHAPE)
        info = {
            "point_cloud": {"lidar_idx": idx, "num_features": 4},
            "calib": {
                "P2": np.vstack([calib["P2"], [0, 0, 0, 1]]),
                "R0_rect": _pad4(calib["R0"]),
                "Tr_velo_to_cam": np.vstack([calib["V2C"], [0, 0, 0, 1]]),
            },
            "image": {"image_idx": idx, "image_shape": np.array(shape)},
        }
        label = root / "training" / "label_2" / f"{idx}.txt"
        if label.exists():
            names, trunc, occ, alpha, bbox, cam = _read_label(label)
            info["annos"] = {
                "name": np.asarray(names),
                "truncated": np.asarray(trunc),
                "occluded": np.asarray(occ),
                "bbox": bbox,
                "gt_boxes_lidar": camera_box_to_lidar(cam, calib)
                if len(cam) else np.zeros((0, 7), np.float32),
                "alpha": np.asarray(alpha),
                "location": cam[:, :3],
                "dimensions": cam[:, 3:6],
                "rotation_y": cam[:, 6],
            }
        infos.append(info)
    out = root / f"kitti_infos_{split}.pkl"
    with open(out, "wb") as f:
        pickle.dump(infos, f)
    print(f"wrote {len(infos)} infos -> {out}")
    return infos


def create_gt_database(root, split: str = "train", classes=("Car",),
                       with_image_crops: bool = False) -> dict:
    """Each gt object's points (box-local, the point loader's
    `points_in_boxes` over the camera-FOV-cropped frame) and, with
    `with_image_crops`, its label's 2D-bbox patch of the camera image
    (pcdet database_sampler.py:166-230) -> gt_database/*.npy and
    kitti_dbinfos_<split>.pkl under `root` -> the db."""
    root = pathlib.Path(root)
    ds = KittiDataset(root, root / f"kitti_infos_{split}.pkl",
                      class_names=classes, use_cpp_loader=True)
    lib = NativeLoader()
    db_dir = root / "gt_database"
    db_dir.mkdir(exist_ok=True)
    db = {c: [] for c in classes}
    for i in range(len(ds)):
        s = ds[i]
        if "gt_boxes" not in s or not len(s["gt_boxes"]):
            continue
        image = None
        if with_image_crops:
            img_path = (root / "training" / "image_2"
                        / f"{s['sample_idx']}.png")
            if img_path.exists():
                image = decode_image(img_path)
        box_of_point = lib.points_in_boxes(s["points"], s["gt_boxes"])
        bboxes2d = s.get("gt_bbox2d")
        for j, (box, name) in enumerate(zip(s["gt_boxes"], s["gt_names"])):
            pts = s["points"][box_of_point == j].copy()
            pts[:, :3] -= box[:3]  # store box-local
            path = db_dir / f"{s['sample_idx']}_{name}_{j}.npy"
            np.save(path, pts)
            entry = {"path": str(path.relative_to(root)),
                     "box3d_lidar": box, "num_points": len(pts)}
            if (image is not None and bboxes2d is not None
                    and j < len(bboxes2d)):
                x1, y1, x2, y2 = [int(round(v)) for v in bboxes2d[j]]
                x1, y1 = max(x1, 0), max(y1, 0)
                x2 = min(x2, image.shape[1])
                y2 = min(y2, image.shape[0])
                if x2 - x1 >= 2 and y2 - y1 >= 2:
                    cpath = db_dir / f"{s['sample_idx']}_{name}_{j}_crop.npy"
                    np.save(cpath, image[y1:y2, x1:x2])
                    entry["image_crop_path"] = str(cpath.relative_to(root))
                    entry["bbox2d"] = np.array([x1, y1, x2, y2], np.float32)
            db[name].append(entry)
    out = root / f"kitti_dbinfos_{split}.pkl"
    with open(out, "wb") as f:
        pickle.dump(db, f)
    print(f"wrote gt database -> {out}")
    return db


# ---------------------------------------------------------------------------
# nuScenes


def _quat_to_rot(q):
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ], np.float64)


def _pose_mat(rec):
    m = np.eye(4)
    m[:3, :3] = _quat_to_rot(rec["rotation"])
    m[:3, 3] = rec["translation"]
    return m


def create_nuscenes_infos(root, version: str = "v1.0-trainval",
                          max_sweeps: int = 10) -> list[dict]:
    """The relational JSON tables of `root/version` (no devkit) ->
    df3d_nusc_infos_<version>.pkl under `root` ({"infos", "version"}) ->
    the infos: per sample with a LIDAR_TOP key frame, its path and
    timestamp, up to `max_sweeps` earlier sweeps with their sweep -> key
    transforms and time lags, the six cameras' paths, lidar2cam,
    intrinsics and lidar2img, the boxes in the key frame's LiDAR frame
    (x, y, z, l, w, h, yaw) with their detection names and the devkit's
    velocities (det3d nusc_common.py, TransFusion's
    nuscenes_converter.py)."""
    root = pathlib.Path(root)
    tdir = root / version

    def table(name):
        with open(tdir / f"{name}.json") as f:
            return {r["token"]: r for r in json.load(f)}

    samples = table("sample")
    sample_data = table("sample_data")
    ego_poses = table("ego_pose")
    calib_sensors = table("calibrated_sensor")
    annotations = table("sample_annotation")
    instances = table("instance")
    categories = table("category")
    sensors = table("sensor")
    scenes = table("scene")

    def sd_to_global(sd):
        """sensor -> global 4x4 of a sample_data record."""
        car = _pose_mat(ego_poses[sd["ego_pose_token"]])
        return car @ _pose_mat(calib_sensors[sd["calibrated_sensor_token"]])

    # the key frames of each sample by channel, and each sample's
    # annotations in table order (the devkit's reverse index)
    by_sample = {}
    for sd in sample_data.values():
        if not sd["is_key_frame"]:
            continue
        cs = calib_sensors[sd["calibrated_sensor_token"]]
        channel = sensors[cs["sensor_token"]]["channel"]
        by_sample.setdefault(sd["sample_token"], {})[channel] = sd
    anns_of = {}
    for a in annotations.values():
        anns_of.setdefault(a["sample_token"], []).append(a["token"])

    infos = []
    for stoken, sample in samples.items():
        chans = by_sample.get(stoken, {})
        if "LIDAR_TOP" not in chans:
            continue
        lidar_sd = chans["LIDAR_TOP"]
        l2g = sd_to_global(lidar_sd)
        g2l = np.linalg.inv(l2g)

        sweeps = []
        cur = lidar_sd
        while len(sweeps) < max_sweeps and cur["prev"]:
            cur = sample_data[cur["prev"]]
            sweeps.append({
                "lidar_path": cur["filename"],
                "transform_matrix": (g2l @ sd_to_global(cur)).astype(
                    np.float32),
                "time_lag": (lidar_sd["timestamp"] - cur["timestamp"]) / 1e6,
            })

        cams = {}
        for ch in NUSC_CAMERAS:
            if ch not in chans:
                continue
            cam_sd = chans[ch]
            cs = calib_sensors[cam_sd["calibrated_sensor_token"]]
            lidar2cam = (np.linalg.inv(sd_to_global(cam_sd)) @ l2g).astype(
                np.float32)
            intrinsic = np.asarray(cs["camera_intrinsic"], np.float32)
            cams[ch] = {
                "data_path": cam_sd["filename"],
                "lidar2cam": lidar2cam,
                "cam_intrinsic": intrinsic,
                "camera_intrinsics": intrinsic,
                "lidar2img": np.vstack(
                    [intrinsic @ lidar2cam[:3], lidar2cam[3]]).astype(
                        np.float32),
            }

        boxes, names, velocities = [], [], []
        for atoken in anns_of.get(stoken, []):
            a = annotations[atoken]
            cat = categories[instances[a["instance_token"]]["category_token"]]
            # global -> lidar frame
            ctr = g2l[:3, :3] @ np.asarray(a["translation"]) + g2l[:3, 3]
            rot = g2l[:3, :3] @ _quat_to_rot(a["rotation"])
            yaw = np.arctan2(rot[1, 0], rot[0, 0])
            w, l, h = a["size"]
            boxes.append([*ctr, l, w, h, yaw])
            names.append(detection_name(cat["name"]))
            vel = _ann_velocity(annotations, samples, a)
            velocities.append((g2l[:3, :3] @ vel)[:2])

        infos.append({
            "token": stoken,
            "scene_name": scenes[sample["scene_token"]]["name"],
            "scene_token": sample["scene_token"],
            "lidar_path": lidar_sd["filename"],
            "timestamp": lidar_sd["timestamp"],
            "sweeps": sweeps,
            "cams": cams,
            "gt_boxes": np.asarray(boxes, np.float32).reshape(-1, 7),
            "gt_names": np.asarray(names),
            "gt_velocity": np.asarray(velocities, np.float32).reshape(-1, 2),
        })

    out = root / f"df3d_nusc_infos_{version}.pkl"
    with open(out, "wb") as f:
        pickle.dump({"infos": infos, "version": version}, f)
    print(f"wrote {len(infos)} nuScenes infos -> {out}")
    return infos


def _ann_velocity(annotations, samples, a, max_time_diff: float = 1.5):
    """The devkit's box_velocity: the central difference of the global
    positions of the instance's previous and next annotations over their
    samples' timestamps; zeros (where the devkit gives NaN) when there is
    neither or the gap exceeds 2 * max_time_diff."""
    has_prev, has_next = bool(a["prev"]), bool(a["next"])
    if not has_prev and not has_next:
        return np.zeros(3)
    first = annotations[a["prev"]] if has_prev else a
    last = annotations[a["next"]] if has_next else a
    pos_diff = (np.asarray(last["translation"])
                - np.asarray(first["translation"]))
    t_first = samples[first["sample_token"]]["timestamp"] / 1e6
    t_last = samples[last["sample_token"]]["timestamp"] / 1e6
    time_diff = t_last - t_first
    if time_diff <= 0 or time_diff > 2 * max_time_diff:
        return np.zeros(3)
    return pos_diff / time_diff


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m df3d_torch.tools.create_data")
    p.add_argument("dataset", choices=["kitti", "nuscenes"])
    p.add_argument("--root", required=True)
    p.add_argument("--split", default="train")
    p.add_argument("--version", default="v1.0-trainval")
    p.add_argument("--max-sweeps", type=int, default=10)
    p.add_argument("--with-gt-database", action="store_true")
    p.add_argument("--with-image-crops", action="store_true")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    root = pathlib.Path(args.root)
    if args.dataset == "nuscenes":
        return create_nuscenes_infos(root, args.version, args.max_sweeps)
    infos = create_kitti_infos(root, args.split)
    if args.with_gt_database:
        create_gt_database(root, args.split,
                           with_image_crops=args.with_image_crops)
    return infos


if __name__ == "__main__":
    main()
