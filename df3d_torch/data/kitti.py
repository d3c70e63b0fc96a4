"""KITTI: calib parsing, the info-pkl dataset and the box conversions
(port of df3d/data/kitti.py): the lidar <-> camera-rect chain of pcdet's
calibration_kitti.py, pcdet's kitti_dataset.py (info pkls, the camera-FOV
point crop, gt boxes, road planes, raw images) and the detections' KITTI
annotations and recall counts of pcdet's kitti_dataset.py and
detector3d_template.py. A calib dict holds P2 (3x4), R0 (3x3) and V2C
(3x4) as numpy arrays.
"""

from __future__ import annotations

import pathlib
import pickle

import numpy as np

from df3d_torch.data.kitti_eval import iou_3d_np


def parse_calib_file(path) -> dict:
    """KITTI calib txt -> dict of matrices (P2 3x4, R0 3x3, V2C 3x4)."""
    out = {}
    with open(path) as f:
        for line in f:
            if ":" not in line:
                continue
            k, v = line.split(":", 1)
            out[k.strip()] = np.fromstring(v, sep=" ", dtype=np.float32)
    return {
        "P2": out["P2"].reshape(3, 4),
        "R0": out.get("R0_rect", out.get(
            "R0", np.eye(3, dtype=np.float32).ravel())).reshape(3, 3),
        "V2C": out.get("Tr_velo_to_cam", out.get("Tr_velo2cam")).reshape(3, 4),
    }


def lidar_to_img_matrix(calib: dict) -> np.ndarray:
    """Compose lidar->image 3x4 (calibration_kitti.lidar_to_img chain)."""
    r0 = np.eye(4, dtype=np.float32)
    r0[:3, :3] = calib["R0"]
    v2c = np.eye(4, dtype=np.float32)
    v2c[:3, :4] = calib["V2C"]
    p2 = np.eye(4, dtype=np.float32)
    p2[:3, :4] = calib["P2"]
    return (p2 @ r0 @ v2c)[:3]


def rect_to_lidar(calib: dict, pts_rect: np.ndarray) -> np.ndarray:
    """Camera-rect frame -> lidar frame (inverse chain)."""
    r0 = np.eye(4, dtype=np.float32)
    r0[:3, :3] = calib["R0"]
    v2c = np.eye(4, dtype=np.float32)
    v2c[:3, :4] = calib["V2C"]
    inv = np.linalg.inv(r0 @ v2c)
    homo = np.concatenate([pts_rect, np.ones_like(pts_rect[:, :1])], axis=1)
    return (homo @ inv.T)[:, :3]


def camera_box_to_lidar(boxes_cam: np.ndarray, calib: dict) -> np.ndarray:
    """KITTI label (x,y,z in rect cam, l,h,w, ry) -> df3d lidar 7-dof
    (gravity-center z). Mirrors pcdet box_utils.boxes3d_kitti_camera_to_lidar."""
    xyz = rect_to_lidar(calib, boxes_cam[:, :3])
    l, h, w = boxes_cam[:, 3], boxes_cam[:, 4], boxes_cam[:, 5]
    ry = boxes_cam[:, 6]
    xyz[:, 2] += h / 2  # bottom -> gravity center
    heading = -(ry + np.pi / 2)
    return np.stack(
        [xyz[:, 0], xyz[:, 1], xyz[:, 2], l, w, h, heading], axis=1
    ).astype(np.float32)


def lidar_to_rect(calib: dict, pts_lidar: np.ndarray) -> np.ndarray:
    """Lidar frame -> camera-rect frame (calibration_kitti.lidar_to_rect)."""
    r0 = np.eye(4, dtype=np.float32)
    r0[:3, :3] = calib["R0"]
    v2c = np.eye(4, dtype=np.float32)
    v2c[:3, :4] = calib["V2C"]
    homo = np.concatenate(
        [pts_lidar, np.ones_like(pts_lidar[:, :1])], axis=1)
    return (homo @ (r0 @ v2c).T)[:, :3]


def lidar_boxes_to_kitti_annos(
    boxes_lidar: np.ndarray, scores: np.ndarray, labels: np.ndarray,
    calib: dict, image_shape, class_names,
) -> dict:
    """df3d lidar 7-dof detections -> a KITTI det-anno dict with camera-
    frame fields (pcdet kitti_dataset.generate_prediction_dicts:
    boxes3d_lidar_to_kitti_camera + boxes3d_kitti_camera_to_imageboxes):
    name/score/boxes_lidar for the 3d/bev metrics, bbox (projected corner
    hull clipped to the image) for the 2D metric, alpha for AOS.
    """
    boxes_lidar = np.asarray(boxes_lidar, np.float32).reshape(-1, 7)
    n = len(boxes_lidar)
    if n == 0:
        return {
            "name": np.zeros((0,), "<U32"), "score": np.zeros((0,)),
            "boxes_lidar": boxes_lidar, "bbox": np.zeros((0, 4)),
            "alpha": np.zeros((0,)),
        }
    xyz = boxes_lidar[:, :3].copy()
    dx, dy, dz = boxes_lidar[:, 3], boxes_lidar[:, 4], boxes_lidar[:, 5]
    heading = boxes_lidar[:, 6]
    xyz[:, 2] -= dz / 2  # gravity center -> bottom (camera convention)
    xyz_cam = lidar_to_rect(calib, xyz)
    ry = -heading - np.pi / 2
    alpha = -np.arctan2(-boxes_lidar[:, 1], boxes_lidar[:, 0]) + ry

    # project the 8 box corners for the 2D bbox
    h, w = float(image_shape[0]), float(image_shape[1])
    cs, sn = np.cos(heading), np.sin(heading)
    bbox = np.zeros((n, 4), np.float32)
    proj = lidar_to_img_matrix(calib)
    corners = []
    for sx in (-0.5, 0.5):
        for sy in (-0.5, 0.5):
            for sz in (-0.5, 0.5):
                cx = boxes_lidar[:, 0] + sx * dx * cs - sy * dy * sn
                cy = boxes_lidar[:, 1] + sx * dx * sn + sy * dy * cs
                cz = boxes_lidar[:, 2] + sz * dz
                corners.append(np.stack([cx, cy, cz], axis=1))
    corners = np.stack(corners, axis=1)  # (n, 8, 3)
    homo = np.concatenate(
        [corners, np.ones_like(corners[..., :1])], axis=-1)
    uvw = homo @ proj.T
    depth = np.maximum(uvw[..., 2], 1e-4)
    u = uvw[..., 0] / depth
    v = uvw[..., 1] / depth
    bbox[:, 0] = np.clip(u.min(1), 0, w - 1)
    bbox[:, 1] = np.clip(v.min(1), 0, h - 1)
    bbox[:, 2] = np.clip(u.max(1), 0, w - 1)
    bbox[:, 3] = np.clip(v.max(1), 0, h - 1)

    names = np.asarray(class_names)[np.asarray(labels, np.int32)]
    return {
        "name": names, "score": np.asarray(scores, np.float32),
        "boxes_lidar": boxes_lidar, "bbox": bbox, "alpha": alpha,
    }


def recall_counts(det_boxes: np.ndarray, gt_boxes: np.ndarray,
                  thresholds=(0.3, 0.5, 0.7)) -> dict:
    """Per-frame proposal/detection recall counts vs gt 3D IoU (pcdet
    detector3d_template.generate_recall_record :287). Returns
    {'gt': n_gt, 'recall_<t>': hits} to be summed over frames."""
    out = {"gt": len(gt_boxes)}
    if not len(gt_boxes) or not len(det_boxes):
        for t in thresholds:
            out[f"recall_{t}"] = 0
        return out
    iou = iou_3d_np(
        np.asarray(det_boxes, np.float32)[:, :7],
        np.asarray(gt_boxes, np.float32)[:, :7],
    )
    best = iou.max(0)
    for t in thresholds:
        out[f"recall_{t}"] = int((best > t).sum())
    return out


class KittiDataset:
    """Info-pkl driven dataset (pcdet-format kitti_infos_*.pkl).

    `use_cpp_loader` is taken literally: True reads the .bin files and
    crops the camera FOV with the C++ loader (`data.native`), built at
    first use, and raises if it cannot be built or loaded; False reads and
    crops with numpy. (The JAX package quietly falls back to numpy when its
    library fails to load.) The two branches need not agree on points at
    the image border."""

    CLASSES = ("Car", "Pedestrian", "Cyclist")

    def __init__(self, root, info_path, class_names=("Car",), training=True,
                 use_cpp_loader: bool = True, load_images: bool = False,
                 image_shape: tuple[int, int] = (384, 1280),
                 split: str | None = None):
        self.root = pathlib.Path(root)
        # pcdet root_split_path: train/val infos live under training/, the
        # test split under testing/ (kitti_dataset.py set_split), inferred
        # from the info file's name unless given
        if split is None:
            split = ("testing" if "test" in pathlib.Path(info_path).name
                     else "training")
        self.split_dir = split
        with open(info_path, "rb") as f:
            self.infos = pickle.load(f)
        self.class_names = class_names
        self.training = training
        self.load_images = load_images
        self.image_shape = tuple(image_shape)
        self._cpp = None
        if use_cpp_loader:
            from df3d_torch.data.native import NativeLoader

            self._cpp = NativeLoader()

    def __len__(self):
        return len(self.infos)

    def _fov_crop(self, points, proj, image_shape):
        h, w = int(image_shape[0]), int(image_shape[1])
        if self._cpp is not None:
            keep = self._cpp.fov_mask(points, proj, h, w)
        else:
            homo = np.concatenate(
                [points[:, :3], np.ones_like(points[:, :1])], axis=1)
            uvw = homo @ proj.T
            depth = uvw[:, 2]
            u = uvw[:, 0] / np.maximum(depth, 1e-6)
            v = uvw[:, 1] / np.maximum(depth, 1e-6)
            keep = (depth > 0.1) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
        return points[keep]

    def load_road_plane(self, idx: str):
        """planes/<idx>.txt -> normalized (4,) [a, b, c, d] in the rect
        camera frame, normal facing up, or None if absent (pcdet
        kitti_dataset.py get_road_plane)."""
        path = self.root / self.split_dir / "planes" / f"{idx}.txt"
        if not path.exists():
            return None
        lines = path.read_text().splitlines()
        plane = np.asarray([float(v) for v in lines[3].split()], np.float32)
        if plane[1] > 0:  # normal must face up (rect cam: -y is up)
            plane = -plane
        return plane / np.linalg.norm(plane[0:3])

    def load_points(self, idx: str) -> np.ndarray:
        path = self.root / self.split_dir / "velodyne" / f"{idx}.bin"
        if self._cpp is not None:
            return self._cpp.read_point_bin(str(path), 4)
        return np.fromfile(path, dtype=np.float32).reshape(-1, 4)

    def __getitem__(self, index: int) -> dict:
        info = self.infos[index]
        sample_idx = info["point_cloud"]["lidar_idx"]
        points = self.load_points(sample_idx)
        calib = {
            "P2": info["calib"]["P2"][:3, :4].astype(np.float32),
            "R0": info["calib"]["R0_rect"][:3, :3].astype(np.float32),
            "V2C": info["calib"]["Tr_velo_to_cam"][:3, :4].astype(np.float32),
        }
        proj = lidar_to_img_matrix(calib)
        image_shape = np.asarray(
            info.get("image", {}).get("image_shape", np.array([375, 1242])))
        if self.training:  # pcdet FOV_POINTS_ONLY: camera-frustum crop
            points = self._fov_crop(points, proj, image_shape)
        out = {"sample_idx": sample_idx, "points": points, "proj": proj,
               "calib": calib, "image_shape": image_shape}
        if self.training:
            # the frame's road plane for gt sampling (optional planes/)
            plane = self.load_road_plane(sample_idx)
            if plane is not None:
                out["road_plane"] = plane
        if self.load_images:
            # pcdet get_image: the raw uint8 image at its own resolution
            # with the projection at that resolution, so the gt image paste
            # composites before any resize; `images.finalize_camera_sample`
            # makes the model's tensors at collate time
            from df3d_torch.data.images import decode_image

            out["image"] = decode_image(
                self.root / self.split_dir / "image_2" / f"{sample_idx}.png")
        if "annos" in info:
            annos = info["annos"]
            out["annos_raw"] = annos  # every anno (DontCare too), for eval
            mask = np.array([n != "DontCare" for n in annos["name"]])
            names = annos["name"][mask]
            if "gt_boxes_lidar" in annos:
                boxes = annos["gt_boxes_lidar"][mask][:, :7].astype(np.float32)
            else:
                cam = np.concatenate(
                    [annos["location"], annos["dimensions"],
                     annos["rotation_y"][..., None]], axis=1)[mask]
                boxes = camera_box_to_lidar(cam, calib)
            keep = np.isin(names, self.class_names)
            out["gt_boxes"] = boxes[keep]
            out["gt_names"] = names[keep]
            out["gt_classes"] = np.array(
                [self.class_names.index(n) for n in names[keep]], np.int32)
            if "bbox" in annos:  # 2D label boxes (image-crop gt database)
                out["gt_bbox2d"] = annos["bbox"][mask][keep].astype(np.float32)
        return out
