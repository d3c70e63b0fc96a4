"""KITTI box conversions for the evaluation (port of df3d/data/kitti.py:
32-160): the lidar <-> camera-rect chain of pcdet's calibration_kitti.py
and the detections' KITTI annotations and recall counts of pcdet's
kitti_dataset.py and detector3d_template.py. A calib dict holds P2 (3x4),
R0 (3x3) and V2C (3x4) as numpy arrays.
"""

from __future__ import annotations

import numpy as np

from df3d_torch.data.kitti_eval import iou_3d_np


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
