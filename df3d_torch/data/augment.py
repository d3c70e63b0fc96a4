"""Data augmentation on the host, in numpy (port of df3d/data/augment.py).

The counterparts of the reference's augmentors: world flip, rotation,
scaling and translation, with the drawn values recorded (`WorldAugParams`)
so that the camera projection can undo them on the device (pcdet
augmentor_utils.py, det3d preprocess.py); GT-database sampling with BEV
collision filtering and the road-plane lift (pcdet database_sampler.py);
and its image paste, sampled objects' stored crops composited into the
camera image far to near (IMG_AUG_TYPE by_depth).

Every draw comes from the caller's `np.random.RandomState`, in the JAX
package's order, and the flips edit the arrays they are given in place,
as the JAX package's do.
"""

from __future__ import annotations

import dataclasses
import pathlib

import numpy as np

from df3d_torch.data.kitti import lidar_to_rect, rect_to_lidar


def _rot_z(points, angle):
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s], [s, c]], points.dtype)
    out = points.copy()
    out[:, :2] = points[:, :2] @ rot.T
    return out


@dataclasses.dataclass
class WorldAugParams:
    """Applied augs recorded for on-device inversion (calib projection)."""

    flip_x: bool = False       # flip along x axis (y := -y)
    flip_y: bool = False       # flip along y axis (x := -x)
    noise_rot: float = 0.0
    noise_scale: float = 1.0
    noise_translate: np.ndarray | None = None


def random_world_flip(points, boxes, rng, axes=("x",)):
    p = WorldAugParams()
    if "x" in axes and rng.rand() < 0.5:
        p.flip_x = True
        points[:, 1] = -points[:, 1]
        if boxes is not None:
            boxes[:, 1] = -boxes[:, 1]
            boxes[:, 6] = -boxes[:, 6]
            if boxes.shape[1] > 8:
                boxes[:, 8] = -boxes[:, 8]  # vy
    if "y" in axes and rng.rand() < 0.5:
        p.flip_y = True
        points[:, 0] = -points[:, 0]
        if boxes is not None:
            boxes[:, 0] = -boxes[:, 0]
            boxes[:, 6] = -(boxes[:, 6] + np.pi)
            if boxes.shape[1] > 7:
                boxes[:, 7] = -boxes[:, 7]  # vx
    return points, boxes, p


def random_world_rotation(points, boxes, rng, rot_range=(-0.785, 0.785)):
    angle = rng.uniform(*rot_range)
    points[:, :3] = _rot_z3(points[:, :3], angle)
    if boxes is not None:
        boxes[:, :3] = _rot_z3(boxes[:, :3], angle)
        boxes[:, 6] += angle
        if boxes.shape[1] > 8:
            boxes[:, 7:9] = _rot_z(boxes[:, 7:9], angle)
    return points, boxes, angle


def _rot_z3(xyz, angle):
    c, s = np.cos(angle), np.sin(angle)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], xyz.dtype)
    return xyz @ rot.T


def random_world_scaling(points, boxes, rng, scale_range=(0.95, 1.05)):
    scale = rng.uniform(*scale_range)
    points[:, :3] *= scale
    if boxes is not None:
        boxes[:, :6] *= scale
        if boxes.shape[1] > 8:
            boxes[:, 7:9] *= scale
    return points, boxes, scale


def random_world_translation(points, boxes, rng, std=0.5):
    t = rng.normal(0, std, 3).astype(points.dtype)
    points[:, :3] += t
    if boxes is not None:
        boxes[:, :3] += t
    return points, boxes, t


def apply_world_augs(points, boxes, rng, cfg) -> tuple:
    """cfg: dict(flip_axes, rot_range, scale_range, translate_std)."""
    params = WorldAugParams()
    if cfg.get("flip_axes"):
        points, boxes, p = random_world_flip(points, boxes, rng, cfg["flip_axes"])
        params.flip_x, params.flip_y = p.flip_x, p.flip_y
    if cfg.get("rot_range"):
        points, boxes, params.noise_rot = random_world_rotation(
            points, boxes, rng, cfg["rot_range"]
        )
    if cfg.get("scale_range"):
        points, boxes, params.noise_scale = random_world_scaling(
            points, boxes, rng, cfg["scale_range"]
        )
    if cfg.get("translate_std"):
        points, boxes, params.noise_translate = random_world_translation(
            points, boxes, rng, cfg["translate_std"]
        )
    return points, boxes, params


# ---------------------------------------------------------------------------
# GT-database sampling


def _boxes_bev_corners_np(boxes):
    signs = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float32)
    local = 0.5 * signs[None] * boxes[:, None, 3:5]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    x = local[..., 0] * c[:, None] - local[..., 1] * s[:, None]
    y = local[..., 0] * s[:, None] + local[..., 1] * c[:, None]
    return np.stack([x, y], -1) + boxes[:, None, :2]


def bev_overlap_exists(boxes_a, boxes_b) -> np.ndarray:
    """Conservative separating-axis BEV collision test (A vs B) -> (A,) bool
    any-overlap. Used for gt-sampling collision filtering."""
    if len(boxes_b) == 0 or len(boxes_a) == 0:
        return np.zeros(len(boxes_a), bool)
    ca = _boxes_bev_corners_np(boxes_a)
    cb = _boxes_bev_corners_np(boxes_b)

    def sat_overlap(c1, c2):
        for poly in (c1, c2):
            for i in range(4):
                edge = poly[(i + 1) % 4] - poly[i]
                axis = np.array([-edge[1], edge[0]])
                p1 = c1 @ axis
                p2 = c2 @ axis
                if p1.max() < p2.min() or p2.max() < p1.min():
                    return False
        return True

    out = np.zeros(len(boxes_a), bool)
    for i in range(len(boxes_a)):
        for j in range(len(boxes_b)):
            if sat_overlap(ca[i], cb[j]):
                out[i] = True
                break
    return out


def put_boxes_on_road_plane(boxes: np.ndarray, plane, calib: dict):
    """Lift sampled boxes onto the per-frame road plane (pcdet
    database_sampler.py:147-166 put_boxes_on_road_planes, used by the
    KITTI configs with USE_ROAD_PLANE).

    boxes (N, 7+) lidar (gravity-center z); plane (4,) [a, b, c, d] in the
    rectified CAMERA frame (KITTI planes/*.txt convention, ax+by+cz+d=0);
    calib dict with R0/V2C. Returns (adjusted boxes, mv_height (N,)) —
    subtract mv_height from each box's db points' z too.
    """
    a, b, c, d = (float(v) for v in plane)
    center_cam = lidar_to_rect(calib, boxes[:, 0:3].astype(np.float32))
    cur_height_cam = (-d - a * center_cam[:, 0] - c * center_cam[:, 2]) / b
    center_cam = center_cam.copy()
    center_cam[:, 1] = cur_height_cam
    cur_lidar_height = rect_to_lidar(calib, center_cam)[:, 2]
    mv_height = boxes[:, 2] - boxes[:, 5] / 2 - cur_lidar_height
    out = boxes.copy()
    out[:, 2] -= mv_height
    return out, mv_height


class GTSampler:
    """GT-database ('copy-paste') augmentation.

    db_infos: {class_name: [ {'path': npy/bin points (local frame),
                              'box3d_lidar': (7 or 9,), 'num_points': int}]}
    sample_groups: {class_name: target_count}
    Mirrors pcdet DataBaseSampler semantics: sample to reach target counts,
    reject samples whose boxes collide (BEV) with existing or already-placed
    boxes. With use_road_plane (pcdet USE_ROAD_PLANE), sampled boxes and
    their points are lifted onto the frame's road plane when the call
    provides one (the reference skips it for the camera-aware path —
    database_sampler.py:246 `and not self.aug_with_img` — so image-paste
    callers simply don't pass a plane).
    """

    def __init__(self, db_infos: dict, sample_groups: dict,
                 min_points: int = 5, root: str | None = None,
                 use_road_plane: bool = False):
        self.db = {
            k: [i for i in v if i.get("num_points", min_points) >= min_points]
            for k, v in db_infos.items()
        }
        self.groups = sample_groups
        self.root = root
        self.use_road_plane = use_road_plane

    def _load_points(self, info):
        p = info["path"]
        if self.root is not None:
            p = str(pathlib.Path(self.root) / p)
        if str(p).endswith(".npy"):
            return np.load(p)
        pts = np.fromfile(p, dtype=np.float32)
        return pts.reshape(-1, info.get("num_features", 4))

    def __call__(self, points, gt_boxes, gt_names, rng,
                 road_plane=None, calib=None):
        """-> (points, gt_boxes, gt_names, sampled_infos) where
        sampled_infos are the db entries of the objects actually placed
        (ordered like the appended boxes) — the image-paste branch reads
        stored crops from them. road_plane + calib (both required) enable
        the road-plane lift when use_road_plane is set."""
        placed_boxes = [] if gt_boxes is None else [gt_boxes]
        new_points, new_boxes, new_names, new_infos = [], [], [], []
        for cls, target in self.groups.items():
            pool = self.db.get(cls, [])
            if not pool:
                continue
            have = int((gt_names == cls).sum()) if gt_names is not None else 0
            need = max(target - have, 0)
            if need == 0:
                continue
            picks = rng.choice(len(pool), min(need, len(pool)), replace=False)
            cand_boxes = np.stack(
                [np.asarray(pool[i]["box3d_lidar"], np.float32) for i in picks]
            )
            existing = (
                np.concatenate(placed_boxes) if placed_boxes else
                np.zeros((0, cand_boxes.shape[1]), np.float32)
            )
            collide = bev_overlap_exists(cand_boxes[:, :7], existing[:, :7])
            # also self-collisions among candidates, greedy keep
            keep = []
            for i in range(len(cand_boxes)):
                if collide[i]:
                    continue
                if keep and bev_overlap_exists(
                    cand_boxes[i:i+1, :7], cand_boxes[keep][:, :7]
                )[0]:
                    continue
                keep.append(i)
            for i in keep:
                info = pool[picks[i]]
                obj = self._load_points(info).copy()
                b = cand_boxes[i]
                obj[:, :3] += b[:3]  # db points are box-local
                new_points.append(obj)
                new_boxes.append(b)
                new_names.append(cls)
                new_infos.append(info)
            if keep:
                placed_boxes.append(cand_boxes[keep])

        if not new_boxes:
            return points, gt_boxes, gt_names, []
        add_boxes = np.stack(new_boxes)
        if (self.use_road_plane and road_plane is not None
                and calib is not None):
            add_boxes, mv_height = put_boxes_on_road_plane(
                add_boxes, road_plane, calib)
            for i, obj in enumerate(new_points):
                obj[:, 2] -= mv_height[i]
        # remove scene points inside pasted boxes (pcdet remove_points_in_boxes3d)
        points = _remove_points_in_boxes(points, add_boxes[:, :7])
        points = np.concatenate([points] + new_points)
        gt_boxes = (
            add_boxes if gt_boxes is None else np.concatenate([gt_boxes, add_boxes])
        )
        gt_names = (
            np.asarray(new_names)
            if gt_names is None
            else np.concatenate([gt_names, np.asarray(new_names)])
        )
        return points, gt_boxes, gt_names, new_infos

    def load_crop(self, info):
        """Stored image crop of a db object, or None if the database was
        built without camera data (create_data --with-image-crops)."""
        if "image_crop" in info:
            return np.asarray(info["image_crop"])
        if "image_crop_path" in info:
            p = info["image_crop_path"]
            if self.root is not None:
                p = str(pathlib.Path(self.root) / p)
            return np.load(p)
        return None


def paste_objects_to_image(image, crops, boxes2d, depths):
    """Depth-ordered image compositing for camera-aware gt-sampling
    (pcdet database_sampler.py:166-230 copy_paste_to_image, IMG_AUG_TYPE
    'by_depth'): paste sampled objects' image crops far-to-near so closer
    objects occlude farther ones.

    image (H, W, 3) uint8/float; crops: list of (h_i, w_i, 3); boxes2d
    (M, 4) xyxy pixel coords; depths (M,). Returns the composited image.
    """
    img = image.copy()
    h, w = img.shape[:2]
    order = np.argsort(-np.asarray(depths))  # far first
    for i in order:
        x1, y1, x2, y2 = [int(round(v)) for v in boxes2d[i]]
        x1c, y1c = max(x1, 0), max(y1, 0)
        x2c, y2c = min(x2, w), min(y2, h)
        if x2c <= x1c or y2c <= y1c:
            continue
        crop = crops[i]
        ch, cw = y2 - y1, x2 - x1
        if crop.shape[0] != ch or crop.shape[1] != cw:
            # nearest resize to the target bbox
            ys = (np.arange(ch) * crop.shape[0] / max(ch, 1)).astype(int)
            xs = (np.arange(cw) * crop.shape[1] / max(cw, 1)).astype(int)
            crop = crop[np.clip(ys, 0, crop.shape[0] - 1)][
                :, np.clip(xs, 0, crop.shape[1] - 1)
            ]
        img[y1c:y2c, x1c:x2c] = crop[y1c - y1:y2c - y1, x1c - x1:x2c - x1]
    return img


def project_box_to_image_bbox(box, proj, image_hw):
    """3D box -> clipped 2D bbox via corner projection (for gt-paste)."""
    signs = np.array(
        [[1, 1, -1], [1, -1, -1], [-1, -1, -1], [-1, 1, -1],
         [1, 1, 1], [1, -1, 1], [-1, -1, 1], [-1, 1, 1]], np.float32,
    )
    corners = 0.5 * box[3:6] * signs
    c, s = np.cos(box[6]), np.sin(box[6])
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    corners = corners @ rot.T + box[:3]
    homo = np.concatenate([corners, np.ones((8, 1), np.float32)], 1)
    uvw = homo @ np.asarray(proj, np.float32).T
    uv = uvw[:, :2] / np.maximum(uvw[:, 2:3], 1e-6)
    h, w = image_hw
    x1, y1 = uv.min(0)
    x2, y2 = uv.max(0)
    return np.array(
        [max(x1, 0), max(y1, 0), min(x2, w), min(y2, h)], np.float32
    ), float(uvw[:, 2].mean())


def _remove_points_in_boxes(points, boxes):
    if len(boxes) == 0 or len(points) == 0:
        return points
    keep = np.ones(len(points), bool)
    for b in boxes:
        rel = points[:, :2] - b[:2]
        c, s = np.cos(-b[6]), np.sin(-b[6])
        lx = rel[:, 0] * c - rel[:, 1] * s
        ly = rel[:, 0] * s + rel[:, 1] * c
        inside = (
            (np.abs(lx) <= b[3] / 2) & (np.abs(ly) <= b[4] / 2)
            & (np.abs(points[:, 2] - b[2]) <= b[5] / 2)
        )
        keep &= ~inside
    return points[keep]
