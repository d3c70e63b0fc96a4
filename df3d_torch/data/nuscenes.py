"""nuScenes: info pkls with multi-sweep LiDAR and six cameras (port of
df3d/data/nuscenes.py).

The counterparts of det3d's 10-sweep accumulation (pipelines/loading.py)
and mmdet3d's nuscenes_dataset.py and CBGSDataset. Every pose and
calibration product is precomputed into the infos.
"""

from __future__ import annotations

import pathlib
import pickle

import numpy as np

from df3d_torch.data.nuscenes_eval import NUSC_CLASSES  # noqa: F401


def accumulate_sweeps(info, root, nsweeps: int = 10,
                      max_points: int | None = None,
                      rng: np.random.RandomState | None = None) -> np.ndarray:
    """The key frame's cloud and its (nsweeps - 1) past sweeps moved into
    the key frame, with a time-lag channel -> (N, 5) x, y, z, i, dt. With
    `max_points`, a larger cloud is cut to a random subset of that size,
    drawn from `rng` (required then)."""
    root = pathlib.Path(root)
    main = np.fromfile(str(root / info["lidar_path"]), dtype=np.float32)
    main = main.reshape(-1, 5)[:, :4]
    clouds = [np.concatenate([main, np.zeros_like(main[:, :1])], axis=1)]
    for sweep in info.get("sweeps", [])[: nsweeps - 1]:
        pts = np.fromfile(str(root / sweep["lidar_path"]), dtype=np.float32)
        pts = pts.reshape(-1, 5)[:, :4]
        tm = sweep["transform_matrix"].astype(np.float32)  # sweep -> key
        xyz1 = np.concatenate([pts[:, :3], np.ones_like(pts[:, :1])], axis=1)
        pts[:, :3] = (xyz1 @ tm.T)[:, :3]
        dt = np.full_like(pts[:, :1], sweep.get("time_lag", 0.0))
        clouds.append(np.concatenate([pts, dt], axis=1))
    out = np.concatenate(clouds)
    if max_points is not None and len(out) > max_points:
        if rng is None:
            raise ValueError("accumulate_sweeps: max_points needs an rng")
        out = out[rng.permutation(len(out))[:max_points]]
    return out


class NuScenesDataset:
    """Info-pkl driven dataset (det3d-format infos_*_10sweeps_withvelo)."""

    def __init__(self, root, info_path, class_names=NUSC_CLASSES,
                 nsweeps: int = 10, load_images: bool = False,
                 image_shape: tuple[int, int] = (448, 800)):
        self.root = pathlib.Path(root)
        with open(info_path, "rb") as f:
            data = pickle.load(f)
        self.infos = data["infos"] if isinstance(data, dict) else data
        self.class_names = tuple(class_names)
        self.nsweeps = nsweeps
        self.load_images = load_images
        self.image_shape = tuple(image_shape)

    def __len__(self):
        return len(self.infos)

    def __getitem__(self, index: int) -> dict:
        info = self.infos[index]
        points = accumulate_sweeps(info, self.root, self.nsweeps)
        out = {"token": info.get("token"), "points": points}

        if "gt_boxes" in info:
            boxes = np.asarray(info["gt_boxes"], np.float32)  # (M, 7 or 9)
            names = np.asarray(info["gt_names"])
            keep = np.isin(names, self.class_names)
            if boxes.shape[1] == 7:
                vel = np.asarray(info.get("gt_velocity",
                                          np.zeros((len(boxes), 2))))
                boxes = np.concatenate([boxes, np.nan_to_num(vel)], axis=1)
            out["gt_boxes"] = boxes[keep].astype(np.float32)
            out["gt_classes"] = np.array(
                [self.class_names.index(n) for n in names[keep]], np.int32)

        if self.load_images and "cams" in info:
            from df3d_torch.data.images import load_camera_frame

            projs, paths = [], []
            for cam in sorted(info["cams"].keys()):
                c = info["cams"][cam]
                # lidar -> camera -> image, the 4x4 precomputed in the infos
                l2c = np.asarray(c.get("lidar2cam", c.get("lidar2cam_matrix")),
                                 np.float32)
                intr = np.eye(4, dtype=np.float32)
                intr[:3, :3] = np.asarray(c["camera_intrinsics"], np.float32)
                projs.append((intr @ l2c)[:3])
                paths.append(str(self.root / c["data_path"]))
            out["cam_projs"] = np.stack(projs)  # (n_cam, 3, 4)
            out["cam_paths"] = paths
            out["images"], out["proj"] = load_camera_frame(
                paths, out["cam_projs"], self.image_shape)
        return out


class CBGSWrapper:
    """Class-balanced resampling (mmdet3d CBGSDataset): sample indices
    duplicated so that each class appears about equally often.

    The duplicate set is redrawn by `resample(seed)` (`PrefetchLoader`
    calls it with the epoch), reproducibly; the per-class counts, and so
    the length, do not depend on the seed."""

    def __init__(self, dataset, seed: int = 0):
        self.dataset = dataset
        ncls = len(dataset.class_names)
        cls_to_samples = [[] for _ in range(ncls)]
        for i in range(len(dataset)):
            info = dataset.infos[i]
            for c in set(np.asarray(info.get("gt_names", [])).tolist()):
                if c in dataset.class_names:
                    cls_to_samples[dataset.class_names.index(c)].append(i)
        total = sum(len(s) for s in cls_to_samples)
        frac = 1.0 / ncls
        # (the class's sample indices, draws), the count truncated by int()
        # as the reference does
        self._groups = [(s, int(frac / (len(s) / total) * len(s)))
                        for s in cls_to_samples if s]
        self.resample(seed)

    def resample(self, seed: int) -> None:
        rng = np.random.RandomState(seed)
        self.indices = []
        for s, reps in self._groups:
            self.indices.extend(rng.choice(s, reps).tolist())
        if not self.indices:
            self.indices = list(range(len(self.dataset)))

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.dataset[self.indices[i]]
