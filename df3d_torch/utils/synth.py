"""Synthetic lidar frames (numpy), a copy of the ray-cast generator of
df3d/utils/synth.py so the port needs nothing of the JAX package.

``make_raycast_frame`` simulates a 32-beam spinning lidar over a scene of
ground + oriented boxes (cars/trucks/pedestrians, some moving) + building
facades + poles, accumulated over 10 sweeps with ego motion: the
acquisition geometry of a nuScenes key frame. Points lie on surfaces sampled
by ray geometry, so sparse-conv occupancy dilates like a real scan. The same
seed gives the same frame as the JAX package's generator.

``camera_rig`` is test data of the port's own: a nuScenes-like ring of six
pinhole cameras around the lidar.

``make_kitti_frame`` and ``kitti_camera`` are the port's own too: one sweep
of a 64-beam lidar over the same kind of scene, cut to the front camera's
field of view as pcdet's KITTI pipeline cuts it (FOV_POINTS_ONLY), and that
camera's lidar -> image projection with KITTI's published P2 intrinsics.
"""

from __future__ import annotations

import numpy as np

_GROUND_Z = -1.8
_N_CARS = 52  # the scene's first boxes


def _scene(rng: np.random.RandomState):
    """Random urban-ish scene: oriented boxes, facades, poles."""
    # cars / trucks / pedestrians (oriented boxes); ~1/3 of cars move
    n_car, n_trk, n_ped = _N_CARS, 9, 18
    n = n_car + n_trk + n_ped
    r = 6.0 + 48.0 * rng.rand(n) ** 1.35
    th = rng.rand(n) * 2 * np.pi
    cx, cy = r * np.cos(th), r * np.sin(th)
    yaw = rng.rand(n) * 2 * np.pi
    dims = np.concatenate([
        np.array([[4.6, 1.9, 1.7]]) * (1 + 0.1 * rng.randn(n_car, 3)),
        np.array([[8.5, 2.6, 3.2]]) * (1 + 0.1 * rng.randn(n_trk, 3)),
        np.array([[0.7, 0.7, 1.7]]) * (1 + 0.1 * rng.randn(n_ped, 3)),
    ])
    cz = _GROUND_Z + dims[:, 2] / 2
    vel = np.zeros((n, 2))
    moving = rng.rand(n) < 0.3
    speed = rng.uniform(2.0, 11.0, n) * moving
    vel[:, 0] = speed * np.cos(yaw)
    vel[:, 1] = speed * np.sin(yaw)
    boxes = dict(c=np.stack([cx, cy, cz], -1), dims=dims, yaw=yaw, vel=vel)

    # building facades: long thin tall boxes at larger radii
    nf = 14
    rf = rng.uniform(22, 52, nf)
    tf = rng.rand(nf) * 2 * np.pi
    fyaw = tf + np.pi / 2 + 0.15 * rng.randn(nf)  # roughly tangential
    fdims = np.stack([rng.uniform(12, 35, nf), np.full(nf, 0.4),
                      rng.uniform(6, 14, nf)], -1)
    fc = np.stack([rf * np.cos(tf), rf * np.sin(tf),
                   _GROUND_Z + fdims[:, 2] / 2], -1)
    facades = dict(c=fc, dims=fdims, yaw=fyaw, vel=np.zeros((nf, 2)))

    # poles / trunks: thin vertical boxes
    npl = 36
    rp = 4.0 + 49.0 * rng.rand(npl) ** 1.2
    tp = rng.rand(npl) * 2 * np.pi
    pdims = np.stack([rng.uniform(0.15, 0.8, npl),
                      rng.uniform(0.15, 0.8, npl),
                      rng.uniform(3.0, 9.0, npl)], -1)
    pc = np.stack([rp * np.cos(tp), rp * np.sin(tp),
                   _GROUND_Z + pdims[:, 2] / 2], -1)
    poles = dict(c=pc, dims=pdims, yaw=np.zeros(npl), vel=np.zeros((npl, 2)))

    c = np.concatenate([boxes["c"], facades["c"], poles["c"]])
    dims = np.concatenate([boxes["dims"], facades["dims"], poles["dims"]])
    yaw = np.concatenate([boxes["yaw"], facades["yaw"], poles["yaw"]])
    vel = np.concatenate([boxes["vel"], facades["vel"], poles["vel"]])
    return c, dims, yaw, vel


def _cast(origin: np.ndarray, dirs: np.ndarray, c, dims, yaw):
    """Min-t ray/box + ray/ground intersection. dirs (R,3) unit."""
    R = len(dirs)
    t_best = np.full(R, np.inf)
    # ground plane
    dz = dirs[:, 2]
    tg = np.where(dz < -1e-6, (_GROUND_Z - origin[2]) / np.minimum(dz, -1e-6),
                  np.inf)
    t_best = np.minimum(t_best, np.where(tg > 0, tg, np.inf))
    # oriented boxes: slab test in box frame, batched (R, B)
    cos, sin = np.cos(yaw), np.sin(yaw)
    rel = c - origin  # (B, 3)
    # ray dir / box-center offset in each box frame (rotate by -yaw:
    # [cos, sin; -sin, cos])
    dx = dirs[:, None, 0] * cos + dirs[:, None, 1] * sin
    dy = -dirs[:, None, 0] * sin + dirs[:, None, 1] * cos
    ox = np.broadcast_to(-(rel[None, :, 0] * cos + rel[None, :, 1] * sin),
                         dx.shape)
    oy = np.broadcast_to(-(-rel[None, :, 0] * sin + rel[None, :, 1] * cos),
                         dx.shape)
    oz = np.broadcast_to(origin[2] - c[None, :, 2], dx.shape)
    dzb = np.broadcast_to(dirs[:, 2][:, None], dx.shape)
    eps = 1e-9
    t_lo = np.full(dx.shape, -np.inf)
    t_hi = np.full(dx.shape, np.inf)
    for o_, d_, h_ in ((ox, dx, dims[:, 0] / 2), (oy, dy, dims[:, 1] / 2),
                       (oz, dzb, dims[:, 2] / 2)):
        d_safe = np.where(np.abs(d_) < eps, eps, d_)
        t1 = (-h_[None, :] - o_) / d_safe
        t2 = (h_[None, :] - o_) / d_safe
        lo, hi = np.minimum(t1, t2), np.maximum(t1, t2)
        # parallel ray outside the slab: no hit
        miss = (np.abs(d_) < eps) & (np.abs(o_) > h_[None, :])
        lo = np.where(miss, np.inf, lo)
        t_lo = np.maximum(t_lo, lo)
        t_hi = np.minimum(t_hi, hi)
    hit = (t_hi >= t_lo) & (t_hi > 0)
    t_box = np.where(hit, np.where(t_lo > 0, t_lo, np.inf), np.inf)
    t_best = np.minimum(t_best, t_box.min(axis=1))
    return t_best


def make_raycast_frame(rng: np.random.RandomState,
                       n_points: int = 260_000,
                       extra_features: int = 2,
                       n_sweeps: int = 10,
                       n_azimuth: int = 1400,
                       n_beams: int = 32,
                       max_range: float = 70.0) -> np.ndarray:
    """Ray-cast 10-sweep lidar frame -> (n_points, 3+extra) float32.

    Surface-sampled points with realistic radial density falloff, moving
    objects smeared across sweeps, ego motion, range noise, and dropout.
    At the CenterPoint 0.075 m operating point a frame lands ~95-120k
    unique stage-1 voxels with surface-like (sub-linear) down-stage
    dilation — see tools/fit_caps.py --synthetic.
    """
    c, dims, yaw, vel = _scene(rng)
    el = np.deg2rad(np.linspace(-30.0, 10.0, n_beams))
    pts = []
    ego_speed = rng.uniform(1.0, 9.0)  # m/s
    dt_sweep = 0.05
    for s in range(n_sweeps):
        t_back = s * dt_sweep  # sweep s is t_back seconds in the past
        ego = np.array([-ego_speed * t_back, 0.0, 0.0])
        az = (np.arange(n_azimuth) + rng.rand()) * (2 * np.pi / n_azimuth)
        azg, elg = np.meshgrid(az, el, indexing="ij")
        dirs = np.stack([np.cos(elg) * np.cos(azg),
                         np.cos(elg) * np.sin(azg),
                         np.sin(elg)], -1).reshape(-1, 3)
        # move dynamic objects back in time
        cs = c.copy()
        cs[:, :2] -= vel * t_back
        t = _cast(ego, dirs, cs, dims, yaw)
        keep = np.isfinite(t) & (t < max_range) & (t > 1.0)
        keep &= rng.rand(len(t)) > 0.06  # dropout
        p = ego + dirs[keep] * (t[keep, None] +
                                0.015 * rng.randn(keep.sum(), 1))
        dtf = np.full((len(p), 1), t_back, np.float32)
        pts.append(np.concatenate([p, dtf], -1))
    allp = np.concatenate(pts).astype(np.float32)
    # crop to range and resample to exactly n_points
    m = ((np.abs(allp[:, 0]) < 54) & (np.abs(allp[:, 1]) < 54)
         & (allp[:, 2] > -5) & (allp[:, 2] < 3))
    allp = allp[m]
    if len(allp) >= n_points:
        sel = rng.choice(len(allp), n_points, replace=False)
    else:
        sel = np.concatenate([np.arange(len(allp)),
                              rng.choice(len(allp), n_points - len(allp))])
    allp = allp[sel]
    out = np.empty((n_points, 3 + extra_features), np.float32)
    out[:, :3] = allp[:, :3]
    if extra_features >= 1:
        out[:, 3] = rng.rand(n_points)  # intensity
    if extra_features >= 2:
        out[:, 4] = allp[:, 3]  # sweep dt, like the real 5th feature
    if extra_features > 2:
        out[:, 5:] = rng.rand(n_points, extra_features - 2)
    return out


# nuScenes camera order (FRONT, FRONT_RIGHT, FRONT_LEFT, BACK, BACK_LEFT,
# BACK_RIGHT) and each camera's yaw from the lidar's x (forward) axis
NUSC_CAM_YAWS_DEG = (0.0, -55.0, 55.0, 180.0, 110.0, -110.0)


def camera_rig(num_cams: int = 6, image_shape=(448, 800)) -> np.ndarray:
    """(num_cams, 3, 4) float32 lidar -> image projections of a
    nuScenes-like rig: the first `num_cams` of the yaws above, each camera
    0.5 m out from the lidar along its axis and 0.3 m below it, its optical
    axis (camera z) horizontal along the yaw, image y pointing down, and
    the 1600x900 intrinsics (f ~ 1266 px) scaled to `image_shape` (f ~ 633,
    cx 400, cy 224 at 448x800)."""
    k = rig_intrinsics(image_shape)
    out = [k @ np.concatenate([rot, -rot @ center[:, None]], 1)
           for rot, center in rig_poses(num_cams)]
    return np.stack(out).astype(np.float32)


def rig_intrinsics(image_shape=(900, 1600)) -> np.ndarray:
    """(3, 3) float64 intrinsics of `camera_rig`'s cameras: the 1600x900
    ones (f ~ 1266 px, principal point at the centre) scaled to
    `image_shape`."""
    h, w = image_shape
    f = 1266.0 * w / 1600.0
    return np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]])


def rig_poses(num_cams: int = 6):
    """[(rotation (3, 3) lidar -> camera axes, camera centre (3,) in the
    lidar frame)] of `camera_rig`'s first `num_cams` cameras."""
    out = []
    for yaw in np.deg2rad(NUSC_CAM_YAWS_DEG[:num_cams]):
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        rot = np.stack([right, down, fwd])          # lidar -> camera axes
        out.append((rot, 0.5 * fwd + np.array([0.0, 0.0, -0.3])))
    return out


# KITTI's front colour camera (P2 of the raw recordings' calibration,
# 2011_09_26): focal length and principal point in pixels of the 375x1242
# image, and P2's fourth column (the camera's offset from the reference
# camera); the lidar sits 0.27 m behind it, 0.08 m above and 0.004 m left
KITTI_P2 = ((721.5377, 0.0, 609.5593, 44.85728),
            (0.0, 721.5377, 172.854, 0.2163791),
            (0.0, 0.0, 1.0, 0.002745884))
KITTI_VELO_TO_CAM_T = (-0.004069766, -0.07631618, -0.2717806)
KITTI_IMAGE = (375, 1242)


def kitti_camera(scale: float = 1.0) -> np.ndarray:
    """(3, 4) float32 lidar -> image projection of KITTI's front camera:
    lidar axes (x forward, y left, z up) to camera axes (right, down,
    forward), KITTI's lidar-to-camera translation, then P2. The 375x1242
    image pads at its bottom and right to 384x1280, which moves no pixel;
    `scale` scales the pixel coordinates for a resized image."""
    rot = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    velo_to_cam = np.concatenate(
        [rot, np.asarray(KITTI_VELO_TO_CAM_T)[:, None]], 1)
    p2 = np.asarray(KITTI_P2)
    proj = p2[:, :3] @ velo_to_cam
    proj[:, 3] += p2[:, 3]
    proj[:2] *= scale
    return proj.astype(np.float32)


def make_kitti_frame(rng: np.random.RandomState, n_azimuth: int = 2600,
                     n_beams: int = 64) -> np.ndarray:
    """Ray-cast single-sweep 64-beam lidar frame (an HDL-64E's elevations,
    +2 to -24.8 degrees, at `n_azimuth` steps a turn) over the scene of
    `make_raycast_frame` with the ego lane clear, cut to the points in
    KITTI's front camera image and in Voxel R-CNN's range (x 0..70.4,
    |y| < 40, -3 < z < 1) -> (P, 4) float32 x, y, z, intensity. About 20k
    points, as a KITTI frame has in the camera's field of view (12k-17k
    voxels at 0.05 m)."""
    return _kitti_frame_and_cars(rng, n_azimuth, n_beams)[0]


def make_kitti_sample(rng: np.random.RandomState, max_boxes: int = 40):
    """A KITTI training sample: the frame `make_kitti_frame(rng)` casts and
    the cars of its scene (class 0) whose centre lies in Voxel R-CNN's
    range and in the front camera's image -> (points (P, 4), gt boxes
    (max_boxes, 7) as (x, y, z gravity centre, dx, dy, dz, heading),
    classes (max_boxes,) int32, valid (max_boxes,) bool), the boxes padded
    with zeros to `max_boxes`."""
    points, (c, dims, yaw) = _kitti_frame_and_cars(rng, 2600, 64)
    proj = kitti_camera()
    uvw = c @ proj[:, :3].T + proj[:, 3]
    depth = uvw[:, 2]
    u = uvw[:, 0] / np.maximum(depth, 1e-6)
    v = uvw[:, 1] / np.maximum(depth, 1e-6)
    h, w = KITTI_IMAGE
    m = (depth > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    m &= ((c[:, 0] >= 0) & (c[:, 0] < 70.4) & (np.abs(c[:, 1]) < 40)
          & (c[:, 2] > -3) & (c[:, 2] < 1))
    cars = np.concatenate([c, dims, yaw[:, None]], 1)[m][:max_boxes]
    boxes = np.zeros((max_boxes, 7), np.float32)
    boxes[:len(cars)] = cars
    valid = np.arange(max_boxes) < len(cars)
    return points, boxes, np.zeros(max_boxes, np.int32), valid


def _kitti_frame_and_cars(rng, n_azimuth, n_beams):
    """`make_kitti_frame`'s points and the scene's cars left in it
    (centres (N, 3), dims (N, 3), headings (N,))."""
    c, dims, yaw, _ = _scene(rng)
    is_car = np.arange(len(c)) < _N_CARS
    # the road ahead is clear: nothing stands in the ego lane's 40 m (the
    # scene's ground lies 1.8 m below the lidar, the HDL-64E's 1.73 m)
    free = ~((c[:, 0] > 0) & (c[:, 0] < 40) & (np.abs(c[:, 1]) < 4))
    c, dims, yaw, is_car = c[free], dims[free], yaw[free], is_car[free]
    el = np.deg2rad(np.linspace(2.0, -24.8, n_beams))
    # only the azimuths the camera can see (+-41 degrees) are cast
    az = (np.arange(n_azimuth) + rng.rand()) * (2 * np.pi / n_azimuth)
    az = az[(az < np.deg2rad(45.0)) | (az > np.deg2rad(315.0))]
    azg, elg = np.meshgrid(az, el, indexing="ij")
    dirs = np.stack([np.cos(elg) * np.cos(azg), np.cos(elg) * np.sin(azg),
                     np.sin(elg)], -1).reshape(-1, 3)
    t = _cast(np.zeros(3), dirs, c, dims, yaw)
    keep = np.isfinite(t) & (t < 120.0) & (t > 1.0)
    keep &= rng.rand(len(t)) > 0.06  # dropout
    p = dirs[keep] * (t[keep, None] + 0.015 * rng.randn(keep.sum(), 1))
    proj = kitti_camera()
    uvw = p @ proj[:, :3].T + proj[:, 3]
    depth = uvw[:, 2]
    u = uvw[:, 0] / np.maximum(depth, 1e-6)
    v = uvw[:, 1] / np.maximum(depth, 1e-6)
    h, w = KITTI_IMAGE
    m = (depth > 0) & (u >= 0) & (u < w) & (v >= 0) & (v < h)
    m &= ((p[:, 0] >= 0) & (p[:, 0] < 70.4) & (np.abs(p[:, 1]) < 40)
          & (p[:, 2] > -3) & (p[:, 2] < 1))
    p = p[m]
    points = np.concatenate([p, rng.rand(len(p), 1)], 1).astype(np.float32)
    return points, (c[is_car], dims[is_car], yaw[is_car])


# ---------------------------------------------------------------------------
# datasets on disk, laid out as the JAX package's tools/create_data.py and
# pcdet / det3d lay them out, for the data pipeline and the CLIs


def write_png(path, rgb: np.ndarray) -> None:
    """(H, W, 3) uint8 -> an 8-bit RGB PNG file (no filter, zlib), written
    without an image library."""
    import struct
    import zlib

    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + np.ascontiguousarray(rgb[y]).tobytes()
                   for y in range(h))

    def chunk(kind: bytes, data: bytes) -> bytes:
        return (struct.pack(">I", len(data)) + kind + data
                + struct.pack(">I", zlib.crc32(kind + data) & 0xFFFFFFFF))

    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n"
                + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
                + chunk(b"IDAT", zlib.compress(raw, 1))
                + chunk(b"IEND", b""))


def kitti_calib() -> dict:
    """The calib of `kitti_camera()`: P2 (3, 4), R0 (identity) and V2C
    (3, 4) as KITTI's calib files hold them."""
    rot = np.array([[0.0, -1.0, 0.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0]])
    v2c = np.concatenate([rot, np.asarray(KITTI_VELO_TO_CAM_T)[:, None]], 1)
    return {"P2": np.asarray(KITTI_P2, np.float32),
            "R0": np.eye(3, dtype=np.float32),
            "V2C": v2c.astype(np.float32)}


def _pad4(m: np.ndarray) -> np.ndarray:
    out = np.eye(4, dtype=np.float32)
    out[:m.shape[0], :m.shape[1]] = m
    return out


def _kitti_frames(root, samples, image_rng=None, image_shapes=None):
    """Write each (points (P, 4), boxes (M, 7) lidar gravity centre[,
    names]) of `samples` as training/velodyne/NNNNNN.bin and
    training/calib/NNNNNN.txt (`kitti_calib`) under `root` and, with
    `image_rng`, a PNG of random pixels in training/image_2 (375x1242, or
    frame i's (H, W) of `image_shapes`). Yields (idx, calib, boxes, the
    labels' camera boxes (M, 7) x, y, z bottom centre, l, h, w, ry, the
    annotations `lidar_boxes_to_kitti_annos` gives them on the frame's
    image, the image's (H, W))."""
    import pathlib

    from df3d_torch.data.kitti import (
        lidar_boxes_to_kitti_annos, lidar_to_rect,
    )

    root = pathlib.Path(root)
    for d in ("velodyne", "calib", "image_2"):
        (root / "training" / d).mkdir(parents=True, exist_ok=True)
    calib = kitti_calib()
    calib_txt = "\n".join(
        f"{k}: " + " ".join(f"{v:.9e}" for v in np.ravel(m))
        for k, m in (("P2", calib["P2"]), ("R0_rect", calib["R0"]),
                     ("Tr_velo_to_cam", calib["V2C"]))) + "\n"
    for i, (points, boxes, *_) in enumerate(samples):
        idx = f"{i:06d}"
        hw = tuple(image_shapes[i]) if image_shapes else KITTI_IMAGE
        np.ascontiguousarray(points, np.float32).tofile(
            root / "training" / "velodyne" / f"{idx}.bin")
        (root / "training" / "calib" / f"{idx}.txt").write_text(calib_txt)
        if image_rng is not None:
            write_png(root / "training" / "image_2" / f"{idx}.png",
                      image_rng.randint(0, 256, hw + (3,), dtype=np.uint8))
        boxes = np.asarray(boxes, np.float32).reshape(-1, 7)
        n = len(boxes)
        bottom = boxes[:, :3].copy()
        bottom[:, 2] -= boxes[:, 5] / 2
        cam = np.concatenate(
            [lidar_to_rect(calib, bottom), boxes[:, [3, 5, 4]],
             (-boxes[:, 6] - np.pi / 2)[:, None]], 1).astype(np.float32)
        det = lidar_boxes_to_kitti_annos(boxes, np.ones(n), np.zeros(n),
                                         calib, hw, ("Car",))
        yield idx, calib, boxes, cam, det, hw


def write_kitti_dataset(root, samples, split: str = "train",
                        images: bool = False,
                        image_rng: np.random.RandomState | None = None):
    """A KITTI-layout dataset under `root`: for each (points (P, 4), car
    boxes (M, 7) lidar gravity centre) of `samples`, training/velodyne/
    NNNNNN.bin, training/calib/NNNNNN.txt (`kitti_calib`) and, with
    `images`, a 375x1242 PNG in training/image_2 (random pixels from
    `image_rng`); and kitti_infos_<split>.pkl with create_data.py's fields
    and, as pcdet's infos carry them, each anno's location, dimensions,
    rotation_y and alpha. -> the info pkl's path."""
    import pathlib
    import pickle

    from df3d_torch.data.kitti import camera_box_to_lidar

    root = pathlib.Path(root)
    infos = []
    for idx, calib, boxes, cam, det, _ in _kitti_frames(
            root, samples, image_rng if images else None):
        n = len(boxes)
        infos.append({
            "point_cloud": {"lidar_idx": idx, "num_features": 4},
            "calib": {"P2": np.vstack([calib["P2"], [0, 0, 0, 1]]),
                      "R0_rect": _pad4(calib["R0"]),
                      "Tr_velo_to_cam": np.vstack([calib["V2C"],
                                                   [0, 0, 0, 1]])},
            "image": {"image_idx": idx, "image_shape": np.array(KITTI_IMAGE)},
            "annos": {
                "name": np.array(["Car"] * n), "truncated": np.zeros(n),
                "occluded": np.zeros(n), "bbox": det["bbox"],
                "alpha": det["alpha"], "location": cam[:, :3],
                "dimensions": cam[:, 3:6], "rotation_y": cam[:, 6],
                "gt_boxes_lidar": (camera_box_to_lidar(cam, calib) if n
                                   else np.zeros((0, 7), np.float32)),
            },
        })
    path = root / f"kitti_infos_{split}.pkl"
    with open(path, "wb") as f:
        pickle.dump(infos, f)
    return path


def write_nuscenes_dataset(root, samples, name: str = "train"):
    """A nuScenes-layout dataset under `root`: each (frame (N, 5) x, y, z,
    intensity, sweep time lag, gt boxes (M, 7 or 9), gt names) of `samples`
    split by its time-lag channel into a key frame (lag 0) and one sweep
    per other lag, each a .bin of (n, 5) float32 under samples/ and
    sweeps/, with identity transforms and the lags as time_lag, so that
    `accumulate_sweeps` gives the frame's points back (key frame first);
    and infos_<name>.pkl as create_data.py writes it ({"infos": [...]},
    7-dof boxes with gt_velocity). -> the info pkl's path."""
    import pathlib
    import pickle

    root = pathlib.Path(root)
    for d in ("samples", "sweeps"):
        (root / d).mkdir(parents=True, exist_ok=True)
    infos = []
    for i, (frame, boxes, names) in enumerate(samples):
        lags = np.unique(frame[:, 4])
        paths = []
        for s, lag in enumerate(lags):
            pts = frame[frame[:, 4] == lag].copy()
            pts[:, 4] = 0.0  # the ring index column of a nuScenes .bin
            rel = f"{'samples' if s == 0 else 'sweeps'}/{i:04d}_{s}.bin"
            pts.astype(np.float32).tofile(root / rel)
            paths.append((rel, float(lag)))
        boxes = np.asarray(boxes, np.float32)
        vel = (boxes[:, 7:9] if boxes.shape[1] >= 9
               else np.zeros((len(boxes), 2), np.float32))
        infos.append({
            "token": f"sample_{i:04d}", "lidar_path": paths[0][0],
            "timestamp": 1_000_000 * i,
            "sweeps": [{"lidar_path": rel,
                        "transform_matrix": np.eye(4, dtype=np.float32),
                        "time_lag": lag} for rel, lag in paths[1:]],
            "cams": {},
            "gt_boxes": boxes[:, :7].copy(), "gt_names": np.asarray(names),
            "gt_velocity": vel.astype(np.float32),
        })
    path = root / f"infos_{name}.pkl"
    with open(path, "wb") as f:
        pickle.dump({"infos": infos, "version": "synthetic"}, f)
    return path


# ---------------------------------------------------------------------------
# raw dataset files, as KITTI's and nuScenes' distributions lay them out,
# for `df3d_torch.tools.create_data`

def write_kitti_raw(root, samples, split: str = "train",
                    image_rng: np.random.RandomState | None = None,
                    image_shapes=None) -> list[str]:
    """Raw KITTI files under `root`: `_kitti_frames`' velodyne, calib and
    (with `image_rng`) image_2 PNG files, training/label_2/NNNNNN.txt with
    one line per box (KITTI's 15 columns: type, truncated, occluded, alpha,
    2D bbox, h, w, l, bottom centre x, y, z in the rectified camera frame,
    rotation_y; each `samples` entry's names, else "Car"), and
    ImageSets/<split>.txt. -> the frame ids."""
    import pathlib

    root = pathlib.Path(root)
    (root / "training" / "label_2").mkdir(parents=True, exist_ok=True)
    (root / "ImageSets").mkdir(exist_ok=True)
    ids = []
    def wrap(a):  # KITTI's angles lie in [-pi, pi)
        return (np.asarray(a, np.float64) + np.pi) % (2 * np.pi) - np.pi

    for (idx, _, boxes, cam, det, _), sample in zip(
            _kitti_frames(root, samples, image_rng, image_shapes), samples):
        names = sample[2] if len(sample) > 2 else ["Car"] * len(boxes)
        cam = np.concatenate([cam[:, :6], wrap(cam[:, 6:])], 1)
        lines = [
            f"{name} 0.00 0 {a:.2f} "
            + " ".join(f"{v:.2f}" for v in bb) + " "
            + f"{c[4]:.2f} {c[5]:.2f} {c[3]:.2f} "
            + f"{c[0]:.2f} {c[1]:.2f} {c[2]:.2f} {c[6]:.2f}"
            for name, a, bb, c in zip(names, wrap(det["alpha"]), det["bbox"],
                                      cam)]
        (root / "training" / "label_2" / f"{idx}.txt").write_text(
            "".join(line + "\n" for line in lines))
        ids.append(idx)
    (root / "ImageSets" / f"{split}.txt").write_text(
        "".join(i + "\n" for i in ids))
    return ids


# a raw nuScenes category of each detection class (the first that
# mmdet3d's NuScenesDataset.NameMapping sends to it)
NUSC_CATEGORY = {
    "car": "vehicle.car", "truck": "vehicle.truck",
    "construction_vehicle": "vehicle.construction",
    "bus": "vehicle.bus.rigid", "trailer": "vehicle.trailer",
    "barrier": "movable_object.barrier", "motorcycle": "vehicle.motorcycle",
    "bicycle": "vehicle.bicycle", "pedestrian": "human.pedestrian.adult",
    "traffic_cone": "movable_object.trafficcone"}
# nuScenes' camera channels in `NUSC_CAM_YAWS_DEG`'s order
NUSC_CAMERAS = ("CAM_FRONT", "CAM_FRONT_RIGHT", "CAM_FRONT_LEFT",
                "CAM_BACK", "CAM_BACK_LEFT", "CAM_BACK_RIGHT")
NUSC_IMAGE = (900, 1600)
# the LiDAR's mounting on the ego vehicle (nuScenes' LIDAR_TOP: 1.84 m up,
# its x axis turned 90 degrees to the ego's right)
NUSC_LIDAR_T = (0.943713, 0.0, 1.84023)
NUSC_LIDAR_YAW = -np.pi / 2


def _rot_z(yaw: float) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])


def _pose(rot: np.ndarray, t) -> np.ndarray:
    out = np.eye(4)
    out[:3, :3] = rot
    out[:3, 3] = t
    return out


def _quaternion(rot: np.ndarray) -> list[float]:
    """A rotation matrix -> the unit quaternion [w, x, y, z] (w >= 0)."""
    m = rot
    w = np.sqrt(max(0.0, 1.0 + m[0, 0] + m[1, 1] + m[2, 2])) / 2
    x = np.sqrt(max(0.0, 1.0 + m[0, 0] - m[1, 1] - m[2, 2])) / 2
    y = np.sqrt(max(0.0, 1.0 - m[0, 0] + m[1, 1] - m[2, 2])) / 2
    z = np.sqrt(max(0.0, 1.0 - m[0, 0] - m[1, 1] + m[2, 2])) / 2
    x = np.copysign(x, m[2, 1] - m[1, 2])
    y = np.copysign(y, m[0, 2] - m[2, 0])
    z = np.copysign(z, m[1, 0] - m[0, 1])
    q = np.array([w, x, y, z])
    return (q / np.linalg.norm(q)).tolist()


def _pose_row(token: str, pose: np.ndarray, **extra) -> dict:
    return {"token": token, "translation": pose[:3, 3].tolist(),
            "rotation": _quaternion(pose[:3, :3]), **extra}


def _smooth_image(rng: np.random.RandomState, hw, block: int = 10):
    """(H, W, 3) uint8: random colours in `block`-pixel squares (a JPEG of
    pure noise would be ~1 MB)."""
    h, w = hw
    low = rng.randint(0, 256, (-(-h // block), -(-w // block), 3),
                      dtype=np.uint8)
    return np.repeat(np.repeat(low, block, 0), block, 1)[:h, :w]


def write_nuscenes_raw(root, samples, version: str = "v1.0-trainval",
                       image_rng: np.random.RandomState | None = None,
                       image_shape=NUSC_IMAGE, seed: int = 0) -> None:
    """A raw nuScenes distribution under `root`: the devkit's relational
    JSON tables in `root/version/` (scene, sample, sample_data,
    ego_pose, calibrated_sensor, sensor, sample_annotation, instance,
    category: the fields nuScenes' schema gives them) and the files they
    name, from `samples`, each (frame (N, 5) x, y, z, intensity, sweep
    time lag in the key frame's LiDAR frame; boxes (M, 9) x, y, z, dx, dy,
    dz, yaw, vx, vy in that frame; their raw category names).

    Each sample is a scene of its own: the key frame (the rows of lag 0)
    as samples/LIDAR_TOP/*.pcd.bin and one sweep per other lag as
    sweeps/LIDAR_TOP/*.pcd.bin, (n, 5) float32 with the ring index 0,
    each in its own LiDAR frame: the ego drives along the key frame's x at
    5 m/s and turns 0.01 rad a sweep, so that each sweep's pose chain
    brings its points back. With `image_rng`, six JPEG cameras of
    `image_shape` on the rig of `camera_rig` (intrinsics `rig_intrinsics`)
    at the key frame. Every box is annotated at the key frame and, moved
    back and forth by its velocity, at a sample 0.5 s before and after it
    (samples with no sensor data), so that the devkit's central difference
    gives its velocity. Ego poses, timestamps and the box poses in the
    global frame come from `seed`."""
    import json
    import pathlib

    from df3d_torch.data.images import write_jpeg

    root = pathlib.Path(root)
    tdir = root / version
    tdir.mkdir(parents=True, exist_ok=True)
    for d in ("samples/LIDAR_TOP", "sweeps/LIDAR_TOP",
              *(f"samples/{c}" for c in NUSC_CAMERAS)):
        (root / d).mkdir(parents=True, exist_ok=True)
    rng = np.random.RandomState(seed)
    t = {k: [] for k in ("scene", "sample", "sample_data", "ego_pose",
                         "calibrated_sensor", "sensor", "sample_annotation",
                         "instance", "category")}
    channels = ("LIDAR_TOP",) + (NUSC_CAMERAS if image_rng is not None
                                 else ())
    for ch in channels:
        t["sensor"].append({"token": f"sensor_{ch}", "channel": ch,
                            "modality": "lidar" if ch == "LIDAR_TOP"
                            else "camera"})
    ego_from_lidar = _pose(_rot_z(NUSC_LIDAR_YAW), NUSC_LIDAR_T)
    t["calibrated_sensor"].append(_pose_row(
        "cs_LIDAR_TOP", ego_from_lidar, sensor_token="sensor_LIDAR_TOP",
        camera_intrinsic=[]))
    if image_rng is not None:
        intrinsic = rig_intrinsics(image_shape).tolist()
        for ch, (rot, center) in zip(NUSC_CAMERAS, rig_poses()):
            t["calibrated_sensor"].append(_pose_row(
                f"cs_{ch}", ego_from_lidar @ _pose(rot.T, center),
                sensor_token=f"sensor_{ch}", camera_intrinsic=intrinsic))
    categories = {}

    def sample_data(token, sample, ch, ego, ts, filename, key, prev="",
                    nxt=""):
        t["ego_pose"].append(_pose_row(f"ep_{token}", ego, timestamp=ts))
        t["sample_data"].append({
            "token": token, "sample_token": sample,
            "ego_pose_token": f"ep_{token}",
            "calibrated_sensor_token": f"cs_{ch}", "timestamp": ts,
            "fileformat": "pcd" if ch == "LIDAR_TOP" else "jpg",
            "is_key_frame": key, "height": 0 if ch == "LIDAR_TOP"
            else image_shape[0], "width": 0 if ch == "LIDAR_TOP"
            else image_shape[1], "filename": filename, "prev": prev,
            "next": nxt})

    for i, (frame, boxes, names) in enumerate(samples):
        frame = np.asarray(frame, np.float32)
        boxes = np.asarray(boxes, np.float64).reshape(-1, 9)
        ts = 1_533_151_603_547_590 + 20_000_000 * i
        ego = _pose(_rot_z(rng.uniform(-np.pi, np.pi)),
                    [rng.uniform(300, 2000), rng.uniform(600, 1700), 0.0])
        lidar_to_global = ego @ ego_from_lidar
        scene, key = f"scene_{i:04d}", f"sample_{i:04d}"
        tokens = (f"{key}_prev", key, f"{key}_next")
        t["scene"].append({
            "token": scene, "name": f"scene-{i + 1:04d}", "description": "",
            "log_token": "", "nbr_samples": 3,
            "first_sample_token": tokens[0], "last_sample_token": tokens[2]})
        for j, tok in enumerate(tokens):
            t["sample"].append({
                "token": tok, "timestamp": ts + 500_000 * (j - 1),
                "scene_token": scene, "prev": tokens[j - 1] if j else "",
                "next": tokens[j + 1] if j < 2 else ""})

        # the LiDAR: the key frame, then its sweeps back in time
        lags = np.unique(frame[:, 4])
        assert lags[0] == 0, "a frame needs its key frame's rows (lag 0)"
        sd = [f"lidar_{i:04d}_{s}" for s in range(len(lags))]
        for s, lag in enumerate(lags):
            motion = _pose(_rot_z(-0.01 * s), [-5.0 * float(lag), 0.0, 0.0])
            pts = frame[frame[:, 4] == lag].astype(np.float64)
            pts[:, :3] = pts[:, :3] @ np.linalg.inv(motion)[:3, :3].T + (
                np.linalg.inv(motion)[:3, 3])
            pts[:, 4] = 0.0  # the ring index column of a nuScenes .bin
            where = "samples" if s == 0 else "sweeps"
            rel = f"{where}/LIDAR_TOP/{sd[s]}.pcd.bin"
            pts.astype(np.float32).tofile(root / rel)
            sample_data(sd[s], key, "LIDAR_TOP",
                        lidar_to_global @ motion @ np.linalg.inv(
                            ego_from_lidar),
                        ts - int(round(float(lag) * 1e6)), rel, s == 0,
                        prev=sd[s + 1] if s + 1 < len(lags) else "",
                        nxt=sd[s - 1] if s else "")
        if image_rng is not None:
            for ch in NUSC_CAMERAS:
                token = f"{ch.lower()}_{i:04d}"
                rel = f"samples/{ch}/{token}.jpg"
                write_jpeg(root / rel, _smooth_image(image_rng, image_shape))
                sample_data(token, key, ch, ego, ts, rel, True)

        # the boxes at the key frame and 0.5 s either side of it
        rot = lidar_to_global[:3, :3]
        for j, (box, name) in enumerate(zip(boxes, names)):
            cat = categories.setdefault(name, f"category_{len(categories)}")
            inst = f"instance_{i:04d}_{j}"
            centre = rot @ box[:3] + lidar_to_global[:3, 3]
            vel = rot @ np.array([box[7], box[8], 0.0])
            quat = _quaternion(rot @ _rot_z(box[6]))
            ann = [f"ann_{i:04d}_{j}_{k}" for k in range(3)]
            for k in range(3):
                t["sample_annotation"].append({
                    "token": ann[k], "sample_token": tokens[k],
                    "instance_token": inst, "visibility_token": "4",
                    "attribute_tokens": [],
                    "translation": (centre + 0.5 * (k - 1) * vel).tolist(),
                    "size": [float(box[4]), float(box[3]), float(box[5])],
                    "rotation": quat, "prev": ann[k - 1] if k else "",
                    "next": ann[k + 1] if k < 2 else "",
                    "num_lidar_pts": 1, "num_radar_pts": 0})
            t["instance"].append({
                "token": inst, "category_token": cat,
                "nbr_annotations": 3, "first_annotation_token": ann[0],
                "last_annotation_token": ann[2]})
    t["category"] = [{"token": tok, "name": name, "description": ""}
                     for name, tok in categories.items()]
    for name, rows in t.items():
        with open(tdir / f"{name}.json", "w") as f:
            json.dump(rows, f)
