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
    h, w = image_shape
    f = 1266.0 * w / 1600.0
    k = np.array([[f, 0.0, w / 2.0], [0.0, f, h / 2.0], [0.0, 0.0, 1.0]])
    out = []
    for yaw in np.deg2rad(NUSC_CAM_YAWS_DEG[:num_cams]):
        fwd = np.array([np.cos(yaw), np.sin(yaw), 0.0])
        right = np.array([np.sin(yaw), -np.cos(yaw), 0.0])
        down = np.array([0.0, 0.0, -1.0])
        rot = np.stack([right, down, fwd])          # lidar -> camera axes
        center = 0.5 * fwd + np.array([0.0, 0.0, -0.3])
        out.append(k @ np.concatenate([rot, -rot @ center[:, None]], 1))
    return np.stack(out).astype(np.float32)


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
