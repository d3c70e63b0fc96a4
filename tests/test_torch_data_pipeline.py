"""The port's data pipeline against the JAX package's numpy modules:
images (`df3d_torch/data/images.py`), augmentation (`augment.py`), the
training transform (`transforms.py`) and the loader (`pipeline.py`). Both
packages get the same arrays, files and seeds; every result must be equal
bit for bit (`np.array_equal`, no tolerance). No JAX program is compiled:
these modules are numpy in both packages."""

import sys
import threading
import time

import numpy as np
import pytest

from df3d.data import augment as JA
from df3d.data import images as JI
from df3d.data import pipeline as JP
from df3d.data import transforms as JT
from df3d_torch.data import augment as TA
from df3d_torch.data import images as TI
from df3d_torch.data import pipeline as TP
from df3d_torch.data import transforms as TT
from df3d_torch.utils.synth import write_png
from torch_port_helpers import assert_same as _equal
from torch_port_helpers import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("shape, target", [
    ((375, 1242), (384, 1280)), ((45, 80), (64, 112)), ((64, 96), (32, 48)),
    ((30, 50), (30, 50))])
def test_images_equal(tmp_path, monkeypatch, shape, target):
    """decode_image, resize_normalize_pad (keep-ratio and not; the scale
    taken from the rounded size), scale_projection, load_camera_frame and
    finalize_camera_sample; an image already at its target size imports no
    Pillow."""
    rng = np.random.RandomState(sum(shape))
    img = rng.randint(0, 256, shape + (3,), dtype=np.uint8)
    path = tmp_path / "cam.png"
    write_png(path, img)
    _equal(TI.decode_image(path), JI.decode_image(path))
    for keep in (True, False):
        _equal(TI.resize_normalize_pad(img, target, keep_ratio=keep),
               JI.resize_normalize_pad(img, target, keep_ratio=keep))
    proj = rng.randn(2, 3, 4).astype(np.float32)
    _equal(TI.scale_projection(proj[0], 0.3, 1.7),
           JI.scale_projection(proj[0], 0.3, 1.7))
    _equal(TI.load_camera_frame([path, path], proj, target),
           JI.load_camera_frame([path, path], proj, target))
    sample = {"image": img, "proj": proj[0], "points": np.zeros((2, 4))}
    _equal(TI.finalize_camera_sample(sample, target),
           JI.finalize_camera_sample(sample, target))
    if shape == target:
        monkeypatch.setitem(sys.modules, "PIL", None)
        out, scale = TI.resize_normalize_pad(img, target)
        assert scale == (1.0, 1.0)
        with pytest.raises(ImportError):
            TI.decode_image(path)


def _points_boxes(rng, n=300, m=6, box_dim=9, f=5):
    pts = np.concatenate([rng.uniform(-30, 30, (n, 3)), rng.rand(n, f - 3)],
                         1).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-20, 20, (m, 3)),
                            rng.uniform(1, 4, (m, 3)),
                            rng.uniform(-3, 3, (m, box_dim - 6))],
                           1).astype(np.float32)
    return pts, boxes


@pytest.mark.parametrize("cfg", [
    dict(flip_axes=("x",), rot_range=(-0.785, 0.785),
         scale_range=(0.95, 1.05)),
    dict(flip_axes=("x", "y"), rot_range=(-0.3, 0.3), scale_range=(0.9, 1.1),
         translate_std=0.5),
    dict(flip_axes=("y",), rot_range=None, scale_range=None),
], ids=["default", "all", "flip_y"])
def test_world_augs_equal(cfg):
    """apply_world_augs and each augmentation: equal draws, outputs and
    recorded parameters, and the same in-place edits of the inputs (7- and
    9-dof boxes, no boxes)."""
    for seed, box_dim in ((0, 9), (1, 7), (2, 9), (3, 7), (4, None)):
        pts, boxes = _points_boxes(np.random.RandomState(seed),
                                   box_dim=box_dim or 7)
        if box_dim is None:
            boxes = None
        got_in = (pts.copy(), None if boxes is None else boxes.copy())
        want_in = (pts.copy(), None if boxes is None else boxes.copy())
        got = TA.apply_world_augs(*got_in, np.random.RandomState(seed), cfg)
        want = JA.apply_world_augs(*want_in, np.random.RandomState(seed),
                                   cfg)
        _equal(got, want)
        _equal(got_in, want_in)  # the flips edited the inputs alike
    pts, boxes = _points_boxes(np.random.RandomState(9))
    for fn, args in ((TA.random_world_flip, (("x", "y"),)),
                     (TA.random_world_rotation, ((-1.0, 1.0),)),
                     (TA.random_world_scaling, ((0.8, 1.2),)),
                     (TA.random_world_translation, (0.7,))):
        jfn = getattr(JA, fn.__name__)
        _equal(fn(pts.copy(), boxes.copy(), np.random.RandomState(3), *args),
               jfn(pts.copy(), boxes.copy(), np.random.RandomState(3), *args))


def _gt_db(tmp_path, rng, n=6, crops=True):
    """A GT database of n cars (npy and bin point files, stored crops as
    arrays and as files) under tmp_path."""
    db = []
    for i in range(n):
        obj = (rng.randn(25, 4) * 0.3).astype(np.float32)
        entry = {"num_points": 25 if i != 2 else 3,
                 "box3d_lidar": np.array([12.0 + 4 * i, -3.0 + i, 0.2, 4.0,
                                          1.8, 1.5, 0.1 * i], np.float32)}
        if i % 2:
            np.save(tmp_path / f"o{i}.npy", obj)
            entry["path"] = f"o{i}.npy"
        else:
            obj.tofile(tmp_path / f"o{i}.bin")
            entry["path"] = f"o{i}.bin"
        if crops and i % 3 == 0:
            entry["image_crop"] = rng.randint(0, 256, (6 + i, 9, 3), np.uint8)
        elif crops and i % 3 == 1:
            np.save(tmp_path / f"c{i}.npy",
                    rng.randint(0, 256, (7, 5 + i, 3), np.uint8))
            entry["image_crop_path"] = f"c{i}.npy"
        db.append(entry)
    return {"Car": db, "Pedestrian": db[:2]}


def test_gt_sampling_equal(tmp_path):
    """GTSampler (min points, groups, collisions with the scene and among
    the candidates, the road-plane lift, the points in pasted boxes
    removed), load_crop, bev_overlap_exists, put_boxes_on_road_plane,
    project_box_to_image_bbox and paste_objects_to_image."""
    rng = np.random.RandomState(7)
    db = _gt_db(tmp_path, rng)
    calib = {"R0": np.eye(3, dtype=np.float32),
             "V2C": np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0]],
                             np.float32)}
    plane = np.array([0.02, -0.99, 0.05, 1.7], np.float32)
    plane /= np.linalg.norm(plane[:3])
    for use_plane in (False, True):
        tsamp = TA.GTSampler(db, {"Car": 4, "Pedestrian": 1},
                             root=tmp_path, use_road_plane=use_plane)
        jsamp = JA.GTSampler(db, {"Car": 4, "Pedestrian": 1},
                             root=tmp_path, use_road_plane=use_plane)
        for seed in range(4):
            pts, boxes = _points_boxes(np.random.RandomState(seed), m=2,
                                       box_dim=7, f=4)
            names = np.array(["Car", "Pedestrian"])
            args = [(pts.copy(), boxes.copy(), names.copy()),
                    (pts.copy(), None, None)][seed % 2]
            got = tsamp(*args, np.random.RandomState(seed),
                        road_plane=plane, calib=calib)
            want = jsamp(*args, np.random.RandomState(seed),
                         road_plane=plane, calib=calib)
            _equal(got[:3], want[:3])
            assert [i["path"] for i in got[3]] == [i["path"] for i in want[3]]
            for info in got[3]:
                _equal(tsamp.load_crop(info), jsamp.load_crop(info))
    a = np.concatenate([rng.uniform(-5, 5, (12, 3)), rng.uniform(1, 4, (12, 3)),
                        rng.uniform(-3, 3, (12, 1))], 1).astype(np.float32)
    _equal(TA.bev_overlap_exists(a[:7], a[7:]),
           JA.bev_overlap_exists(a[:7], a[7:]))
    _equal(TA.put_boxes_on_road_plane(a, plane, calib),
           JA.put_boxes_on_road_plane(a, plane, calib))
    proj = np.array([[60, -60, 0, 48], [0, -20, -60, 32], [1, 0, 0, 0]],
                    np.float32)
    far = a + np.array([15, 0, 0, 0, 0, 0, 0], np.float32)
    bbs = [TA.project_box_to_image_bbox(b, proj, (64, 96)) for b in far]
    _equal(bbs, [JA.project_box_to_image_bbox(b, proj, (64, 96))
                 for b in far])
    crops = [rng.randint(0, 256, (5 + i, 4 + 2 * i, 3), np.uint8)
             for i in range(len(bbs))]
    image = rng.randint(0, 256, (64, 96, 3), np.uint8)
    boxes2d = np.stack([b for b, _ in bbs])
    depths = [d for _, d in bbs]
    _equal(TA.paste_objects_to_image(image, crops, boxes2d, depths),
           JA.paste_objects_to_image(image, crops, boxes2d, depths))
    pts, _ = _points_boxes(rng, n=2000)
    _equal(TA._remove_points_in_boxes(pts, a),
           JA._remove_points_in_boxes(pts, a))


def test_train_transform_equal(tmp_path):
    """make_train_transform end to end, gt sampling with the depth-ordered
    image paste and the road-plane lift, then the world augmentations; the
    camera sample finalized after it."""
    rng = np.random.RandomState(11)
    db = _gt_db(tmp_path, rng)
    proj = np.array([[60, -60, 0, 48], [0, -20, -60, 32], [1, 0, 0, 0]],
                    np.float32)
    calib = {"R0": np.eye(3, dtype=np.float32),
             "V2C": np.array([[0, -1, 0, 0], [0, 0, -1, 0], [1, 0, 0, 0]],
                             np.float32)}
    pasted = 0
    for paste in (True, False):
        kw = dict(flip_axes=("x", "y"), translate_std=0.2,
                  image_paste=paste, class_names=("Car", "Pedestrian"))
        ttf = TT.make_train_transform(TA.GTSampler(
            db, {"Car": 5}, root=tmp_path, use_road_plane=True), **kw)
        jtf = JT.make_train_transform(JA.GTSampler(
            db, {"Car": 5}, root=tmp_path, use_road_plane=True), **kw)
        for seed in range(3):
            pts, boxes = _points_boxes(np.random.RandomState(seed), m=1,
                                       box_dim=7, f=4)
            sample = {"points": pts, "gt_boxes": boxes,
                      "gt_names": np.array(["Pedestrian"]),
                      "image": rng.randint(0, 256, (64, 96, 3), np.uint8),
                      "proj": proj, "calib": calib,
                      "road_plane": np.array([0, -1, 0, 1.7], np.float32)}
            got = ttf({k: np.copy(v) if isinstance(v, np.ndarray) else v
                       for k, v in sample.items()}, np.random.RandomState(seed))
            want = jtf({k: np.copy(v) if isinstance(v, np.ndarray) else v
                        for k, v in sample.items()},
                       np.random.RandomState(seed))
            _equal(got, want)
            _equal(TI.finalize_camera_sample(got, (96, 128)),
                   JI.finalize_camera_sample(want, (96, 128)))
            pasted += paste and not np.array_equal(got["image"],
                                                   sample["image"])
    assert pasted, "no sampled object was pasted into an image"


class _Dataset:
    """n samples of random points and boxes, with infos for CBGS."""

    class_names = ("car", "truck", "bus")

    def __init__(self, n, fail_at=None):
        self.n, self.fail_at = n, fail_at
        rng = np.random.RandomState(0)
        self.infos = [{"gt_names": np.asarray(self.class_names)[
            rng.randint(0, 3, 1 + i % 3)]} for i in range(n)]

    def __len__(self):
        return self.n

    def __getitem__(self, i):
        if i == self.fail_at:
            raise ValueError(f"sample {i} is unreadable")
        rng = np.random.RandomState(100 + i)
        pts, boxes = _points_boxes(rng, n=50 + 7 * i, m=1 + i % 4)
        return {"points": pts, "gt_boxes": boxes,
                "gt_names": np.array(["car"] * len(boxes)),
                "gt_classes": np.arange(len(boxes), dtype=np.int32) % 3,
                "index": i}


def test_make_batch_and_pad_to_equal():
    """make_batch with and without augmentation records, truncating points
    and boxes; pad_to both ways."""
    ds = _Dataset(5)
    samples = [ds[i] for i in range(5)]
    rng = np.random.RandomState(2)
    for s in samples[::2]:
        s["aug_params"] = TA.WorldAugParams(
            flip_x=bool(rng.rand() < 0.5), flip_y=True,
            noise_rot=float(rng.randn()), noise_scale=float(rng.rand()))
    for max_points, max_gt in ((60, 8), (40, 2)):
        _equal(TP.make_batch(samples, max_points, max_gt, 5),
               JP.make_batch(samples, max_points, max_gt, 5))
    arr = rng.randn(7, 3).astype(np.float32)
    for n in (3, 7, 12):
        _equal(TP.pad_to(arr, n, -1.0), JP.pad_to(arr, n, -1.0))


def test_loader_batches_equal():
    """PrefetchLoader over two epochs, two shards, a transform drawing from
    the loader's generator, drop_last both ways, and a CBGS-resampled
    dataset: the same batches in the same order as the JAX loader's."""
    from df3d.data.nuscenes import CBGSWrapper as JCBGS
    from df3d_torch.data.nuscenes import CBGSWrapper as TCBGS

    cfg = dict(flip_axes=("x",), rot_range=(-0.5, 0.5),
               scale_range=(0.9, 1.1))

    def collate(samples):
        batch = TP.make_batch(samples, 90, 4, 5)
        batch["index"] = np.array([s["index"] for s in samples])
        return batch

    def transform(aug):
        def tf(sample, rng):
            pts, boxes, params = aug.apply_world_augs(
                sample["points"].copy(), sample["gt_boxes"].copy(), rng, cfg)
            return dict(sample, points=pts, gt_boxes=boxes,
                        aug_params=params)
        return tf

    for shard in (0, 1):
        for drop_last, cbgs in ((True, False), (False, True)):
            got, want = [], []
            for pkg, aug, cb, out in ((TP, TA, TCBGS, got),
                                      (JP, JA, JCBGS, want)):
                ds = cb(_Dataset(11)) if cbgs else _Dataset(11)
                loader = pkg.PrefetchLoader(
                    ds, 2, collate, seed=3, shard_id=shard, num_shards=2,
                    transform=transform(aug), drop_last=drop_last)
                for _ in range(2):
                    out.append([b for b in loader])
            _equal(got, want)
            assert got[0] and not _same_order(got[0], got[1])


def _same_order(a, b):
    return [x["index"].tolist() for x in a] == [x["index"].tolist() for x in b]


def test_loader_reraises_worker_exception():
    """A sample that raises in the worker reaches the consumer within
    seconds, where the JAX package's loader would wait forever; a consumer
    that stops early leaves no worker behind."""
    loader = TP.PrefetchLoader(_Dataset(8, fail_at=1), 2,
                               lambda s: TP.make_batch(s, 64, 4, 5),
                               shuffle=False)
    caught = []

    def consume():
        try:
            list(loader)
        except ValueError as e:
            caught.append(e)

    t0 = time.perf_counter()
    t = threading.Thread(target=consume, daemon=True)
    t.start()
    t.join(10.0)
    assert not t.is_alive(), "the loader hung on the worker's exception"
    assert caught and "sample 1" in str(caught[0])
    assert time.perf_counter() - t0 < 10.0
    assert loader.epoch == 0  # the failed epoch did not count
    ok = TP.PrefetchLoader(_Dataset(8), 2,
                           lambda s: TP.make_batch(s, 64, 4, 5), prefetch=1)
    before = threading.active_count()
    it = iter(ok)
    next(it)
    it.close()
    assert threading.active_count() == before
