"""The port's numpy evaluators and eval-loop glue (df3d_torch.data.
nuscenes_eval, kitti_eval, kitti; df3d_torch.train.evaluate) against the
JAX package's: the same synthetic detections and ground truth go through
both, and every number (APs, TP errors, NDS, KITTI's APs, AOS and recall
records) is equal. Scoring the ground truth as its own detections gives
what the JAX package's own tests assert. Nothing here runs a model."""

import importlib.util
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from df3d.data import kitti as jkitti
from df3d.data import kitti_eval as jke
from df3d.data import nuscenes_eval as jne
from df3d.data.nuscenes import NUSC_CLASSES as JNUSC_CLASSES
from df3d_torch.data import kitti as tkitti
from df3d_torch.data import kitti_eval as tke
from df3d_torch.data import nuscenes_eval as tne
from df3d_torch.train.evaluate import (
    kitti_metrics, kitti_records, nuscenes_metrics, nuscenes_records,
)
from test_kitti_data import CALIB_TXT
from torch_port_helpers import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parents[1]


def _tools_test():
    """The JAX package's eval CLI module (its loop bodies are the glue)."""
    spec = importlib.util.spec_from_file_location("df3d_eval_cli",
                                                  ROOT / "tools" / "test.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def assert_same(got, want, path="result"):
    """Nested dicts, lists and numbers equal, NaN where the other has NaN."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            assert_same(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{path}[{i}]")
    elif isinstance(want, np.ndarray) or isinstance(got, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=path)
    elif isinstance(want, float) and math.isnan(want):
        assert math.isnan(got), path
    else:
        assert got == want, (path, got, want)


def _nusc_frames(rng, n_frames=6):
    """Ground truth of several classes and detections around it: jittered
    centres, sizes, headings and velocities, misses and false positives."""
    classes = np.asarray(tne.NUSC_CLASSES)
    gts, dets = [], []
    for _ in range(n_frames):
        m = rng.randint(3, 9)
        gt = np.concatenate([rng.uniform(-40, 40, (m, 2)),
                             rng.uniform(-1, 1, (m, 1)),
                             rng.uniform(0.5, 5, (m, 3)),
                             rng.uniform(-np.pi, np.pi, (m, 1)),
                             rng.randn(m, 2)], 1).astype(np.float32)
        names = classes[rng.randint(0, 10, m)]
        keep = rng.rand(m) < 0.8
        det = gt[keep] + rng.randn(keep.sum(), 9).astype(np.float32) * 0.3
        fp = np.concatenate([rng.uniform(-40, 40, (2, 2)),
                             np.zeros((2, 1)), np.ones((2, 3)),
                             np.zeros((2, 3))], 1).astype(np.float32)
        gts.append({"boxes": gt, "names": names,
                    "attrs": rng.randint(-1, 3, m).astype(np.int32)})
        dets.append({"boxes": np.concatenate([det, fp]),
                     "names": np.concatenate([names[keep],
                                              classes[rng.randint(0, 10, 2)]]),
                     "scores": rng.rand(keep.sum() + 2).astype(np.float32),
                     "attrs": rng.randint(-1, 3, keep.sum() + 2).astype(
                         np.int32)})
    return gts, dets


def test_nuscenes_classes():
    assert tne.NUSC_CLASSES == JNUSC_CLASSES


@pytest.mark.parametrize("seed", [0, 1])
def test_evaluate_nuscenes_equals_jax(seed):
    gts, dets = _nusc_frames(np.random.RandomState(seed))
    assert_same(tne.evaluate_nuscenes(gts, dets, tne.NUSC_CLASSES),
                jne.evaluate_nuscenes(gts, dets, JNUSC_CLASSES))
    for cls in ("car", "barrier"):
        assert_same(tne.accumulate_class(gts, dets, cls, 2.0),
                    jne.accumulate_class(gts, dets, cls, 2.0))


def test_nuscenes_perfect_detections():
    """tests/test_nuscenes_eval.py::test_perfect_detections on the port."""
    car = [10.0, 0.0, 0.0, 4.0, 2.0, 1.5, 0.3, 1.0, 0.0]
    ped = [5.0, 5.0, 0.0, 0.7, 0.7, 1.7, 0.0, 0.0, 0.0]

    def frame(scores=None):
        out = {"boxes": np.asarray([car, ped], np.float32),
               "names": np.asarray(["car", "pedestrian"]),
               "attrs": np.asarray([1, 2], np.int32)}
        if scores is not None:
            out["scores"] = np.asarray(scores, np.float32)
        return out

    res = tne.evaluate_nuscenes([frame()] * 10, [frame([0.9, 0.8])] * 10,
                                ("car", "pedestrian"))
    assert res["mAP"] > 0.95
    assert res["tp_errors"]["trans_err"] < 0.01
    assert res["tp_errors"]["attr_err"] < 1e-9
    assert res["NDS"] > 0.95


def _kitti_calib(tmp_path):
    p = tmp_path / "calib.txt"
    p.write_text(CALIB_TXT)
    return jkitti.parse_calib_file(p)


def _kitti_gt_lidar(rng, m):
    """Cars in front of the camera, lidar 7-dof."""
    return np.concatenate([rng.uniform(8, 40, (m, 1)),
                           rng.uniform(-8, 8, (m, 1)),
                           rng.uniform(-1.2, -0.6, (m, 1)),
                           rng.uniform(3.5, 4.5, (m, 1)),
                           rng.uniform(1.5, 1.8, (m, 1)),
                           rng.uniform(1.4, 1.7, (m, 1)),
                           rng.uniform(-np.pi, np.pi, (m, 1))],
                          1).astype(np.float32)


def test_kitti_box_conversions_equal_jax(tmp_path):
    calib = _kitti_calib(tmp_path)
    rng = np.random.RandomState(0)
    boxes = _kitti_gt_lidar(rng, 7)
    np.testing.assert_array_equal(tkitti.lidar_to_img_matrix(calib),
                                  jkitti.lidar_to_img_matrix(calib))
    pts = boxes[:, :3]
    rect = tkitti.lidar_to_rect(calib, pts)
    np.testing.assert_array_equal(rect, jkitti.lidar_to_rect(calib, pts))
    np.testing.assert_array_equal(tkitti.rect_to_lidar(calib, rect),
                                  jkitti.rect_to_lidar(calib, rect))
    cam = np.concatenate([rect, boxes[:, [3, 5, 4, 6]]], 1)
    np.testing.assert_array_equal(tkitti.camera_box_to_lidar(cam, calib),
                                  jkitti.camera_box_to_lidar(cam, calib))
    args = (boxes, rng.rand(7).astype(np.float32), np.zeros(7, np.int32),
            calib, (375, 1242), ("Car",))
    assert_same(tkitti.lidar_boxes_to_kitti_annos(*args),
                jkitti.lidar_boxes_to_kitti_annos(*args))
    empty = (np.zeros((0, 7), np.float32),) + args[1:]
    assert_same(tkitti.lidar_boxes_to_kitti_annos(*empty),
                jkitti.lidar_boxes_to_kitti_annos(*empty))
    det = boxes + rng.randn(7, 7).astype(np.float32) * 0.2
    for d in (det, det[:0]):
        assert_same(tkitti.recall_counts(d, boxes),
                    jkitti.recall_counts(d, boxes))


def _kitti_annos(rng, n_frames=8):
    gts, dets = [], []
    names = np.asarray(["Car", "Van", "Pedestrian", "DontCare"])
    for _ in range(n_frames):
        m = rng.randint(2, 6)
        boxes = _kitti_gt_lidar(rng, m)
        top = rng.uniform(100, 200, (m, 1))
        h = rng.uniform(15, 80, (m, 1))
        bbox = np.concatenate([rng.uniform(0, 800, (m, 1)), top,
                               rng.uniform(850, 1200, (m, 1)), top + h], 1)
        gts.append({"boxes_lidar": boxes,
                    "name": names[rng.choice(4, m, p=[0.7, 0.1, 0.1, 0.1])],
                    "bbox": bbox.astype(np.float32),
                    "occluded": rng.randint(0, 3, m),
                    "truncated": rng.uniform(0, 0.6, m),
                    "alpha": rng.uniform(-np.pi, np.pi, m)})
        keep = rng.rand(m) < 0.8
        k = int(keep.sum()) + 1
        dboxes = np.concatenate([
            boxes[keep] + rng.randn(k - 1, 7).astype(np.float32) * 0.15,
            _kitti_gt_lidar(rng, 1)])
        dets.append({"boxes_lidar": dboxes.astype(np.float32),
                     "name": np.asarray(["Car"] * (k - 1) + ["Pedestrian"]),
                     "score": rng.rand(k).astype(np.float32),
                     "bbox": np.concatenate([bbox[keep], bbox[:1]]).astype(
                         np.float32) + rng.randn(k, 4).astype(np.float32),
                     "alpha": rng.uniform(-np.pi, np.pi, k)})
    return gts, dets


def test_evaluate_kitti_equals_jax():
    gts, dets = _kitti_annos(np.random.RandomState(3))
    kw = dict(classes=("Car", "Pedestrian"), metrics=("3d", "bev", "bbox"),
              compute_aos=True)
    assert_same(tke.evaluate_kitti(gts, dets, **kw),
                jke.evaluate_kitti(gts, dets, **kw))
    a, b = gts[0]["boxes_lidar"], dets[0]["boxes_lidar"]
    np.testing.assert_array_equal(tke.rotated_iou_bev(a, b),
                                  jke.rotated_iou_bev(a, b))
    np.testing.assert_array_equal(tke.iou_3d_np(a, b), jke.iou_3d_np(a, b))
    scores = np.random.RandomState(4).rand(60)
    np.testing.assert_array_equal(tke.get_thresholds(scores, 45),
                                  jke.get_thresholds(scores, 45))
    assert_same(tke.eval_class(gts, dets, "Car", 1, "bev"),
                jke.eval_class(gts, dets, "Car", 1, "bev"))


def test_kitti_perfect_detection():
    """tests/test_kitti_eval.py::test_perfect_detection_ap_high on the
    port."""
    box = [10.0, 0.0, 0.0, 3.9, 1.6, 1.56, 0.0]
    box2 = [30.0, 5.0, 0.0, 3.9, 1.6, 1.56, 0.5]
    gt = {"boxes_lidar": np.asarray([box, box2], np.float32),
          "name": np.asarray(["Car", "Car"]),
          "bbox": np.tile(np.array([0, 0, 100, 50], np.float32), (2, 1)),
          "occluded": np.zeros(2), "truncated": np.zeros(2)}
    dets = [{"boxes_lidar": np.asarray([box, box2], np.float32),
             "score": np.asarray([0.9 - 0.001 * i, 0.8 - 0.001 * i],
                                 np.float32),
             "name": np.asarray(["Car", "Car"])} for i in range(30)]
    res = tke.evaluate_kitti([gt] * 30, dets)
    assert res["Car"]["3d"][1] > 95.0
    assert res["Car"]["bev"][1] > 95.0


@pytest.mark.parametrize("n", [1, 3, 5, 40])
def test_kitti_perfect_detection_r40_of_few_boxes(n):
    """One frame's n cars as their own detections, all scores distinct:
    precision 1 at recalls 1/n .. n/n, of which R40 samples n - 1, so AP =
    (n - 1) / 40 * 100 in every metric, AOS too (what phase 43 of
    chip_smoke.py checks on its KITTI frame), in both packages."""
    rng = np.random.RandomState(n)
    boxes = _kitti_gt_lidar(rng, n)
    top = rng.uniform(100, 200, (n, 1))
    bbox = np.concatenate([rng.uniform(0, 800, (n, 1)), top,
                           rng.uniform(850, 1200, (n, 1)), top + 50], 1)
    gt = {"boxes_lidar": boxes, "name": np.asarray(["Car"] * n),
          "bbox": bbox.astype(np.float32), "occluded": np.zeros(n),
          "truncated": np.zeros(n), "alpha": np.zeros(n)}
    det = dict(gt, score=np.linspace(0.9, 0.5, n).astype(np.float32))
    kw = dict(classes=("Car",), metrics=("3d", "bev", "bbox"),
              compute_aos=True)
    got = tke.evaluate_kitti([gt], [det], **kw)
    assert_same(got, jke.evaluate_kitti([gt], [det], **kw))
    for m in ("3d", "bev", "bbox", "aos"):
        np.testing.assert_allclose(got["Car"][m], [(n - 1) / 40 * 100] * 3,
                                   rtol=0, atol=1e-9, err_msg=m)


class _Loader(list):
    """(batch, samples) pairs, as the JAX CLI's loader yields them."""


def test_nuscenes_glue_equals_the_jax_loop():
    """An eval step's output dict (tensors) -> the evaluator's frames and
    mAP/NDS, as the JAX CLI's nuScenes loop computes them."""
    rng = np.random.RandomState(5)
    outs, loader = [], _Loader()
    for _ in range(3):
        b, k, m = 2, 12, 6
        gt = np.concatenate([rng.uniform(-40, 40, (b, m, 2)),
                             rng.uniform(-1, 1, (b, m, 1)),
                             rng.uniform(0.5, 5, (b, m, 3)),
                             rng.uniform(-3, 3, (b, m, 3))], -1)
        batch = {"gt_boxes": gt.astype(np.float32),
                 "gt_classes": rng.randint(0, 10, (b, m)).astype(np.int32),
                 "gt_valid": rng.rand(b, m) < 0.8}
        boxes = np.concatenate([gt, gt], 1) + rng.randn(b, k, 9) * 0.3
        out = {"boxes": boxes.astype(np.float32),
               "scores": rng.rand(b, k).astype(np.float32),
               "labels": np.concatenate([batch["gt_classes"]] * 2, 1),
               "valid": rng.rand(b, k) < 0.7}
        outs.append(out)
        loader.append((batch, None))
    it = iter(outs)
    want = _tools_test()._eval_nusc_loop(None, None, None,
                                         lambda state, arrays: next(it),
                                         loader)
    gt_frames, det_frames = [], []
    for out, (batch, _) in zip(outs, loader):
        g, d = nuscenes_records({k: torch.from_numpy(v)
                                 for k, v in out.items()}, batch)
        gt_frames += g
        det_frames += d
    assert_same(nuscenes_metrics(gt_frames, det_frames), want)


def test_kitti_glue_equals_the_jax_loop(tmp_path):
    """An eval step's output (final boxes and Voxel R-CNN's proposals) and
    each sample's calib and raw annotations -> KITTI's APs, AOS and the
    recall records at 0.3, 0.5 and 0.7, as the JAX CLI's KITTI loop."""
    calib = _kitti_calib(tmp_path)
    rng = np.random.RandomState(6)
    outs, loader = [], _Loader()
    for _ in range(3):
        samples, b, f, r = [], 2, 8, 10
        for _ in range(b):
            m = rng.randint(2, 5)
            gt = _kitti_gt_lidar(rng, m)
            rect = jkitti.lidar_to_rect(
                calib, gt[:, :3] - np.asarray([0, 0, 1.0]) * gt[:, 5:6] / 2)
            top = rng.uniform(100, 200, (m, 1))
            samples.append({
                "calib": calib, "image_shape": (375, 1242), "gt_boxes": gt,
                "annos_raw": {
                    "name": np.asarray(["Car"] * (m - 1) + ["Van"]),
                    "location": rect, "dimensions": gt[:, [3, 5, 4]],
                    "rotation_y": -gt[:, 6] - np.pi / 2,
                    "bbox": np.concatenate(
                        [rng.uniform(0, 800, (m, 1)), top,
                         rng.uniform(850, 1200, (m, 1)),
                         top + rng.uniform(20, 80, (m, 1))], 1),
                    "occluded": rng.randint(0, 3, m),
                    "truncated": rng.uniform(0, 0.5, m),
                    "alpha": rng.uniform(-3, 3, m)}})
        gts = [s["gt_boxes"] for s in samples]
        boxes = np.stack([np.concatenate([g, _kitti_gt_lidar(rng, f - len(g))])
                          for g in gts]) + rng.randn(b, f, 7) * 0.2
        rois = np.stack([np.concatenate([g, _kitti_gt_lidar(rng, r - len(g))])
                         for g in gts]) + rng.randn(b, r, 7) * 0.4
        outs.append({"boxes": boxes.astype(np.float32),
                     "scores": rng.rand(b, f).astype(np.float32),
                     "labels": np.zeros((b, f), np.int32),
                     "valid": rng.rand(b, f) < 0.8,
                     "rois": rois.astype(np.float32),
                     "roi_mask": rng.rand(b, r) < 0.9})
        loader.append(({}, samples))

    class Dataset:
        class_names = ("Car",)

    it = iter(outs)
    want = _tools_test()._eval_kitti_loop(None, None, None,
                                          lambda state, arrays: next(it),
                                          loader, Dataset, "voxel_rcnn")
    recall, gt_annos, det_annos = {}, [], []
    for out, (_, samples) in zip(outs, loader):
        g, d = kitti_records({k: torch.from_numpy(v) for k, v in out.items()},
                             samples, Dataset.class_names, recall)
        gt_annos += g
        det_annos += d
    got = kitti_metrics(gt_annos, det_annos, recall, Dataset.class_names)
    assert {"roi_recall_0.3", "final_recall_0.7"} <= set(got)
    assert_same(got, want)
