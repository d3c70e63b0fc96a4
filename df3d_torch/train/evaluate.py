"""The evaluation loop's glue (port of the loop bodies of the JAX
package's tools/test.py:169-265): an eval step's detections -> the
per-frame records of the nuScenes and KITTI evaluators, and the metrics.

nuScenes: `nuscenes_records(out, batch)` per batch, then
`nuscenes_metrics(gt_frames, det_frames)` -> mAP, NDS and the detail.
KITTI: `kitti_records(out, samples, class_names, recall)` per batch (the
annotations of each frame and pcdet's recall records at IoU 0.3, 0.5 and
0.7, of the final boxes and, from `rois`/`roi_mask`, of the proposals),
then `kitti_metrics(gt_annos, det_annos, recall, class_names)` -> 3D, BEV
and 2D AP per class and difficulty, AOS and the recall rates.
"""

from __future__ import annotations

import numpy as np
import torch

from df3d_torch.data.kitti import (
    camera_box_to_lidar, lidar_boxes_to_kitti_annos, recall_counts,
)
from df3d_torch.data.kitti_eval import evaluate_kitti
from df3d_torch.data.nuscenes_eval import NUSC_CLASSES, evaluate_nuscenes


def _numpy(tree: dict) -> dict:
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor)
            else np.asarray(v) for k, v in tree.items()}


def nuscenes_records(out: dict, batch: dict) -> tuple[list, list]:
    """An eval step's detections (boxes (B, K, 9), scores, labels, valid)
    and the batch's gt_boxes (B, M, 9), gt_classes and gt_valid -> (gt
    frames, detection frames) of `evaluate_nuscenes`, one per sample."""
    out, batch = _numpy(out), _numpy(batch)
    names = np.asarray(NUSC_CLASSES)
    gt_frames, det_frames = [], []
    for i in range(out["boxes"].shape[0]):
        v = out["valid"][i]
        det_frames.append({"boxes": out["boxes"][i][v],
                           "scores": out["scores"][i][v],
                           "names": names[out["labels"][i][v]]})
        gv = batch["gt_valid"][i]
        gt_frames.append({"boxes": batch["gt_boxes"][i][gv],
                          "names": names[batch["gt_classes"][i][gv]]})
    return gt_frames, det_frames


def nuscenes_metrics(gt_frames: list, det_frames: list) -> dict:
    m = evaluate_nuscenes(gt_frames, det_frames, NUSC_CLASSES)
    return {"mAP": m["mAP"], "NDS": m["NDS"], "detail": m}


def kitti_records(out: dict, samples: list, class_names,
                  recall: dict) -> tuple[list, list]:
    """An eval step's detections (boxes (B, F, 7+), scores, labels, valid;
    Voxel R-CNN's `rois` and `roi_mask` too) and each sample's dict (calib,
    image_shape, annos_raw: KITTI's name, bbox, occluded, truncated, alpha,
    location, dimensions, rotation_y; gt_boxes: lidar 7-dof) -> (gt annos,
    det annos) of `evaluate_kitti`; the recall counts are added into
    `recall` (pcdet's generate_recall_record)."""
    out = _numpy(out)
    gt_annos, det_annos = [], []
    for i, s in enumerate(samples):
        v = out["valid"][i]
        final = out["boxes"][i][v][:, :7]
        det_annos.append(lidar_boxes_to_kitti_annos(
            final, out["scores"][i][v], out["labels"][i][v], s["calib"],
            s["image_shape"], class_names))

        # gt annos from the raw KITTI fields, with lidar-frame boxes for
        # the 3D and BEV overlaps
        raw = s.get("annos_raw", {})
        names = np.asarray(raw.get("name", np.zeros((0,), "<U32")))
        n = len(names)
        cam = (np.concatenate([raw["location"], raw["dimensions"],
                               raw["rotation_y"][..., None]], axis=1)
               if n else np.zeros((0, 7), np.float32))
        gt_annos.append({
            "name": names,
            "bbox": np.asarray(raw.get("bbox", np.zeros((0, 4)))),
            "occluded": np.asarray(raw.get("occluded", np.zeros(n))),
            "truncated": np.asarray(raw.get("truncated", np.zeros(n))),
            "alpha": np.asarray(raw.get("alpha", np.zeros(n))),
            "boxes_lidar": (camera_box_to_lidar(cam, s["calib"]) if n
                            else np.zeros((0, 7), np.float32)),
        })

        gt_lidar = s.get("gt_boxes", np.zeros((0, 7), np.float32))
        stages = {"final": final}
        if "rois" in out:
            stages["roi"] = out["rois"][i][out["roi_mask"][i]]
        for stage, boxes in stages.items():
            for key, count in recall_counts(boxes, gt_lidar).items():
                if key == "gt":
                    if stage != "final":
                        continue
                else:
                    key = f"{stage}_{key}"
                recall[key] = recall.get(key, 0) + count
    return gt_annos, det_annos


def kitti_metrics(gt_annos: list, det_annos: list, recall: dict,
                  class_names) -> dict:
    """{class}_{3d,bev,bbox,aos}_{easy,moderate,hard} APs, the recall rates
    (each recall count over the gt count) and the evaluator's detail."""
    res = evaluate_kitti(gt_annos, det_annos, classes=tuple(class_names),
                         metrics=("3d", "bev", "bbox"), compute_aos=True)
    flat = {}
    for cls, per in res.items():
        for metric, aps in per.items():
            for d, name in enumerate(("easy", "moderate", "hard")):
                flat[f"{cls}_{metric}_{name}"] = aps[d]
    ngt = max(recall.get("gt", 0), 1)
    for k, v in recall.items():
        if k != "gt":
            flat[k] = v / ngt
    flat["detail"] = res
    return flat
