"""KITTI official-style evaluation (R40 AP), host-side numpy (port of
df3d/data/kitti_eval.py, the JAX package's equivalent of
VoxelRCNN/pcdet/datasets/kitti/kitti_object_eval_python/{eval.py,
rotate_iou.py} with a numpy polygon clip for the rotated IoU). The full
official protocol:
  * difficulty buckets (gt bbox height / occlusion / truncation),
  * ignored-gt handling (difficulty fail or neighboring class),
  * det-side ignoring (2D bbox height below the difficulty minimum),
  * DontCare-region suppression of unmatched dets (2D bbox metric),
  * official get_thresholds recall-point selection,
  * two-pass matching: pass 1 (threshold collection) picks the
    HIGHEST-SCORE det over min_overlap; pass 2 (precision) picks the
    MAX-OVERLAP non-ignored det,
  * metrics: 3D AP / BEV AP / 2D bbox AP per class/difficulty.
"""

from __future__ import annotations

import numpy as np

DIFFICULTY = {  # min bbox height px, max occlusion, max truncation
    0: (40, 0, 0.15),
    1: (25, 1, 0.30),
    2: (25, 2, 0.50),
}
MIN_OVERLAP = {"Car": 0.7, "Pedestrian": 0.5, "Cyclist": 0.5}
NEIGHBOR_CLASSES = {"Car": ("Van",), "Pedestrian": ("Person_sitting",)}
N_SAMPLE_PTS = 41
_NO_DET = -(10 ** 7)


def _rect_corners(boxes):
    signs = np.array([[1, 1], [-1, 1], [-1, -1], [1, -1]], np.float32)
    local = 0.5 * signs[None] * boxes[:, None, 3:5]
    c, s = np.cos(boxes[:, 6]), np.sin(boxes[:, 6])
    x = local[..., 0] * c[:, None] - local[..., 1] * s[:, None]
    y = local[..., 0] * s[:, None] + local[..., 1] * c[:, None]
    return np.stack([x, y], -1) + boxes[:, None, :2]


def _clip_poly(poly, a, b):
    out = []
    n = len(poly)
    d = b - a
    for i in range(n):
        cur, nxt = poly[i], poly[(i + 1) % n]
        sc = d[0] * (cur[1] - a[1]) - d[1] * (cur[0] - a[0])
        sn = d[0] * (nxt[1] - a[1]) - d[1] * (nxt[0] - a[0])
        if sc >= 0:
            out.append(cur)
        if (sc >= 0) != (sn >= 0):
            t = sc / (sc - sn + 1e-12)
            out.append(cur + t * (nxt - cur))
    return np.asarray(out)


def _poly_area(poly):
    if len(poly) < 3:
        return 0.0
    x, y = poly[:, 0], poly[:, 1]
    return 0.5 * abs(np.dot(x, np.roll(y, -1)) - np.dot(y, np.roll(x, -1)))


def rotated_iou_bev(boxes_a, boxes_b):
    """(N, 7) x (M, 7) -> (N, M) rotated BEV IoU (numpy)."""
    ca, cb = _rect_corners(boxes_a), _rect_corners(boxes_b)
    out = np.zeros((len(boxes_a), len(boxes_b)), np.float32)
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    for i in range(len(boxes_a)):
        for j in range(len(boxes_b)):
            poly = ca[i]
            for k in range(4):
                poly = _clip_poly(poly, cb[j][k], cb[j][(k + 1) % 4])
                if len(poly) == 0:
                    break
            inter = _poly_area(poly) if len(poly) >= 3 else 0.0
            union = area_a[i] + area_b[j] - inter
            out[i, j] = inter / max(union, 1e-9)
    return out


def iou_3d_np(boxes_a, boxes_b):
    bev = rotated_iou_bev(boxes_a, boxes_b)
    za1 = boxes_a[:, 2] - boxes_a[:, 5] / 2
    za2 = boxes_a[:, 2] + boxes_a[:, 5] / 2
    zb1 = boxes_b[:, 2] - boxes_b[:, 5] / 2
    zb2 = boxes_b[:, 2] + boxes_b[:, 5] / 2
    zo = np.maximum(
        np.minimum(za2[:, None], zb2[None]) - np.maximum(za1[:, None], zb1[None]),
        0.0,
    )
    area_a = boxes_a[:, 3] * boxes_a[:, 4]
    area_b = boxes_b[:, 3] * boxes_b[:, 4]
    # bev holds IoU; recover intersection area: I = iou*(A+B)/(1+iou)
    inter_area = bev * (area_a[:, None] + area_b[None]) / (1 + bev)
    inter_vol = inter_area * zo
    vol_a = area_a * boxes_a[:, 5]
    vol_b = area_b * boxes_b[:, 5]
    return inter_vol / np.maximum(vol_a[:, None] + vol_b[None] - inter_vol, 1e-9)


def image_box_overlap(boxes, qboxes, criterion=-1):
    """Axis-aligned 2D bbox overlap; criterion 0 normalizes by the det area
    (the official DontCare test)."""
    n, k = len(boxes), len(qboxes)
    out = np.zeros((n, k), np.float32)
    for j in range(k):
        qarea = (qboxes[j][2] - qboxes[j][0]) * (qboxes[j][3] - qboxes[j][1])
        for i in range(n):
            iw = min(boxes[i][2], qboxes[j][2]) - max(boxes[i][0], qboxes[j][0])
            ih = min(boxes[i][3], qboxes[j][3]) - max(boxes[i][1], qboxes[j][1])
            if iw <= 0 or ih <= 0:
                continue
            darea = (boxes[i][2] - boxes[i][0]) * (boxes[i][3] - boxes[i][1])
            if criterion == -1:
                ua = darea + qarea - iw * ih
            elif criterion == 0:
                ua = darea
            else:
                ua = qarea
            out[i, j] = iw * ih / max(ua, 1e-9)
    return out


def clean_frame(gt, det, cls: str, difficulty: int):
    """Official clean_data: per-frame gt status, det status, DontCare boxes.

    status codes: 0 = evaluate, 1 = ignore (matching is neutral),
    -1 = skip entirely (other class).
    gt ignore: difficulty fail (height <= min_h strict, per the official
    code) or neighboring class; det ignore: 2D bbox height < min_h.
    """
    min_h, max_occ, max_trunc = DIFFICULTY[difficulty]
    ng = len(gt["name"])
    gt_status = np.full(ng, -1, np.int32)
    num_valid_gt = 0
    dc_bboxes = []
    occ = gt.get("occluded", np.zeros(ng))
    trunc = gt.get("truncated", np.zeros(ng))
    for i, name in enumerate(gt["name"]):
        h = gt["bbox"][i][3] - gt["bbox"][i][1] if "bbox" in gt else 1e9
        if name == cls:
            valid = 1
        elif name in NEIGHBOR_CLASSES.get(cls, ()):
            valid = 0
        else:
            valid = -1
        ignore = occ[i] > max_occ or trunc[i] > max_trunc or h <= min_h
        if valid == 1 and not ignore:
            gt_status[i] = 0
            num_valid_gt += 1
        elif valid == 0 or (ignore and valid == 1):
            gt_status[i] = 1
        if name == "DontCare" and "bbox" in gt:
            dc_bboxes.append(gt["bbox"][i])

    nd = len(det["name"]) if "name" in det else len(det["boxes_lidar"])
    det_status = np.full(nd, -1, np.int32)
    for j in range(nd):
        is_cls = det["name"][j] == cls if "name" in det else True
        h = (
            abs(det["bbox"][j][3] - det["bbox"][j][1])
            if "bbox" in det
            else 1e9
        )
        if h < min_h:
            det_status[j] = 1
        elif is_cls:
            det_status[j] = 0
    return gt_status, det_status, dc_bboxes, num_valid_gt


def compute_statistics(
    overlaps, det_scores, gt_status, det_status, dc_overlaps,
    min_overlap, thresh, compute_fp, gt_alphas=None, det_alphas=None,
):
    """Official compute_statistics_jit semantics, including AOS.

    overlaps (nd, ng); dc_overlaps (nd, n_dc) criterion-0 image overlap of
    dets vs DontCare regions, or None (non-bbox metrics). gt_alphas (ng,) /
    det_alphas (nd,) observation angles enable orientation similarity
    accumulation (eval.py:168 compute_aos): each TP contributes
    (1 + cos(gt_alpha - det_alpha)) / 2.
    Returns (tp, fp, fn, tp_scores, similarity).
    """
    nd, ng = overlaps.shape
    assigned = np.zeros(nd, bool)
    ignored_threshold = (
        det_scores < thresh if compute_fp else np.zeros(nd, bool)
    )
    tp = fp = fn = 0
    similarity = 0.0
    tp_scores = []
    for i in range(ng):
        if gt_status[i] == -1:
            continue
        det_idx = -1
        valid_detection = _NO_DET
        max_overlap = 0.0
        assigned_ignored_det = False
        for j in range(nd):
            if det_status[j] == -1 or assigned[j] or ignored_threshold[j]:
                continue
            overlap = overlaps[j, i]
            if not compute_fp:
                # pass 1: highest-score det over min_overlap
                if overlap > min_overlap and det_scores[j] > valid_detection:
                    det_idx = j
                    valid_detection = det_scores[j]
            elif (overlap > min_overlap
                  and (overlap > max_overlap or assigned_ignored_det)
                  and det_status[j] == 0):
                # pass 2: max-overlap non-ignored det wins
                max_overlap = overlap
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = False
            elif (overlap > min_overlap and valid_detection == _NO_DET
                  and det_status[j] == 1):
                det_idx = j
                valid_detection = 1
                assigned_ignored_det = True
        if valid_detection == _NO_DET and gt_status[i] == 0:
            fn += 1
        elif valid_detection != _NO_DET and (
            gt_status[i] == 1 or det_status[det_idx] == 1
        ):
            assigned[det_idx] = True
        elif valid_detection != _NO_DET:
            tp += 1
            tp_scores.append(det_scores[det_idx])
            if gt_alphas is not None and det_alphas is not None:
                similarity += (
                    1.0 + np.cos(gt_alphas[i] - det_alphas[det_idx])
                ) / 2.0
            assigned[det_idx] = True
    if compute_fp:
        for j in range(nd):
            if not (assigned[j] or det_status[j] != 0 or ignored_threshold[j]):
                fp += 1
        if dc_overlaps is not None and dc_overlaps.shape[1]:
            nstuff = 0
            for k in range(dc_overlaps.shape[1]):
                for j in range(nd):
                    if assigned[j] or det_status[j] != 0 or ignored_threshold[j]:
                        continue
                    if dc_overlaps[j, k] > min_overlap:
                        assigned[j] = True
                        nstuff += 1
            fp -= nstuff
    return tp, fp, fn, tp_scores, similarity


def get_thresholds(scores, num_gt, num_sample_pts=N_SAMPLE_PTS):
    """Official recall-point score thresholds (eval.py get_thresholds)."""
    scores = np.sort(scores)[::-1]
    current_recall = 0.0
    thresholds = []
    for i, score in enumerate(scores):
        l_recall = (i + 1) / num_gt
        r_recall = (i + 2) / num_gt if i < len(scores) - 1 else l_recall
        if ((r_recall - current_recall) < (current_recall - l_recall)
                and i < len(scores) - 1):
            continue
        thresholds.append(score)
        current_recall += 1.0 / (num_sample_pts - 1.0)
    return thresholds


def _frame_overlaps(gt, det, metric):
    """All dets vs all gts (the official code never slices by class: other-
    class dets carry status -1/1 and flow through the matching logic)."""
    if metric == "bbox":
        det_boxes = np.asarray(det["bbox"])
        gt_boxes = np.asarray(gt["bbox"])
    else:
        det_boxes = det["boxes_lidar"]
        gt_boxes = gt["boxes_lidar"]
    if not (len(det_boxes) and len(gt_boxes)):
        return np.zeros((len(det_boxes), len(gt_boxes)), np.float32)
    if metric == "bbox":
        return image_box_overlap(det_boxes, gt_boxes)
    fn = iou_3d_np if metric == "3d" else rotated_iou_bev
    return fn(det_boxes, gt_boxes)


def eval_class(gt_annos, det_annos, cls: str, difficulty: int,
               metric: str = "3d", compute_aos: bool = False):
    """-> dict(ap=R40 AP %, precision curve, recall thresholds[, aos]).

    compute_aos (bbox metric only, both annos carrying 'alpha') adds the
    official orientation-similarity average (eval.py:168,237)."""
    min_ov = MIN_OVERLAP[cls]
    compute_aos = (
        compute_aos and metric == "bbox"
        and all("alpha" in a for a in gt_annos)
        and all("alpha" in a for a in det_annos)
    )
    frames = []
    total_valid_gt = 0
    for gt, det in zip(gt_annos, det_annos):
        gt_status, det_status, dc_bboxes, nvalid = clean_frame(
            gt, det, cls, difficulty
        )
        overlaps = _frame_overlaps(gt, det, metric)
        dc_ov = None
        if metric == "bbox" and "bbox" in det and len(dc_bboxes):
            dc_ov = image_box_overlap(
                np.asarray(det["bbox"]), np.asarray(dc_bboxes), criterion=0,
            )
        det_scores = np.asarray(det["score"])
        alphas = (
            (np.asarray(gt["alpha"]), np.asarray(det["alpha"]))
            if compute_aos else (None, None)
        )
        frames.append(
            (overlaps, det_scores, gt_status, det_status, dc_ov, alphas))
        total_valid_gt += nvalid

    if total_valid_gt == 0:
        out = {"ap": 0.0, "precision": np.zeros(N_SAMPLE_PTS), "thresholds": []}
        if compute_aos:
            out["aos"] = 0.0
        return out

    # pass 1: collect TP scores with no threshold
    tp_scores = []
    for overlaps, sc, gst, dst, _, _ in frames:
        _, _, _, tps, _ = compute_statistics(
            overlaps, sc, gst, dst, None, min_ov, 0.0, compute_fp=False
        )
        tp_scores.extend(tps)
    thresholds = get_thresholds(np.asarray(tp_scores), total_valid_gt)

    precision = np.zeros(N_SAMPLE_PTS)
    orientation = np.zeros(N_SAMPLE_PTS)
    for ti, th in enumerate(thresholds):
        tp = fp = fn = 0
        sim = 0.0
        for overlaps, sc, gst, dst, dc_ov, (ga, da) in frames:
            t, f, n, _, s = compute_statistics(
                overlaps, sc, gst, dst, dc_ov, min_ov, th, compute_fp=True,
                gt_alphas=ga, det_alphas=da,
            )
            tp += t
            fp += f
            fn += n
            sim += s
        precision[ti] = tp / max(tp + fp, 1)
        orientation[ti] = sim / max(tp + fp, 1)
    # right-max smoothing
    for i in range(N_SAMPLE_PTS - 2, -1, -1):
        precision[i] = max(precision[i], precision[i + 1])
        orientation[i] = max(orientation[i], orientation[i + 1])

    # R40: average precision at 40 points (skip the first)
    ap = precision[1:].sum() / 40.0 * 100.0
    out = {"ap": ap, "precision": precision, "thresholds": thresholds}
    if compute_aos:
        out["aos"] = orientation[1:].sum() / 40.0 * 100.0
    return out


def evaluate_kitti(gt_annos, det_annos, classes=("Car",),
                   metrics=("3d", "bev"), compute_aos: bool = False):
    """-> {class: {metric: [AP easy, AP moderate, AP hard]}}; with
    compute_aos and a 'bbox' metric, adds an 'aos' entry per class."""
    out = {}
    for cls in classes:
        out[cls] = {}
        for metric in metrics:
            res = [
                eval_class(gt_annos, det_annos, cls, d, metric,
                           compute_aos=compute_aos)
                for d in (0, 1, 2)
            ]
            out[cls][metric] = [r["ap"] for r in res]
            if compute_aos and metric == "bbox" and "aos" in res[0]:
                out[cls]["aos"] = [r["aos"] for r in res]
    return out
