"""nuScenes detection metric (mAP / NDS), host-side numpy (port of
df3d/data/nuscenes_eval.py, the JAX package's reimplementation of the
nuscenes-devkit evaluation the reference calls,
CenterPoint/det3d/datasets/nuscenes/nuscenes.py:203-310 `eval_main`):

  * per-class ego-distance range filtering of BOTH gts and dets,
  * greedy center-distance matching in GLOBAL descending-score order at
    thresholds {0.5, 1, 2, 4} m (match state per frame),
  * AP = normalized area of the (precision - 0.1)+ region over recall
    in (0.1, 1], sampled at 101 recall points, NO monotonic envelope,
  * TP errors (ATE/ASE/AOE/AVE/AAE) at the 2 m threshold as
    cumulative means over TPs interpolated onto the confidence curve,
    averaged over recall in [0.1, max_achieved_recall],
  * class/metric exclusions (cones: no AOE; cones+barriers: no AVE/AAE;
    barrier AOE period pi) via NaN + nanmean,
  * NDS = (5*mAP + sum(1 - min(1, err))) / 10.

Attributes: pass 'attrs' (int codes, -1 = void) in the frame dicts to get
real AAE; without them attr_err is NaN per class and NDS grants NO
attribute credit (err treated as 1), never full credit.

`NUSC_CLASSES` is the detection class order (df3d/data/nuscenes.py:17):
label i of a detector is NUSC_CLASSES[i].
"""

from __future__ import annotations

import numpy as np

DIST_THRESHOLDS = (0.5, 1.0, 2.0, 4.0)
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")
# classes where some TP metrics are not defined (devkit convention)
NO_VEL_CLASSES = {"barrier", "traffic_cone"}
NO_ORIENT_CLASSES = {"traffic_cone"}
NO_ATTR_CLASSES = {"barrier", "traffic_cone"}
# devkit detection_cvpr_2019 class_range (ego-distance metres)
CLASS_RANGE = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}
MAX_BOXES_PER_SAMPLE = 500
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
N_REC_PTS = 101

NUSC_CLASSES = (
    "car", "truck", "construction_vehicle", "bus", "trailer", "barrier",
    "motorcycle", "bicycle", "pedestrian", "traffic_cone",
)


def _scale_iou(det, gt):
    """Aligned 3D IoU of sizes only (devkit scale_iou)."""
    mins = np.minimum(det[3:6], gt[3:6])
    inter = mins.prod()
    union = det[3:6].prod() + gt[3:6].prod() - inter
    return inter / max(union, 1e-9)


def _yaw_diff(a, b, period=2 * np.pi):
    d = (a - b) % period
    return min(d, period - d)


def _cummean(x):
    if len(x) == 0:
        return np.zeros(0)
    return np.cumsum(x) / (np.arange(len(x)) + 1)


def _filter_range(boxes, names, rng_of):
    if len(boxes) == 0:
        return np.ones(0, bool)
    dist = np.linalg.norm(boxes[:, :2], axis=-1)
    maxd = np.array([rng_of(n) for n in names])
    return dist < maxd


def accumulate_class(gt_by_frame, det_by_frame, cls: str, dist_th: float):
    """One (class, distance-threshold) accumulation (devkit algo.accumulate).

    gt_by_frame / det_by_frame: lists per frame of dicts with
    'boxes' (N, >=7|9) [x,y,z,dx,dy,dz,yaw(,vx,vy)], 'names' (N,), det also
    'scores'; optional 'attrs' (N,) int codes (-1 = void).
    Returns dict(ap, tp_errors, npos).
    """
    rng_of = lambda n: CLASS_RANGE.get(n, 50.0)

    # collect per-frame filtered gt, and all dets of the class globally
    gts = []
    npos = 0
    det_rows = []  # (score, frame_idx, box, attr)
    for fi, (gt, det) in enumerate(zip(gt_by_frame, det_by_frame)):
        g_keep = (gt["names"] == cls) & _filter_range(
            gt["boxes"], gt["names"], rng_of)
        g_boxes = gt["boxes"][g_keep]
        g_attrs = (
            np.asarray(gt["attrs"])[g_keep] if "attrs" in gt
            else np.full(len(g_boxes), -1)
        )
        gts.append((g_boxes, g_attrs, np.zeros(len(g_boxes), bool)))
        npos += len(g_boxes)

        d_keep = (det["names"] == cls) & _filter_range(
            det["boxes"], det["names"], rng_of)
        # devkit caps detections per sample (assert <= 500); keep top-scored
        d_idx = np.flatnonzero(d_keep)
        if len(d_idx) > MAX_BOXES_PER_SAMPLE:
            top = np.argsort(-det["scores"][d_idx])[:MAX_BOXES_PER_SAMPLE]
            d_idx = d_idx[top]
        for i in d_idx:
            attr = det["attrs"][i] if "attrs" in det else -1
            det_rows.append((float(det["scores"][i]), fi, det["boxes"][i], attr))

    if npos == 0:
        return {"ap": np.nan, "tp_errors": {m: np.nan for m in TP_METRICS},
                "npos": 0}

    # global greedy matching in descending score order
    det_rows.sort(key=lambda r: -r[0])
    tp, fp, conf = [], [], []
    match = {m: [] for m in TP_METRICS}
    match_conf = []
    for score, fi, d, d_attr in det_rows:
        g_boxes, g_attrs, taken = gts[fi]
        best_j, best_d = -1, dist_th
        for j in range(len(g_boxes)):
            if not taken[j]:
                dd = np.hypot(d[0] - g_boxes[j, 0], d[1] - g_boxes[j, 1])
                if dd < best_d:
                    best_d, best_j = dd, j
        conf.append(score)
        if best_j < 0:
            tp.append(0)
            fp.append(1)
            continue
        taken[best_j] = True
        tp.append(1)
        fp.append(0)
        g = g_boxes[best_j]
        match["trans_err"].append(best_d)
        match["scale_err"].append(1 - _scale_iou(d, g))
        period = np.pi if cls == "barrier" else 2 * np.pi
        match["orient_err"].append(
            np.nan if cls in NO_ORIENT_CLASSES
            else _yaw_diff(d[6], g[6], period))
        match["vel_err"].append(
            np.nan if cls in NO_VEL_CLASSES or len(d) < 9
            else float(np.linalg.norm(np.asarray(d[7:9]) - g[7:9])))
        ga = g_attrs[best_j]
        match["attr_err"].append(
            np.nan if cls in NO_ATTR_CLASSES or ga < 0 or d_attr < 0
            else float(ga != d_attr))
        match_conf.append(score)

    tp = np.cumsum(tp).astype(float)
    fp = np.cumsum(fp).astype(float)
    conf = np.asarray(conf)
    rec_interp = np.linspace(0, 1, N_REC_PTS)
    if len(conf) == 0:
        precision = np.zeros(N_REC_PTS)
        confidence = np.zeros(N_REC_PTS)
    else:
        prec = tp / np.maximum(fp + tp, 1e-9)
        rec = tp / npos
        precision = np.interp(rec_interp, rec, prec, right=0)
        confidence = np.interp(rec_interp, rec, conf, right=0)

    # AP (devkit calc_ap): clip min recall/precision 0.1, renormalize
    p = precision[round(100 * MIN_RECALL) + 1:].copy()
    p -= MIN_PRECISION
    p[p < 0] = 0
    ap = float(np.mean(p) / (1 - MIN_PRECISION))

    # TP error curves: cumulative mean over TPs (by confidence),
    # interpolated onto the confidence curve; averaged over recall in
    # [min_recall, max achieved recall] (devkit calc_tp)
    nz = np.nonzero(confidence)[0]
    last_ind = nz[-1] if len(nz) else 0
    first_ind = round(100 * MIN_RECALL) + 1
    errs = {}
    for m in TP_METRICS:
        vals = np.asarray(match[m], float)
        defined = ~np.isnan(vals)
        if last_ind < first_ind:
            errs[m] = 1.0
        elif not defined.any():
            errs[m] = np.nan
        else:
            mc = np.asarray(match_conf)[defined]
            tmp = _cummean(vals[defined])
            curve = np.interp(
                confidence[::-1], mc[::-1], tmp[::-1])[::-1]
            errs[m] = float(np.mean(curve[first_ind:last_ind + 1]))
    return {"ap": ap, "tp_errors": errs, "npos": npos}


def evaluate_nuscenes(gt_by_frame, det_by_frame, classes):
    """-> dict with per-class AP per threshold, mAP, tp errors, NDS.

    Classes with no ground truth anywhere are excluded from the means
    (devkit NaN behavior). Without attribute inputs, AAE is NaN and NDS
    gives zero (not full) attribute credit.
    """
    per_class = {}
    for cls in classes:
        aps = []
        tp_errors = None
        npos = 0
        for th in DIST_THRESHOLDS:
            res = accumulate_class(gt_by_frame, det_by_frame, cls, th)
            aps.append(res["ap"])
            npos = res["npos"]
            if th == 2.0:
                tp_errors = res["tp_errors"]
        per_class[cls] = {
            "ap": float(np.mean(aps)) if npos else np.nan,
            "tp_errors": tp_errors,
            "npos": npos,
        }

    with np.errstate(invalid="ignore"):
        ap_vals = np.asarray([v["ap"] for v in per_class.values()], float)
        mean_ap = float(np.nanmean(ap_vals)) if not np.all(
            np.isnan(ap_vals)) else 0.0
        mean_tp = {}
        for m in TP_METRICS:
            vals = np.asarray(
                [v["tp_errors"][m] for v in per_class.values()], float)
            mean_tp[m] = (
                float(np.nanmean(vals)) if not np.all(np.isnan(vals))
                else np.nan
            )
    # NaN mean err (e.g. attributes not modeled) -> zero credit, never full
    nds = (
        5 * mean_ap
        + sum(
            0.0 if np.isnan(mean_tp[m]) else 1 - min(1.0, mean_tp[m])
            for m in TP_METRICS
        )
    ) / 10.0
    return {
        "per_class": per_class, "mAP": mean_ap, "tp_errors": mean_tp,
        "NDS": float(nds),
    }
