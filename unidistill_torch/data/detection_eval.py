"""Native nuScenes detection evaluation (detection_cvpr_2019) — no devkit;
the port's copy of the JAX package's `data/detection_eval.py`.

The reference scores via `nuscenes.eval.detection.evaluate.DetectionEval`
(ref unidistill/data/multisensorfusion/evaluate.py:87-117), which needs the
nuscenes-devkit plus a live `NuScenes` object. This module re-implements the
`detection_cvpr_2019` protocol in pure numpy so mAP/NDS can be computed
anywhere the info pkls exist:

  * class-range + zero-point GT filtering (devkit `filter_eval_boxes`),
  * greedy center-distance matching at thresholds {0.5, 1, 2, 4} m
    (devkit `accumulate`), 101-point precision/recall interpolation,
  * AP with min-recall/min-precision clamping (devkit `calc_ap`),
  * TP errors ATE/ASE/AOE/AVE/AAE at 2 m with per-class exclusions
    (devkit `calc_tp` + the traffic_cone/barrier rules),
  * NDS = (5·mAP + Σ (1 − min(1, err))) / 10.

Inputs are the submission dict this repo already writes
(`evaluate.generate_submission`) and GT boxes derived from the info pkls
(`gt_from_infos` — same lidar→global transform as the submission writer).

Known deviation from the devkit: the "bicycles on bike racks" GT removal
(devkit filter_eval_boxes step 3) needs the map/bike-rack records, which the
info pkls do not carry; it is skipped. Everything else follows the devkit
algorithm function-for-function (the JAX package's hand-computed scenarios
in tests/test_detection_eval.py; tests/test_torch_data.py holds this copy
to the JAX scorer on them).
"""
from __future__ import annotations

import json
import math
from typing import Dict, List, Optional, Sequence

import numpy as np

from unidistill_torch.configs.nuscenes import CLASS_NAMES

# detection_cvpr_2019 constants (devkit nuscenes/eval/detection/configs/)
CLASS_RANGE = {
    "car": 50.0, "truck": 50.0, "bus": 50.0, "trailer": 50.0,
    "construction_vehicle": 50.0, "pedestrian": 40.0, "motorcycle": 40.0,
    "bicycle": 40.0, "traffic_cone": 30.0, "barrier": 30.0,
}
DIST_THS = (0.5, 1.0, 2.0, 4.0)
DIST_TH_TP = 2.0
MIN_RECALL = 0.1
MIN_PRECISION = 0.1
MAX_BOXES_PER_SAMPLE = 500
MEAN_AP_WEIGHT = 5
TP_METRICS = ("trans_err", "scale_err", "orient_err", "vel_err", "attr_err")
# devkit algo.py: metrics that are undefined for a class read as NaN
TP_EXCLUDE = {
    "traffic_cone": ("attr_err", "vel_err", "orient_err"),
    "barrier": ("attr_err", "vel_err"),
}
_NELEM = 101  # recall bins


def quaternion_yaw(q: Sequence[float]) -> float:
    """Yaw of a [w, x, y, z] quaternion: heading of the rotated x-axis in
    the xy plane (devkit `quaternion_yaw`)."""
    w, x, y, z = q
    # rotated x-axis = R @ [1, 0, 0]
    vx = 1.0 - 2.0 * (y * y + z * z)
    vy = 2.0 * (x * y + z * w)
    return math.atan2(vy, vx)


def _angle_diff(a: float, b: float, period: float) -> float:
    d = (a - b + period / 2.0) % period - period / 2.0
    return abs(d)


def _scale_iou(size_gt, size_pr) -> float:
    """Aligned 3D IoU of two sizes (same center/orientation)."""
    sa, sb = np.asarray(size_gt, float), np.asarray(size_pr, float)
    if np.any(sa <= 0) or np.any(sb <= 0):
        raise ValueError(f"non-positive box size: {sa} {sb}")
    inter = float(np.prod(np.minimum(sa, sb)))
    union = float(np.prod(sa)) + float(np.prod(sb)) - inter
    return inter / union


def _cummean(x: np.ndarray) -> np.ndarray:
    """Cumulative mean that skips NaN entries (devkit `cummean`)."""
    if np.all(np.isnan(x)):
        return np.ones(len(x))
    s = np.nancumsum(x.astype(float))
    cnt = np.cumsum(~np.isnan(x))
    return np.divide(s, cnt, out=np.zeros_like(s), where=cnt > 0)


class MetricData:
    """101-point curves of one (class, dist_th) accumulation."""

    def __init__(self, recall, precision, confidence, trans_err, vel_err,
                 scale_err, orient_err, attr_err):
        self.recall = recall
        self.precision = precision
        self.confidence = confidence
        self.trans_err = trans_err
        self.vel_err = vel_err
        self.scale_err = scale_err
        self.orient_err = orient_err
        self.attr_err = attr_err

    @property
    def max_recall_ind(self) -> int:
        nz = np.nonzero(self.confidence)[0]
        return int(nz[-1]) if len(nz) else 0

    @classmethod
    def no_predictions(cls):
        z, o = np.zeros(_NELEM), np.ones(_NELEM)
        return cls(np.linspace(0, 1, _NELEM), z.copy(), z.copy(),
                   o.copy(), o.copy(), o.copy(), o.copy(), o.copy())


def filter_eval_boxes(
    boxes_by_token: Dict[str, List[dict]],
    ego_xy_by_token: Dict[str, np.ndarray],
    is_gt: bool,
) -> Dict[str, List[dict]]:
    """Class-range filter (ego-centered xy distance) + zero-lidar/radar-point
    GT removal (devkit `filter_eval_boxes` steps 1-2; the bike-rack step
    needs map records absent from the info pkls — documented deviation)."""
    out = {}
    for token, boxes in boxes_by_token.items():
        ego = np.asarray(ego_xy_by_token[token], float)[:2]
        kept = []
        for b in boxes:
            rng = CLASS_RANGE[b["detection_name"]]
            d = float(np.linalg.norm(np.asarray(b["translation"][:2]) - ego))
            if d >= rng:
                continue
            if is_gt and b.get("num_pts", -1) == 0:
                continue
            kept.append(b)
        out[token] = kept
    return out


def accumulate(
    gt_by_token: Dict[str, List[dict]],
    pred_by_token: Dict[str, List[dict]],
    class_name: str,
    dist_th: float,
) -> MetricData:
    """Devkit `accumulate`: pool predictions of one class over all samples,
    sort by score, greedy-match each to the nearest unmatched same-class GT
    of its sample; build 101-point PR + TP-error curves."""
    npos = sum(
        1 for boxes in gt_by_token.values() for b in boxes
        if b["detection_name"] == class_name
    )
    if npos == 0:
        return MetricData.no_predictions()

    preds = [
        (token, b)
        for token, boxes in pred_by_token.items()
        for b in boxes if b["detection_name"] == class_name
    ]
    order = np.argsort([-p[1]["detection_score"] for p in preds], kind="stable")

    tp, fp, conf = [], [], []
    md = {k: [] for k in TP_METRICS}
    md_conf = []
    taken = set()
    period = math.pi if class_name == "barrier" else 2 * math.pi
    for ind in order:
        token, pb = preds[int(ind)]
        p_xy = np.asarray(pb["translation"][:2], float)
        min_dist, match_idx = float("inf"), None
        for gi, gb in enumerate(gt_by_token.get(token, [])):
            if gb["detection_name"] != class_name or (token, gi) in taken:
                continue
            d = float(np.linalg.norm(np.asarray(gb["translation"][:2]) - p_xy))
            if d < min_dist:
                min_dist, match_idx = d, gi
        if min_dist < dist_th:
            taken.add((token, match_idx))
            tp.append(1)
            fp.append(0)
            conf.append(pb["detection_score"])
            gb = gt_by_token[token][match_idx]
            md["trans_err"].append(min_dist)
            md["vel_err"].append(float(np.linalg.norm(
                np.asarray(gb.get("velocity", (0, 0))[:2], float)
                - np.asarray(pb.get("velocity", (0, 0))[:2], float)
            )))
            md["scale_err"].append(1.0 - _scale_iou(gb["size"], pb["size"]))
            md["orient_err"].append(_angle_diff(
                quaternion_yaw(gb["rotation"]), quaternion_yaw(pb["rotation"]),
                period,
            ))
            g_attr = gb.get("attribute_name", "")
            md["attr_err"].append(
                float("nan") if g_attr == ""
                else 1.0 - float(g_attr == pb.get("attribute_name", ""))
            )
            md_conf.append(pb["detection_score"])
        else:
            tp.append(0)
            fp.append(1)
            conf.append(pb["detection_score"])

    if len(md["trans_err"]) == 0:
        return MetricData.no_predictions()

    tp_c = np.cumsum(tp).astype(float)
    fp_c = np.cumsum(fp).astype(float)
    conf = np.asarray(conf, float)
    prec = tp_c / (tp_c + fp_c)
    rec = tp_c / float(npos)
    rec_interp = np.linspace(0, 1, _NELEM)
    prec_i = np.interp(rec_interp, rec, prec, right=0)
    conf_i = np.interp(rec_interp, rec, conf, right=0)
    curves = {}
    mc = np.asarray(md_conf, float)
    for key in TP_METRICS:
        tmp = _cummean(np.asarray(md[key], float))
        # interp onto the confidence curve (devkit: x must be increasing)
        curves[key] = np.interp(conf_i[::-1], mc[::-1], tmp[::-1])[::-1]
    return MetricData(rec_interp, prec_i, conf_i, curves["trans_err"],
                      curves["vel_err"], curves["scale_err"],
                      curves["orient_err"], curves["attr_err"])


def calc_ap(md: MetricData, min_recall: float = MIN_RECALL,
            min_precision: float = MIN_PRECISION) -> float:
    prec = np.copy(md.precision)
    prec = prec[round(100 * min_recall) + 1:]
    prec -= min_precision
    prec[prec < 0] = 0
    return float(np.mean(prec)) / (1.0 - min_precision)


def calc_tp(md: MetricData, metric_name: str,
            min_recall: float = MIN_RECALL) -> float:
    first = round(100 * min_recall) + 1
    last = md.max_recall_ind
    if last < first:
        return 1.0
    return float(np.mean(getattr(md, metric_name)[first:last + 1]))


def evaluate_detection(
    gt_by_token: Dict[str, List[dict]],
    pred_by_token: Dict[str, List[dict]],
    ego_xy_by_token: Dict[str, np.ndarray],
) -> Dict:
    """Full detection_cvpr_2019 metrics. Box dicts carry the submission
    fields (detection_name/score, translation, size (w,l,h), rotation
    [w,x,y,z], velocity, attribute_name; GT additionally num_pts).
    Returns {mean_ap, nd_score, mean_dist_aps, label_aps, tp_errors,
    label_tp_errors} mirroring the devkit's serialized DetectionMetrics."""
    for token, boxes in pred_by_token.items():
        if len(boxes) > MAX_BOXES_PER_SAMPLE:
            boxes.sort(key=lambda b: -b["detection_score"])
            del boxes[MAX_BOXES_PER_SAMPLE:]
    # every GT token must be scored; tokens with no predictions count too
    for token in gt_by_token:
        pred_by_token.setdefault(token, [])
    gt_f = filter_eval_boxes(gt_by_token, ego_xy_by_token, is_gt=True)
    pr_f = filter_eval_boxes(pred_by_token, ego_xy_by_token, is_gt=False)

    label_aps: Dict[str, Dict[float, float]] = {}
    label_tp: Dict[str, Dict[str, float]] = {}
    for cls in CLASS_NAMES:
        mds = {th: accumulate(gt_f, pr_f, cls, th) for th in DIST_THS}
        label_aps[cls] = {th: calc_ap(mds[th]) for th in DIST_THS}
        errs = {}
        for metric in TP_METRICS:
            if metric in TP_EXCLUDE.get(cls, ()):
                errs[metric] = float("nan")
            else:
                errs[metric] = calc_tp(mds[DIST_TH_TP], metric)
        label_tp[cls] = errs

    mean_dist_aps = {
        cls: float(np.mean(list(aps.values()))) for cls, aps in label_aps.items()
    }
    mean_ap = float(np.mean(list(mean_dist_aps.values())))
    tp_errors = {
        metric: float(np.nanmean([label_tp[c][metric] for c in CLASS_NAMES]))
        for metric in TP_METRICS
    }
    tp_scores = {m: max(0.0, 1.0 - min(1.0, e)) for m, e in tp_errors.items()}
    nds = (MEAN_AP_WEIGHT * mean_ap + sum(tp_scores.values())) / (
        MEAN_AP_WEIGHT + len(TP_METRICS)
    )
    return dict(
        mean_ap=mean_ap,
        nd_score=float(nds),
        mean_dist_aps=mean_dist_aps,
        label_aps=label_aps,
        tp_errors=tp_errors,
        tp_scores=tp_scores,
        label_tp_errors=label_tp,
    )


# ---------------------------------------------------------------------------
# GT construction from the info pkls
# ---------------------------------------------------------------------------


def gt_from_infos(infos: List[dict], category_map: Dict[str, str]):
    """Info pkls → (gt_by_token, ego_xy_by_token) in the global frame —
    the same lidar→global chain as the submission writer
    (`evaluate.boxes_to_submission`), applied to `gt_boxes`/`gt_names`.

    category_map: raw nuScenes category → detection name ('ignore' = drop), i.e.
    `data.dataset.MAP_GENERAL_TO_DETECTION` (devkit load_gt's
    category_to_detection_name)."""
    from unidistill_torch.data.evaluate import _quat_multiply, _rotmat_to_quat

    gt_by_token: Dict[str, List[dict]] = {}
    ego_xy: Dict[str, np.ndarray] = {}
    for info in infos:
        token = info["sample_token"]
        lidar_to_ego = np.linalg.inv(info["ref_from_car"])
        ego_to_global = np.linalg.inv(info["car_from_global"])
        R = ego_to_global[:3, :3] @ lidar_to_ego[:3, :3]
        t = ego_to_global[:3, :3] @ lidar_to_ego[:3, 3] + ego_to_global[:3, 3]
        ego_xy[token] = ego_to_global[:3, 3][:2]
        Rq = _rotmat_to_quat(R)
        boxes = []
        names = info["gt_names"]
        gtb = np.asarray(info["gt_boxes"], float)
        n_lidar = np.asarray(info.get("num_lidar_pts", np.full(len(gtb), -1)))
        n_radar = np.asarray(info.get("num_radar_pts", np.zeros(len(gtb))))
        attrs = info.get("gt_attributes")
        for i in range(len(gtb)):
            name = category_map.get(str(names[i]), "ignore")
            if name not in CLASS_RANGE:  # 'ignore' and unmapped categories
                continue
            b = gtb[i]
            center = R @ b[:3] + t
            vel = R @ np.array([b[7], b[8], 0.0]) if gtb.shape[1] >= 9 \
                else np.zeros(3)
            yaw_q = np.array([math.cos(b[6] / 2), 0, 0, math.sin(b[6] / 2)])
            q = _quat_multiply(Rq, yaw_q)
            boxes.append(dict(
                detection_name=name,
                translation=center.tolist(),
                size=[float(b[4]), float(b[3]), float(b[5])],  # (w, l, h)
                rotation=q.tolist(),
                velocity=vel[:2].tolist(),
                attribute_name=(str(attrs[i]) if attrs is not None else ""),
                num_pts=int(n_lidar[i]) + int(n_radar[i])
                if n_lidar[i] >= 0 else -1,
            ))
        gt_by_token[token] = boxes
    return gt_by_token, ego_xy


def evaluate_submission_native(
    result_path: str, infos: List[dict], output_path: Optional[str] = None
) -> Dict:
    """Score a written `nuscenes_results.json` against info-pkl GT.

    Only tokens present in `infos` are scored (a val-subset run scores the
    subset, like passing a reduced eval_set to the devkit)."""
    from unidistill_torch.data.dataset import MAP_GENERAL_TO_DETECTION

    with open(result_path) as f:
        submission = json.load(f)
    gt_by_token, ego_xy = gt_from_infos(infos, MAP_GENERAL_TO_DETECTION)
    preds = {
        token: list(boxes)
        for token, boxes in submission["results"].items()
        if token in gt_by_token
    }
    metrics = evaluate_detection(gt_by_token, preds, ego_xy)
    if output_path:
        with open(output_path, "w") as f:
            json.dump(metrics, f, indent=2)
    return metrics
