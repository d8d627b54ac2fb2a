"""nuScenes submission generation + evaluation; the port's copy of the JAX
package's `data/evaluate.py`.

ref unidistill/data/multisensorfusion/{evaluate.py:16-117, eval_utils.py:12-112}.
The reference needs a live NuScenes devkit object to look up per-sample
calibrated_sensor/ego_pose; here the lidar→global chain comes straight from
the info pkl (lidar_to_ego = inv(ref_from_car), ego_to_global =
inv(car_from_global)) in pure numpy — same math, no devkit required to WRITE
`nuscenes_results.json`. Scoring (`DetectionEval`, detection_cvpr_2019) still
needs the devkit and is import-gated.

The emitted JSON is format-identical to the reference's
(`{"meta": {...}, "results": {token: [box_item...]}}`, attribute rules
eval_utils.py:82-102).
"""
from __future__ import annotations

import json
import math
import os
from typing import Dict, List, Optional

import numpy as np

from unidistill_torch.configs.nuscenes import CLASS_NAMES

DEFAULT_ATTRIBUTE = {
    "car": "vehicle.parked",
    "pedestrian": "pedestrian.moving",
    "trailer": "vehicle.parked",
    "truck": "vehicle.parked",
    "bus": "vehicle.moving",
    "motorcycle": "cycle.without_rider",
    "construction_vehicle": "vehicle.parked",
    "bicycle": "cycle.without_rider",
    "barrier": "",
    "traffic_cone": "",
}


def _quat_multiply(a, b):
    w1, x1, y1, z1 = a
    w2, x2, y2, z2 = b
    return np.array(
        [
            w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
            w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
            w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
            w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        ]
    )


def _attr_for(name: str, vel_xy) -> str:
    """Attribute heuristics (ref eval_utils.py:82-102)."""
    if math.sqrt(vel_xy[0] ** 2 + vel_xy[1] ** 2) > 0.2:
        if name in ("car", "construction_vehicle", "bus", "truck", "trailer"):
            return "vehicle.moving"
        if name in ("bicycle", "motorcycle"):
            return "cycle.with_rider"
        return DEFAULT_ATTRIBUTE[name]
    if name == "pedestrian":
        return "pedestrian.standing"
    if name == "bus":
        return "vehicle.stopped"
    return DEFAULT_ATTRIBUTE[name]


def boxes_to_submission(
    boxes: np.ndarray,
    scores: np.ndarray,
    labels_0based: np.ndarray,
    token: str,
    lidar_to_ego: np.ndarray,
    ego_to_global: np.ndarray,
    ego2global_rotation=None,
    sensor2ego_rotation=None,
) -> List[Dict]:
    """One frame's detections → list of nuScenes box items.

    boxes: [N, 9] (x, y, z, dx, dy, dz, rot, vx, vy) in the lidar/ref frame.
    Rotation quaternions are taken from the 4×4s (matrix chain == the
    reference's two quaternion rotations).
    """
    out = []
    R_l2e = lidar_to_ego[:3, :3]
    t_l2e = lidar_to_ego[:3, 3]
    R_e2g = ego_to_global[:3, :3]
    t_e2g = ego_to_global[:3, 3]
    R = R_e2g @ R_l2e
    for i in range(len(boxes)):
        b = boxes[i]
        name = CLASS_NAMES[int(labels_0based[i])]
        center = R @ b[:3] + R_e2g @ t_l2e + t_e2g
        vel = R @ np.array([b[7], b[8], 0.0]) if boxes.shape[1] >= 9 else np.zeros(3)
        # orientation: global_R * yaw_quat
        yaw_q = np.array([math.cos(b[6] / 2), 0.0, 0.0, math.sin(b[6] / 2)])
        Rq = _rotmat_to_quat(R)
        q = _quat_multiply(Rq, yaw_q)
        out.append(
            {
                "sample_token": token,
                "detection_name": name,
                "detection_score": float(scores[i]),
                "translation": center.tolist(),
                # nuScenes Box size is (w, l, h) = our (dy, dx, dz)[[1,0,2]]
                "size": [float(b[4]), float(b[3]), float(b[5])],
                "rotation": q.tolist(),
                "velocity": vel[:2].tolist(),
                "attribute_name": _attr_for(name, vel[:2]),
            }
        )
    return out


def _rotmat_to_quat(R: np.ndarray) -> np.ndarray:
    """3×3 rotation matrix → quaternion [w, x, y, z]."""
    t = np.trace(R)
    if t > 0:
        s = math.sqrt(t + 1.0) * 2
        return np.array(
            [0.25 * s, (R[2, 1] - R[1, 2]) / s, (R[0, 2] - R[2, 0]) / s,
             (R[1, 0] - R[0, 1]) / s]
        )
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = math.sqrt(max(R[i, i] - R[j, j] - R[k, k] + 1.0, 1e-12)) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[i + 1] = 0.25 * s
    q[j + 1] = (R[j, i] + R[i, j]) / s
    q[k + 1] = (R[k, i] + R[i, k]) / s
    return q


def generate_submission(
    predictions: List[Dict],
    infos: List[Dict],
    result_dir: str,
    meta_type_list=("use_camera", "use_lidar"),
) -> str:
    """predictions: per-frame dicts with boxes [N, 9], scores [N],
    labels (0-based) [N], aligned with `infos`. Writes nuscenes_results.json
    (format-identical to ref evaluate.py:76-84). Returns the path."""
    results = {}
    for pred, info in zip(predictions, infos):
        token = info["sample_token"]
        results[token] = boxes_to_submission(
            np.asarray(pred["boxes"]),
            np.asarray(pred["scores"]),
            np.asarray(pred["labels"]),
            token,
            np.linalg.inv(info["ref_from_car"]),
            np.linalg.inv(info["car_from_global"]),
        )
    submit = {
        "meta": {
            k: k in meta_type_list
            for k in ("use_camera", "use_lidar", "use_radar", "use_map",
                       "use_external")
        },
        "results": results,
    }
    os.makedirs(result_dir, exist_ok=True)
    path = os.path.join(result_dir, "nuscenes_results.json")
    with open(path, "w") as f:
        f.write(json.dumps(submit))
    return path


def run_detection_eval(
    result_path: str,
    output_dir: str,
    nusc_meta=None,
    eval_set: str = "val",
    version: str = "v1.0-trainval",
    dataroot: Optional[str] = None,
) -> Optional[Dict]:
    """nuScenes DetectionEval (detection_cvpr_2019), devkit-gated
    (ref evaluate.py:87-117). The devkit requires a live `NuScenes` object;
    when `nusc_meta` is not supplied one is built from (version, dataroot)
    — the same construction the reference does at evaluate.py:97-101."""
    try:
        from nuscenes import NuScenes
        from nuscenes.eval.common.config import config_factory
        from nuscenes.eval.detection.evaluate import DetectionEval
    except ImportError:
        return None
    if nusc_meta is None:
        if dataroot is None:
            return None
        nusc_meta = NuScenes(version=version, dataroot=dataroot, verbose=False)
    cfg = config_factory("detection_cvpr_2019")
    ev = DetectionEval(
        nusc_meta, config=cfg, result_path=result_path, eval_set=eval_set,
        output_dir=output_dir, verbose=False,
    )
    return ev.main(plot_examples=0, render_curves=False)
