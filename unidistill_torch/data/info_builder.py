"""Build `{split}_info.pkl` files from a raw nuScenes dataset; the port's
copy of the JAX package's `data/info_builder.py`.

The dataset layer (`data/dataset.py`) reads BEVDepth-style info pkls. This
builder writes them straight from the raw nuScenes JSON tables
(`<dataroot>/<version>/*.json`) with no devkit dependency:

    python -m unidistill_torch.data.info_builder \
        --dataroot /data/nuscenes --version v1.0-mini --out /data/dataset

Schema written per sample (exactly what `NuScenesDataset._build` reads;
reference analog: the info pkls consumed by
unidistill/data/multisensorfusion/nuScenes_multimodal.py:114-249):

    sample_token, timestamp (µs),
    gt_boxes        [N, 9] (x, y, z, dx, dy, dz, yaw, vx, vy) in the key
                    LIDAR frame (dx along box length — nuScenes size[1]),
    gt_names        raw category strings (mapped to the 10 det classes by
                    the dataset), num_lidar_pts, num_radar_pts,
    gt_attributes   per-box attribute name ('' when absent) — consumed by
                    the native evaluator's mAAE (data/detection_eval.py),
    car_from_global [4, 4] global→ego at key time,
    ref_from_car    [4, 4] ego→lidar,
    ego2global_translation / ego2global_rotation (for submission output),
    lidar_infos     {"LIDAR_TOP": {filename}},
    lidar_sweeps    [{"LIDAR_TOP": {filename, car_from_global, timestamp}}]
                    newest→oldest, ≤ max_sweeps, only sweeps that exist,
    cam_infos       {cam: {filename, calibrated_sensor{camera_intrinsic}}},
    sensor2ego_rotations / sensor2ego_translations per cam.

Splits: v1.0-mini's scene lists are built in; for v1.0-trainval pass scene
names via --scene-file (one name per line, devkit
`nuscenes.utils.splits.train/val` equivalents) or install the devkit and the
builder imports them automatically.
"""
from __future__ import annotations

import argparse
import json
import os
import pickle
from typing import Dict, List, Optional

import numpy as np

from unidistill_torch.data.transforms import quaternion_rotation_matrix

CAM_CHANNELS = (
    "CAM_FRONT_LEFT", "CAM_FRONT", "CAM_FRONT_RIGHT",
    "CAM_BACK_LEFT", "CAM_BACK", "CAM_BACK_RIGHT",
)

# nuscenes-devkit splits.py mini lists (public constants)
MINI_TRAIN = (
    "scene-0061", "scene-0553", "scene-0655", "scene-0757",
    "scene-0796", "scene-1077", "scene-1094", "scene-1100",
)
MINI_VAL = ("scene-0103", "scene-0916")


def _pose_mat(rec) -> np.ndarray:
    """ego_pose / calibrated_sensor record → 4×4 (frame → parent frame)."""
    m = np.eye(4)
    m[:3, :3] = quaternion_rotation_matrix(rec["rotation"])
    m[:3, 3] = rec["translation"]
    return m


class Tables:
    """Raw nuScenes JSON tables indexed by token (the devkit minus the
    devkit)."""

    NAMES = (
        "scene", "sample", "sample_data", "ego_pose", "calibrated_sensor",
        "sensor", "sample_annotation", "instance", "category",
    )
    OPTIONAL = ("attribute",)  # needed only for native mAAE scoring

    def __init__(self, dataroot: str, version: str):
        self.dataroot = dataroot
        table_dir = os.path.join(dataroot, version)
        if not os.path.isdir(table_dir):
            raise FileNotFoundError(
                f"{table_dir} is not a directory — expected the raw nuScenes "
                "layout <dataroot>/<version>/*.json"
            )
        self.t: Dict[str, Dict[str, dict]] = {}
        for name in self.NAMES:
            with open(os.path.join(table_dir, f"{name}.json")) as f:
                self.t[name] = {r["token"]: r for r in json.load(f)}
        for name in self.OPTIONAL:
            path = os.path.join(table_dir, f"{name}.json")
            if os.path.exists(path):
                with open(path) as f:
                    self.t[name] = {r["token"]: r for r in json.load(f)}
            else:
                self.t[name] = {}
        # channel of a sample_data: calibrated_sensor → sensor → channel
        self.channel = {
            tok: self.t["sensor"][
                self.t["calibrated_sensor"][sd["calibrated_sensor_token"]]
                ["sensor_token"]
            ]["channel"]
            for tok, sd in self.t["sample_data"].items()
        }
        # key-frame sample_data grouped (sample_token, channel) → record
        self.key_sd: Dict[tuple, dict] = {}
        for tok, sd in self.t["sample_data"].items():
            if sd["is_key_frame"]:
                self.key_sd[(sd["sample_token"], self.channel[tok])] = sd
        # annotations per sample
        self.anns: Dict[str, List[dict]] = {}
        for a in self.t["sample_annotation"].values():
            self.anns.setdefault(a["sample_token"], []).append(a)

    def samples_of_scene(self, scene_name: str) -> List[dict]:
        scenes = [s for s in self.t["scene"].values() if s["name"] == scene_name]
        if not scenes:
            return []
        out, tok = [], scenes[0]["first_sample_token"]
        while tok:
            s = self.t["sample"][tok]
            out.append(s)
            tok = s["next"]
        return out

    def ann_velocity(self, ann: dict, max_dt: float = 1.5) -> np.ndarray:
        """Global-frame box velocity from neighboring annotations of the
        same instance (devkit `box_velocity` semantics: central difference
        when both neighbors exist, one-sided otherwise, NaN when isolated)."""
        table = self.t["sample_annotation"]
        has_prev, has_next = bool(ann["prev"]), bool(ann["next"])
        if not has_prev and not has_next:
            return np.full(3, np.nan)
        first = table[ann["prev"]] if has_prev else ann
        last = table[ann["next"]] if has_next else ann
        p0 = np.asarray(first["translation"])
        p1 = np.asarray(last["translation"])
        t0 = self.t["sample"][first["sample_token"]]["timestamp"] / 1e6
        t1 = self.t["sample"][last["sample_token"]]["timestamp"] / 1e6
        if t1 - t0 > 2 * max_dt or t1 == t0:
            return np.full(3, np.nan)
        return (p1 - p0) / (t1 - t0)


def _yaw_from_rot(M: np.ndarray) -> float:
    """Yaw of a (near-)z-rotation matrix: angle of the box x-axis in the
    target frame's xy plane."""
    return float(np.arctan2(M[1, 0], M[0, 0]))


def build_sample_info(tb: Tables, sample: dict, max_sweeps: int) -> Optional[dict]:
    stok = sample["token"]
    lidar_sd = tb.key_sd.get((stok, "LIDAR_TOP"))
    if lidar_sd is None:
        return None
    ego_pose = tb.t["ego_pose"][lidar_sd["ego_pose_token"]]
    calib = tb.t["calibrated_sensor"][lidar_sd["calibrated_sensor_token"]]
    ego_to_global = _pose_mat(ego_pose)      # ego → global at key time
    lidar_to_ego = _pose_mat(calib)          # lidar → ego
    car_from_global = np.linalg.inv(ego_to_global)
    ref_from_car = np.linalg.inv(lidar_to_ego)
    global_to_lidar = ref_from_car @ car_from_global

    # ---- sweeps: previous non-key LIDAR_TOP frames, newest first ----------
    sweeps = []
    tok = lidar_sd["prev"]
    while tok and len(sweeps) < max_sweeps:
        sd = tb.t["sample_data"][tok]
        sweep_pose = tb.t["ego_pose"][sd["ego_pose_token"]]
        sweeps.append({
            "LIDAR_TOP": dict(
                filename=sd["filename"],
                # consumed as inv() = sweep ego→global by
                # transforms.collect_lidar_sweeps (dataset.py:138)
                car_from_global=np.linalg.inv(_pose_mat(sweep_pose)),
                timestamp=sd["timestamp"],
            )
        })
        tok = sd["prev"]

    # ---- cameras -----------------------------------------------------------
    cam_infos, s2e_rot, s2e_tr = {}, {}, {}
    for cam in CAM_CHANNELS:
        sd = tb.key_sd.get((stok, cam))
        if sd is None:
            continue
        cc = tb.t["calibrated_sensor"][sd["calibrated_sensor_token"]]
        cam_infos[cam] = dict(
            filename=sd["filename"],
            calibrated_sensor=dict(
                camera_intrinsic=np.asarray(cc["camera_intrinsic"], np.float64)
            ),
        )
        s2e_rot[cam] = list(cc["rotation"])
        s2e_tr[cam] = list(cc["translation"])

    # ---- annotations → lidar-frame 9-dim boxes -----------------------------
    anns = tb.anns.get(stok, [])
    n = len(anns)
    gt_boxes = np.zeros((n, 9))
    gt_names, gt_attrs, n_lidar, n_radar = [], [], [], []
    R_gl = global_to_lidar[:3, :3]
    for i, a in enumerate(anns):
        center = global_to_lidar @ np.append(np.asarray(a["translation"]), 1.0)
        Rbox = R_gl @ quaternion_rotation_matrix(a["rotation"])
        w, l, h = a["size"]  # nuScenes order: width (y), length (x), height
        vel = tb.ann_velocity(a)
        vel_l = R_gl @ np.nan_to_num(vel)
        gt_boxes[i] = [
            center[0], center[1], center[2], l, w, h,
            _yaw_from_rot(Rbox), vel_l[0], vel_l[1],
        ]
        # raw-schema annotations carry instance_token only; the devkit
        # derives category_name via instance → category
        cat = a.get("category_name")
        if cat is None:
            inst = tb.t["instance"][a["instance_token"]]
            cat = tb.t["category"][inst["category_token"]]["name"]
        gt_names.append(cat)
        # nuScenes annotations have 0 or 1 attribute (devkit GT loader takes
        # the single one, '' when absent) — consumed by native mAAE scoring
        atoks = a.get("attribute_tokens") or []
        gt_attrs.append(
            tb.t["attribute"].get(atoks[0], {}).get("name", "")
            if len(atoks) == 1 else ""
        )
        n_lidar.append(a.get("num_lidar_pts", 0))
        n_radar.append(a.get("num_radar_pts", 0))

    return dict(
        sample_token=stok,
        timestamp=sample["timestamp"],
        gt_boxes=gt_boxes,
        gt_names=np.asarray(gt_names),
        gt_attributes=np.asarray(gt_attrs),
        num_lidar_pts=np.asarray(n_lidar, np.int64),
        num_radar_pts=np.asarray(n_radar, np.int64),
        car_from_global=car_from_global,
        ref_from_car=ref_from_car,
        ego2global_translation=list(ego_pose["translation"]),
        ego2global_rotation=list(ego_pose["rotation"]),
        lidar_infos={"LIDAR_TOP": dict(filename=lidar_sd["filename"])},
        lidar_sweeps=sweeps,
        cam_infos=cam_infos,
        sensor2ego_rotations=s2e_rot,
        sensor2ego_translations=s2e_tr,
    )


def build_split_infos(
    tb: Tables, scene_names, max_sweeps: int = 10
) -> List[dict]:
    infos = []
    for name in scene_names:
        for sample in tb.samples_of_scene(name):
            info = build_sample_info(tb, sample, max_sweeps)
            if info is not None:
                infos.append(info)
    return infos


def _resolve_splits(version: str, scene_file: Optional[str]):
    if scene_file:
        with open(scene_file) as f:
            spec = json.load(f)  # {"train": [...], "val": [...]}
        return {k: tuple(v) for k, v in spec.items()}
    if version == "v1.0-mini":
        return {"train": MINI_TRAIN, "val": MINI_VAL}
    try:  # devkit, if present, carries the official 700/150 scene lists
        from nuscenes.utils import splits  # type: ignore

        return {"train": tuple(splits.train), "val": tuple(splits.val)}
    except ImportError:
        raise SystemExit(
            f"no built-in split lists for {version}: pass --scene-file "
            'pointing at {"train": [...], "val": [...]} scene names, or '
            "install nuscenes-devkit"
        )


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--dataroot", required=True)
    ap.add_argument("--version", default="v1.0-mini")
    ap.add_argument("--out", required=True, help="output dir for the pkls "
                    "(point DataConfig.root_path here; lidar/img filenames "
                    "stay relative to --dataroot)")
    ap.add_argument("--max-sweeps", type=int, default=10)
    ap.add_argument("--scene-file", default=None,
                    help='json {"train": [scene names], "val": [...]}')
    args = ap.parse_args(argv)

    tb = Tables(args.dataroot, args.version)
    os.makedirs(args.out, exist_ok=True)
    for split, scenes in _resolve_splits(args.version, args.scene_file).items():
        infos = build_split_infos(tb, scenes, args.max_sweeps)
        out = os.path.join(args.out, f"{split}_info.pkl")
        with open(out, "wb") as f:
            pickle.dump(infos, f)
        print(f"{split}: {len(infos)} samples from {len(scenes)} scenes → {out}")


if __name__ == "__main__":
    main()
