"""nuScenes multi-modal dataset: info-pkl reader + CBGS + aug composition;
the port's copy of the JAX package's `data/dataset.py`.

ref unidistill/data/multisensorfusion/{nuScenes_multimodal.py:40-249,
nuscenes_multimodal.py:45-415}. As in the JAX package:
  * numpy/PIL on the host (no mmdet3d / pyquaternion);
  * FIXED-SHAPE frames (points padded to caps.max_points with a mask, GTs
    padded to caps.max_gt_boxes);
  * images come out NHWC float32 normalized; mats are plain [N_cam, 4, 4];
  * gt_boxes carry the 1-based class id fused in column 9 (the reference
    appends `gt_labels + 1` inside training_step, …base_exp.py:372-373);
  * configurable root path instead of the reference's hard-coded
    /data/dataset.
The sweeps' transform, the image normalisation and the voxeliser run in the
host C++ library (`data/native.py`), where the JAX loader runs them.
A LiDAR frame is voxelised here, on the CPU, at the split's voxel cap
(`ops.voxelize.voxelize_frame`): the train and distill steps take the
loader's `voxel_feats` / `voxel_coords`, as the JAX steps do. No sparse
topology is planned (no `topo_*` keys): the port's encoder builds its own
maps on the device.
"""
from __future__ import annotations

import os
import pickle
from typing import Dict, List

import numpy as np
from PIL import Image

from unidistill_torch.configs.nuscenes import CLASS_NAMES, DataConfig, ModelConfig
from unidistill_torch.data import native, transforms as T
from unidistill_torch.ops.voxelize import voxelize_frame

# nuScenes general category → 10 detection classes (ref nuScenes_multimodal.py:13-37)
MAP_GENERAL_TO_DETECTION = {
    "human.pedestrian.adult": "pedestrian",
    "human.pedestrian.child": "pedestrian",
    "human.pedestrian.wheelchair": "ignore",
    "human.pedestrian.stroller": "ignore",
    "human.pedestrian.personal_mobility": "ignore",
    "human.pedestrian.police_officer": "pedestrian",
    "human.pedestrian.construction_worker": "pedestrian",
    "animal": "ignore",
    "vehicle.car": "car",
    "vehicle.motorcycle": "motorcycle",
    "vehicle.bicycle": "bicycle",
    "vehicle.bus.bendy": "bus",
    "vehicle.bus.rigid": "bus",
    "vehicle.truck": "truck",
    "vehicle.construction": "construction_vehicle",
    "vehicle.emergency.ambulance": "ignore",
    "vehicle.emergency.police": "ignore",
    "vehicle.trailer": "trailer",
    "movable_object.barrier": "barrier",
    "movable_object.trafficcone": "traffic_cone",
    "movable_object.pushable_pullable": "ignore",
    "movable_object.debris": "ignore",
    "static_object.bicycle_rack": "ignore",
}

CAM_KEYS = (
    "CAM_BACK",
    "CAM_BACK_LEFT",
    "CAM_BACK_RIGHT",
    "CAM_FRONT",
    "CAM_FRONT_LEFT",
    "CAM_FRONT_RIGHT",
)

SPLIT_TABLE = {"training": "train", "validation": "val", "testing": "test"}


class NuScenesDataset:
    def __init__(
        self,
        data_cfg: DataConfig,
        model_cfg: ModelConfig,
        data_split: str = "training",
        seed: int = 0,
    ):
        self.cfg = data_cfg
        self.model_cfg = model_cfg
        self.split = SPLIT_TABLE[data_split]
        self.is_train = data_split in ("training", "trainval")
        self.seed = seed
        self.rng = np.random.RandomState(seed)
        self.with_lidar = model_cfg.with_lidar
        self.with_camera = model_cfg.with_camera
        self.use_cbgs = data_cfg.use_cbgs and self.is_train
        self._read_infos(self.rng)

    def _read_infos(self, rng: np.random.RandomState) -> None:
        info_path = os.path.join(self.cfg.root_path, f"{self.split}_info.pkl")
        with open(info_path, "rb") as f:
            self.infos = pickle.load(f)
        if self.use_cbgs:
            self.sample_indices = self._cbgs_indices(rng)

    # A loader worker gets the dataset without its infos and CBGS indices and
    # reads them itself (the CBGS draw is the generator's first, so a fresh
    # RandomState(seed) repeats it): the pickle a spawned worker is sent
    # must stay within its pipe's 64 KiB, or the parent blocks until that
    # worker has imported its modules, and the workers start one by one.
    def __getstate__(self):
        state = dict(self.__dict__)
        del state["infos"]
        state.pop("sample_indices", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._read_infos(np.random.RandomState(self.seed))

    # ---- CBGS class-balanced resampling (ref nuscenes_multimodal.py:142-177)
    def _cbgs_indices(self, rng: np.random.RandomState) -> List[int]:
        cat2id = {n: i for i, n in enumerate(CLASS_NAMES)}
        class_sample_idxs: Dict[int, List[int]] = {i: [] for i in cat2id.values()}
        for idx, info in enumerate(self.infos):
            names = {
                MAP_GENERAL_TO_DETECTION.get(n, "ignore")
                for n in info.get("gt_names", [])
            }
            for n in names:
                if n in cat2id:
                    class_sample_idxs[cat2id[n]].append(idx)
        dup = sum(len(v) for v in class_sample_idxs.values())
        frac = 1.0 / len(CLASS_NAMES)
        out: List[int] = []
        for cls_inds in class_sample_idxs.values():
            if not cls_inds:
                continue
            ratio = frac / (len(cls_inds) / dup)
            out += rng.choice(cls_inds, int(len(cls_inds) * ratio)).tolist()
        if not out:  # degenerate tiny datasets: int() truncation can zero out
            out = list(range(len(self.infos)))
        return out

    def __len__(self):
        return len(self.sample_indices) if self.use_cbgs else len(self.infos)

    # ---- raw loading -------------------------------------------------------
    def _load_points(self, info) -> np.ndarray:
        f = os.path.join(self.cfg.root_path, info["lidar_infos"]["LIDAR_TOP"]["filename"])
        pts = np.fromfile(f, dtype=np.float32).reshape(-1, 5)
        return pts[:, : (5 if self.cfg.lidar_with_timestamp else 4)].copy()

    def _load_sweeps(self, info):
        # Reference semantics (nuscenes_multimodal.py sweeps loop): concatenate
        # only the sweeps that exist — early-scene frames with n_avail <
        # num_lidar_sweeps yield fewer points, NOT duplicated ones (duplicates
        # would shift voxel mean-VFE features). Fixed-shape padding happens
        # downstream via the point cap/mask.
        sweeps, sweep_infos = [], []
        n_avail = len(info.get("lidar_sweeps", []))
        for i in range(min(self.cfg.num_lidar_sweeps, n_avail)):
            s = info["lidar_sweeps"][i]["LIDAR_TOP"]
            f = os.path.join(self.cfg.root_path, s["filename"])
            pts = np.fromfile(f, dtype=np.float32).reshape(-1, 5)
            sweeps.append(pts)
            sweep_infos.append(
                dict(
                    sweep_lidar_to_ego=np.linalg.inv(s["car_from_global"]),
                    sweep_lidar_timestamp=s["timestamp"],
                )
            )
        return sweeps, sweep_infos

    def _load_images(self, info):
        imgs = {}
        for cam in CAM_KEYS[: self.model_cfg.camera_encoder.num_cams]:
            f = os.path.join(self.cfg.root_path, info["cam_infos"][cam]["filename"])
            imgs[cam] = np.asarray(Image.open(f).convert("RGB"))
        return imgs

    # ---- per-frame assembly ------------------------------------------------
    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        if self.use_cbgs:
            idx = self.sample_indices[idx]
        for _ in range(32):  # empty-GT resample loop (ref :329-331)
            frame = self._build(idx)
            if not self.is_train or frame["gt_boxes_raw"].shape[0] > 0:
                return frame
            idx = self.rng.choice(len(self.infos))
        return frame

    def _build(self, idx: int) -> Dict[str, np.ndarray]:
        info = self.infos[idx]
        cfg, mcfg = self.cfg, self.model_cfg

        # GT filtering (ref nuscenes_multimodal.py:182-195)
        if self.is_train and "gt_boxes" in info:
            names = [MAP_GENERAL_TO_DETECTION.get(n, "ignore") for n in info["gt_names"]]
            npts = np.asarray(info["num_lidar_pts"]) + np.asarray(info["num_radar_pts"])
            keep = [
                i for i, n in enumerate(names) if n in CLASS_NAMES and npts[i] > 0
            ]
            gt_boxes = np.asarray(info["gt_boxes"], np.float64)[keep]
            gt_labels = np.asarray(
                [CLASS_NAMES.index(names[i]) for i in keep], np.int64
            )
        else:
            gt_boxes = np.zeros((0, 9))
            gt_labels = np.zeros((0,), np.int64)
        gt_boxes = np.nan_to_num(gt_boxes)  # nan velocities of cones (ref :314-316)

        out: Dict[str, np.ndarray] = {}
        ego_to_global = np.linalg.inv(info["car_from_global"])
        lidar_to_ego = np.linalg.inv(info["ref_from_car"])

        points = None
        if self.with_lidar:
            points = self._load_points(info)
            sweeps, sweep_infos = self._load_sweeps(info)
            points = T.collect_lidar_sweeps(
                points, sweeps, lidar_to_ego, ego_to_global, info["timestamp"],
                sweep_infos,
            )

        imgs = ida_mats = None
        if self.with_camera:
            raw = self._load_images(info)
            imgs, ida_mats = [], []
            ccfg = mcfg.camera_encoder
            for cam in CAM_KEYS[: ccfg.num_cams]:
                aug = T.sample_ida_augs(
                    self.rng, (cfg.src_h, cfg.src_w), ccfg.final_dim,
                    cfg.ida_resize_lim, cfg.ida_rot_lim, cfg.ida_rand_flip,
                    cfg.ida_bot_pct_lim, self.is_train,
                )
                img, ida = T.img_transform(Image.fromarray(raw[cam]), *aug)
                imgs.append(
                    native.normalize_image(np.asarray(img), cfg.img_mean,
                                      cfg.img_std, swap_channels=cfg.to_rgb)
                )
                ida_mats.append(ida)
            imgs = np.stack(imgs).astype(np.float32)  # [N_cam, H, W, 3]
            ida_mats = np.stack(ida_mats).astype(np.float32)

        # BDA (train only; ref get_det_augmentor, nuscenes_multimodal.py:115-123)
        bda = np.eye(4, dtype=np.float32)
        if self.is_train:
            rot = self.rng.uniform(*cfg.bda_rot_lim)
            scale = self.rng.uniform(*cfg.bda_scale_lim)
            trans = self.rng.normal(scale=cfg.bda_trans_lim)
            fdx = self.rng.uniform() < cfg.bda_flip_dx_ratio
            fdy = self.rng.uniform() < cfg.bda_flip_dy_ratio
            gt_boxes, bda64 = T.bev_transform(gt_boxes, rot, scale, trans, fdx, fdy)
            bda = bda64.astype(np.float32)
            if points is not None:
                points = T.apply_bda_to_points(points, bda64)

        points, gt_boxes, gt_labels = T.object_range_filter(
            points, gt_boxes, gt_labels, mcfg.point_cloud_range, self.is_train
        )

        # camera matrices (ref format_processor, nuscenes_multimodal.py:261-301)
        if self.with_camera:
            s2e, intr = [], []
            for cam in CAM_KEYS[: mcfg.camera_encoder.num_cams]:
                m = np.eye(4)
                m[:3, :3] = T.quaternion_rotation_matrix(
                    info["sensor2ego_rotations"][cam]
                )
                m[:3, 3] = info["sensor2ego_translations"][cam]
                s2e.append((info["ref_from_car"] @ m).astype(np.float32))
                im = np.eye(4, dtype=np.float32)
                im[:3, :3] = info["cam_infos"][cam]["calibrated_sensor"][
                    "camera_intrinsic"
                ]
                intr.append(im)
            out["mats"] = dict(
                sensor2ego_mats=np.stack(s2e),
                intrin_mats=np.stack(intr),
                ida_mats=ida_mats,
                bda_mat=bda,
            )
            out["imgs"] = imgs

        if points is not None:
            cap = mcfg.caps.max_points
            P = np.zeros((cap, points.shape[1]), np.float32)
            n = min(len(points), cap)
            if len(points) > cap:  # keep a uniform subsample if over cap
                sel = self.rng.choice(len(points), cap, replace=False)
                P[:] = points[sel]
            else:
                P[:n] = points[:n]
            mask = np.zeros(cap, bool)
            mask[:n] = True
            out["points"] = P
            out["points_mask"] = mask
            vf, vc = voxelize_frame(P, mask, mcfg, self.is_train)
            out["voxel_feats"] = vf
            out["voxel_coords"] = vc

        # fused gt (cls 1-based in col 9), fixed shape
        G = mcfg.caps.max_gt_boxes
        gb = np.zeros((G, 10), np.float32)
        n = min(len(gt_boxes), G)
        gb[:n, :9] = gt_boxes[:n]
        gb[:n, 9] = gt_labels[:n] + 1
        out["gt_boxes"] = gb
        out["gt_boxes_raw"] = gt_boxes
        out["meta"] = dict(
            token=info.get("sample_token"),
            timestamp=info.get("timestamp"),
            ego2global_translation=info.get("ego2global_translation"),
            ego2global_rotation=info.get("ego2global_rotation"),
        )
        return out
