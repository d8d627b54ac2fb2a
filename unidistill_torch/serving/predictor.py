"""Serving entry point: `Detector(cfg, state_dict).predict(batch)`.

The contract of the JAX package's `serving/export.py` (`load_detector(path)
.predict(batch)`) for the LiDAR-only, the camera-only and the fusion
detector. The batch holds, for a detector with LiDAR, one of the export's
two input modes
(without its `topo_*` tables, which only the TPU build uses):
  "points"       points [B, P, 5] float32 (x, y, z, intensity, Δt) and
                 points_mask [B, P] bool
  "host_voxels"  voxel_feats [B, V, 5] float32 (mean VFE) and voxel_coords
                 [B, V, 3] int32 (z, y, x; -1 on padding)
and for a detector with cameras
  imgs           [B, N_cam, H, W, 3] float32 (normalised)
  mats           sensor2ego_mats / intrin_mats / ida_mats [B, N_cam, 4, 4]
                 and bda_mat [B, 4, 4], float32
or, for weights of a multi-sweep camera encoder (S sweeps, read off the
state dict: `models.bevfusion.sweeps_from_state_dict`), imgs
[B, S, N_cam, H, W, 3] and those three mats [B, S, N_cam, 4, 4] (sweep 0
the key frame; bda_mat [B, 4, 4] shared)
(the fusion detector takes both; other keys, such as gt_boxes, are
ignored). `predict` returns the eval
step's fixed-size ROI dict: boxes [B, R, 9], scores [B, R], labels [B, R]
(1-based), mask [B, R], as tensors on the detector's device.

The detector runs on the card unless the caller passes device="cpu".
`serving/export.py` writes the same eval step, with its weights, as a
`torch.export` artifact that serves without this module.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

from unidistill_torch.configs.nuscenes import ModelConfig
from unidistill_torch.models.bevfusion import BEVFusionCenterHead, sweeps_from_state_dict
from unidistill_torch.training.steps import eval_step

MAT_KEYS = ("sensor2ego_mats", "intrin_mats", "ida_mats")


def resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run on the CPU")
    return device


F32 = (torch.float32, np.float32)


def _dtype(v):
    return v.dtype if isinstance(v, torch.Tensor) else np.asarray(v).dtype


def _expect(name: str, v, shape, dtypes) -> None:
    if tuple(v.shape) != shape:
        raise ValueError(f"batch[{name!r}] has shape {tuple(v.shape)}, expected {shape}")
    if _dtype(v) not in dtypes:
        raise ValueError(f"batch[{name!r}] has dtype {_dtype(v)}, expected {dtypes[0]}")


class Detector:
    """A LiDAR-only, camera-only or fusion BEVFusion-CenterHead detector
    ready to serve."""

    def __init__(self, cfg: ModelConfig, state_dict: Mapping[str, Any], device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        model = BEVFusionCenterHead(cfg, sweeps_from_state_dict(cfg, state_dict))
        model.load_state_dict(dict(state_dict), strict=True)
        self.model = model.to(self.device).eval()

    def _check(self, batch: Mapping[str, Any]) -> None:
        if self.cfg.with_lidar:
            self._check_lidar(batch)
        if self.cfg.with_camera:
            self._check_camera(batch)

    def _check_lidar(self, batch: Mapping[str, Any]) -> None:
        C = self.cfg.lidar_encoder.use_num_point_features
        if "voxel_feats" in batch:
            lead = tuple(batch["voxel_feats"].shape[:2])
            _expect("voxel_feats", batch["voxel_feats"], lead + (C,), F32)
            _expect("voxel_coords", batch["voxel_coords"], lead + (3,), (torch.int32, np.int32))
        else:
            lead = tuple(batch["points"].shape[:2])
            _expect("points", batch["points"], lead + (C,), F32)
            _expect("points_mask", batch["points_mask"], lead, (torch.bool, np.bool_))

    def _check_camera(self, batch: Mapping[str, Any]) -> None:
        cc = self.cfg.camera_encoder
        H, W = cc.final_dim
        imgs = batch["imgs"]
        shape = tuple(imgs.shape)
        sweeps = () if self.model.sweeps == 1 else (self.model.sweeps,)
        want = sweeps + (cc.num_cams, H, W, 3)
        if shape[1:] != want:
            raise ValueError(f"batch['imgs'] has shape {shape}, expected (B, {', '.join(map(str, want))})")
        B = shape[0]
        mats = batch["mats"]
        for k in MAT_KEYS:
            if tuple(mats[k].shape) != (B,) + sweeps + (cc.num_cams, 4, 4):
                raise ValueError(f"batch['mats'][{k!r}] has shape {tuple(mats[k].shape)}, "
                                 f"expected {(B,) + sweeps + (cc.num_cams, 4, 4)}")
        if "bda_mat" in mats and tuple(mats["bda_mat"].shape) != (B, 4, 4):
            raise ValueError(f"batch['mats']['bda_mat'] has shape {tuple(mats['bda_mat'].shape)}, "
                             f"expected ({B}, 4, 4)")
        for name, v in [("imgs", imgs)] + [(f"mats/{k}", m) for k, m in mats.items()]:
            if _dtype(v) not in F32:
                raise ValueError(f"batch[{name!r}] has dtype {_dtype(v)}, expected float32")

    def predict(self, batch: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
        self._check(batch)
        return eval_step(self.model, batch, self.cfg)
