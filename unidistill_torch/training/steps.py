"""Eval step of the single-modality detectors; counterpart of the JAX
`training/steps.py` (`voxelize_batch`, `model_inputs` and `eval_step`).

Batch layout (the JAX one); values may be numpy arrays or tensors:
  LiDAR   points [B, P, 5] f32 (x, y, z, intensity, Δt) + points_mask
          [B, P] bool, voxelised here at `caps.max_voxels_eval`; or
          loader-side voxels voxel_feats [B, V, 5] f32 + voxel_coords
          [B, V, 3] int32 (z, y, x; -1 on padding), used as they are
  camera  imgs [B, N_cam, H, W, 3] f32 (normalised); mats
          {sensor2ego_mats, intrin_mats, ida_mats [B, N_cam, 4, 4],
          bda_mat [B, 4, 4]}
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from unidistill_torch.configs.nuscenes import ModelConfig
from unidistill_torch.decode.proposals import generate_proposals
from unidistill_torch.ops.voxelize import voxelize


def _tensor(x: Any, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype)


def voxelize_batch(batch: Dict[str, Any], cfg: ModelConfig, device) -> Dict[str, torch.Tensor]:
    """Voxels + mean VFE of the batch's padded point clouds (eval cap)."""
    caps = cfg.caps
    feats, coords = voxelize(
        _tensor(batch["points"], device), _tensor(batch["points_mask"], device, torch.bool),
        cfg.point_cloud_range, cfg.voxel_size, cfg.grid_size,
        caps.max_voxels_eval, caps.max_points_per_voxel,
    )
    return dict(voxel_feats=feats, voxel_coords=coords)


def model_inputs(batch: Dict[str, Any], cfg: ModelConfig, device) -> Dict[str, Any]:
    device = torch.device(device)
    kw: Dict[str, Any] = {}
    if cfg.with_lidar:
        if "voxel_feats" in batch:
            kw.update(voxel_feats=_tensor(batch["voxel_feats"], device),
                      voxel_coords=_tensor(batch["voxel_coords"], device, torch.int32))
        else:
            kw.update(voxelize_batch(batch, cfg, device))
    if cfg.with_camera:
        kw.update(imgs=_tensor(batch["imgs"], device),
                  mats={k: _tensor(v, device) for k, v in batch["mats"].items()})
    return kw


@torch.no_grad()
def eval_step(model, batch: Dict[str, Any], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Eval forward + decode. Returns the fixed-size ROI dict (boxes [B, R, 9],
    scores, labels (1-based), mask)."""
    if model.training:
        raise ValueError("eval_step needs the model in eval mode (model.eval())")
    device = next(model.parameters()).device
    out = model(**model_inputs(batch, cfg, device))
    return generate_proposals(
        out["multi_head_features"], cfg.proposal, cfg.tasks,
        cfg.point_cloud_range[:2], cfg.voxel_size[:2], cfg.out_size_factor,
        training=False,
    )
