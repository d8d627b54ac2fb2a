"""Eval step of the camera detector; counterpart of the JAX
`training/steps.py` (`model_inputs`, camera part, and `eval_step`).

Batch layout (the JAX one): imgs [B, N_cam, H, W, 3] f32 (normalised);
mats {sensor2ego_mats, intrin_mats, ida_mats [B, N_cam, 4, 4], bda_mat
[B, 4, 4]}. Values may be numpy arrays or tensors.
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from unidistill_torch.configs.nuscenes import ModelConfig
from unidistill_torch.decode.proposals import generate_proposals


def _tensor(x: Any, device: torch.device) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=torch.float32)


def model_inputs(batch: Dict[str, Any], cfg: ModelConfig, device) -> Dict[str, Any]:
    if cfg.with_lidar:
        raise NotImplementedError("LiDAR inputs are not ported yet")
    device = torch.device(device)
    return dict(
        imgs=_tensor(batch["imgs"], device),
        mats={k: _tensor(v, device) for k, v in batch["mats"].items()},
    )


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
