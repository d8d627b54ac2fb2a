"""Train, distill and eval steps of the single-modality detectors;
counterpart of the JAX `training/steps.py` (`voxelize_batch`,
`model_inputs`, `detector_loss`, `train_step`, `distill_train_step`,
`eval_step`).

Batch layout (the JAX one); values may be numpy arrays or tensors:
  LiDAR   points [B, P, 5] f32 (x, y, z, intensity, Δt) + points_mask
          [B, P] bool, voxelised here at `caps.max_voxels_train` in training
          and `caps.max_voxels_eval` otherwise (the JAX caps); or
          loader-side voxels voxel_feats [B, V, 5] f32 + voxel_coords
          [B, V, 3] int32 (z, y, x; -1 on padding), used as they are
  camera  imgs [B, N_cam, H, W, 3] f32 (normalised); mats
          {sensor2ego_mats, intrin_mats, ida_mats [B, N_cam, 4, 4],
          bda_mat [B, 4, 4]}
  train   gt_boxes [B, G, 10] f32 (x, y, z, dx, dy, dz, rot, vx, vy, cls
          1-based; zero rows pad)

A train step runs the model in train mode (BatchNorm on batch statistics,
which it moves into its running statistics), the loss, the backward and one
optimizer update, and returns a dict of 0-d device tensors; `metrics_to_host`
reads them back in one transfer. Nothing inside a step reads a device value
on the host (the LiDAR teacher's rulebooks excepted: their sizes are data).
"""
from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .config import DistillConfig, ModelConfig
from .proposals import generate_proposals
from .det_loss import center_head_loss
from .distill_loss import (
    bev_distill_loss,
    feature_distill_loss,
    gt_corners_bev,
    response_distill_loss,
)
from .voxelize import voxelize
from .assigner import assign_targets
from .optim import Optimizer, TrainState


def _tensor(x: Any, device: torch.device, dtype=torch.float32) -> torch.Tensor:
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    return t.to(device=device, dtype=dtype)


def voxelize_batch(batch: Dict[str, Any], cfg: ModelConfig, device, training: bool) -> Dict[str, torch.Tensor]:
    """Voxels + mean VFE of the batch's padded point clouds, at the train
    voxel cap when `training`, else at the eval cap."""
    caps = cfg.caps
    feats, coords = voxelize(
        _tensor(batch["points"], device), _tensor(batch["points_mask"], device, torch.bool),
        cfg.point_cloud_range, cfg.voxel_size, cfg.grid_size,
        caps.max_voxels_train if training else caps.max_voxels_eval, caps.max_points_per_voxel,
    )
    return dict(voxel_feats=feats, voxel_coords=coords)


def model_inputs(batch: Dict[str, Any], cfg: ModelConfig, device, training: bool) -> Dict[str, Any]:
    device = torch.device(device)
    kw: Dict[str, Any] = {}
    if cfg.with_lidar:
        if "voxel_feats" in batch:
            kw.update(voxel_feats=_tensor(batch["voxel_feats"], device),
                      voxel_coords=_tensor(batch["voxel_coords"], device, torch.int32))
        else:
            kw.update(voxelize_batch(batch, cfg, device, training))
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
    out = model(**model_inputs(batch, cfg, device, training=False))
    return generate_proposals(
        out["multi_head_features"], cfg.proposal, cfg.tasks,
        cfg.point_cloud_range[:2], cfg.voxel_size[:2], cfg.out_size_factor,
        training=False,
    )


def detector_loss(out: Dict, gt_boxes: torch.Tensor, cfg: ModelConfig):
    """Targets from the GT boxes, then the CenterHead loss. Returns (loss, metrics, heads with the
    clamped-sigmoid heatmap)."""
    targets = assign_targets(gt_boxes, cfg.assigner, cfg.tasks, cfg.grid_size,
                             cfg.point_cloud_range, cfg.voxel_size)
    return center_head_loss(
        out["multi_head_features"], targets, out["awl_params"],
        cfg.det_head.code_weights, cfg.det_head.iou_weight, cfg.out_size_factor,
        cfg.voxel_size[:2], cfg.det_head.focal_alpha, cfg.det_head.focal_gamma,
    )


def _update(state: TrainState, loss: torch.Tensor, optimizer: Optimizer, metrics: Dict) -> Dict:
    """Backward and the optimizer's update."""
    optimizer.zero_grad()
    loss.backward()
    metrics["grad_norm"] = optimizer.step(state.step)
    metrics["loss"] = loss.detach()
    state.step += 1
    return {k: v.detach() for k, v in metrics.items()}


def train_step(state: TrainState, batch: Dict[str, Any], model, optimizer: Optimizer,
               cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """One detector step: forward in train mode, CenterHead loss, backward,
    optimizer update. Returns the metrics (0-d
    tensors on the device)."""
    device = next(model.parameters()).device
    model.train()
    out = model(**model_inputs(batch, cfg, device, training=True))
    loss, metrics, _ = detector_loss(out, _tensor(batch["gt_boxes"], device), cfg)
    return _update(state, loss, optimizer, metrics)


def distill_train_step(state: TrainState, batch: Dict[str, Any], student, teacher,
                       optimizer: Optimizer, student_cfg: ModelConfig, teacher_cfg: ModelConfig,
                       dcfg: DistillConfig) -> Dict[str, torch.Tensor]:
    """Teacher -> student step: total = det + w_feature·feature + w_rel·bev_rel
    + w_resp·(resp_cls + resp_reg). The
    teacher runs frozen, in eval mode under no_grad, on the eval voxel cap;
    the student trains on the train cap (each voxelises the batch itself)."""
    device = next(student.parameters()).device
    teacher.eval()
    with torch.no_grad():
        t_out = teacher(**model_inputs(batch, teacher_cfg, device, training=False))
    student.train()
    out = student(**model_inputs(batch, student_cfg, device, training=True))
    total, metrics = distill_loss(out, t_out, batch, student_cfg, dcfg)
    return _update(state, total, optimizer, metrics)


def distill_loss(out: Dict, t_out: Dict, batch: Dict[str, Any], student_cfg: ModelConfig,
                 dcfg: DistillConfig):
    """The student's outputs `out` against the teacher's `t_out`: (total,
    metrics)."""
    device = out["awl_params"].device
    gt = _tensor(batch["gt_boxes"], device)
    gt_mask = gt.abs().sum(-1) > 0
    corners = gt_corners_bev(gt, student_cfg.point_cloud_range, student_cfg.voxel_size,
                             student_cfg.out_size_factor)
    det_loss, metrics, preds_sig = detector_loss(out, gt, student_cfg)
    l_feat = feature_distill_loss(out["model_output"], t_out["model_output"], corners, gt_mask)
    l_rel = bev_distill_loss(out["bev_feature"], t_out["bev_feature"], corners, gt_mask)
    l_cls, l_reg = response_distill_loss(
        preds_sig, t_out["multi_head_features"], gt, student_cfg.point_cloud_range,
        student_cfg.voxel_size, student_cfg.out_size_factor, dcfg.teacher_hm_temp,
        dcfg.teacher_hm_clamp,
    )
    total = det_loss + dcfg.w_feature * l_feat + dcfg.w_rel * l_rel + dcfg.w_resp * (l_cls + l_reg)
    metrics.update(loss_feature=l_feat, loss_bev_rel=l_rel, loss_resp_cls=l_cls,
                   loss_resp_reg=l_reg, loss_det=det_loss)
    return total, metrics


def metrics_to_host(metrics: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """The step's metrics as Python floats, in one device-to-host copy."""
    keys = sorted(metrics)
    values = torch.stack([metrics[k].float() for k in keys]).cpu().tolist()
    return dict(zip(keys, values))
