"""UniDistill's three cross-modality distillation losses; counterpart of the
JAX `losses/distill.py`, on the port's NCHW maps.

1. feature: L1 between 9 points (4 corners, the centre, 4 edge midpoints)
   sampled per GT box from the low-level BEV features;
2. BEV relation: L1 between the 9×9 Gram matrices of the L2-normalised
   point features of the high-level BEV map;
3. response: L1 on the heads' 66 regression channels and the max-over-class
   heatmap, under the GT-centred Gaussian mask.

Kept from the JAX functions: the sampling swaps (x, y) before the grid
sample, as the reference does (both maps are sampled alike); the student
heatmap arrives already sigmoided and clamped by its head loss, while the
teacher's is clamp(sigmoid(hm / temp)) here.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch


from .gaussian import box_mask_gaussian
from .grid_sample import grid_sample_2d

RESP_REG = ("reg", "height", "dim", "rot", "vel", "iou")


def gt_corners_bev(gt_boxes: torch.Tensor, pc_range: Tuple[float, ...], voxel_size: Tuple[float, ...],
                   out_size_factor: int) -> torch.Tensor:
    """gt_boxes [B, G, >=7] -> BEV corners [B, G, 4, 2] in feature cells,
    ordered (x0y0, x0y1, x1y1, x1y0) and rotated by the heading."""
    c, s = torch.cos(gt_boxes[..., 6]), torch.sin(gt_boxes[..., 6])
    off = torch.tensor([[-0.5, -0.5], [-0.5, 0.5], [0.5, 0.5], [0.5, -0.5]],
                       dtype=torch.float32, device=gt_boxes.device)
    local = off[None, None] * gt_boxes[..., None, 3:5]  # [B, G, 4, 2]
    x = local[..., 0] * c[..., None] - local[..., 1] * s[..., None]
    y = local[..., 0] * s[..., None] + local[..., 1] * c[..., None]
    cx = (gt_boxes[..., 0:1] + x - pc_range[0]) / (voxel_size[0] * out_size_factor)
    cy = (gt_boxes[..., 1:2] + y - pc_range[1]) / (voxel_size[1] * out_size_factor)
    return torch.stack([cx, cy], dim=-1)


def _nine_point_samples(feat: torch.Tensor, corners: torch.Tensor) -> torch.Tensor:
    """feat [B, C, H, W], corners [B, G, 4, 2] -> [B, G, 9, C]."""
    center = corners.mean(2, keepdim=True)
    mid = [corners[:, :, list(ij)].mean(2, keepdim=True) for ij in ((0, 1), (1, 2), (2, 3), (0, 3))]
    pts = torch.cat([corners, center] + mid, dim=2)  # [B, G, 9, 2]
    H, W = feat.shape[2:]
    gx = (pts[..., 0] - W / 2.0) / (W / 2.0)
    gy = (pts[..., 1] - H / 2.0) / (H / 2.0)
    return grid_sample_2d(feat, torch.stack([gy, gx], dim=-1))  # (x, y) swapped, as the reference


def feature_distill_loss(feat_student: torch.Tensor, feat_teacher: torch.Tensor,
                         corners: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    s = _nine_point_samples(feat_student, corners)
    t = _nine_point_samples(feat_teacher, corners)
    l1 = (s - t).abs().mean(-1).mean(-1)  # [B, G]
    m = gt_mask.float()
    return (l1 * m).sum() / (m.sum() + 1e-4)


def bev_distill_loss(bev_student: torch.Tensor, bev_teacher: torch.Tensor,
                     corners: torch.Tensor, gt_mask: torch.Tensor) -> torch.Tensor:
    def gram(feat):
        x = _nine_point_samples(feat, corners)  # [B, G, 9, C]
        x = x / (torch.linalg.vector_norm(x, dim=-1, keepdim=True) + 1e-4)
        return torch.einsum("bgic,bgjc->bgij", x, x)

    l1 = (gram(bev_student) - gram(bev_teacher)).abs().mean(-1).mean(-1)
    m = gt_mask.float()
    return (l1 * m).sum() / (m.sum() + 1e-4)


def response_distill_loss(resp_student: List[Dict[str, torch.Tensor]],
                          resp_teacher: List[Dict[str, torch.Tensor]],
                          gt_boxes: torch.Tensor, pc_range, voxel_size, out_size_factor: int,
                          teacher_hm_temp: float = 2.0, teacher_hm_clamp: float = 1e-4):
    """Returns (cls, reg)."""
    def cat_reg(resp):
        return torch.cat([r[k] for r in resp for k in RESP_REG], dim=1)  # [B, 66, H, W]

    cls_s = torch.cat([r["hm"] for r in resp_student], dim=1)
    cls_t = torch.cat([torch.clamp(1.0 / (1.0 + torch.exp(-r["hm"] / teacher_hm_temp)),
                                   teacher_hm_clamp, 1.0 - teacher_hm_clamp) for r in resp_teacher], dim=1)
    reg_s, reg_t = cat_reg(resp_student), cat_reg(resp_teacher)
    H, W = reg_s.shape[2:]
    mask = box_mask_gaussian(gt_boxes, (H, W), pc_range, voxel_size, out_size_factor)  # [B, H, W]
    diff_reg = (reg_s - reg_t).abs().mean(1) * mask
    diff_cls = (cls_s.amax(1) - cls_t.amax(1)).abs() * mask
    weight = mask.sum()
    return diff_cls.sum() / (weight + 1e-4), diff_reg.sum() / (weight + 1e-4)
