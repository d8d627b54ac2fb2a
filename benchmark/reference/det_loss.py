"""Detection losses of the IoU-aware CenterHead; counterpart of the JAX
`losses/det.py`, on the port's NCHW head maps.

Kept from the JAX functions (and the reference they mirror):
  * the focal loss sees heatmaps already sigmoided and clamped to
    [1e-4, 1 − 1e-4];
  * the axis-aligned 3D IoU indexes the decoded (dx, dy, dz) as [0], [2],
    [1] for its x, y, z extents (a quirk of the reference's checkpoints);
  * the IoU-aware target is computed from the predicted box under a stop
    gradient;
  * value-dependent branches (`num_pos == 0`, `loc_loss < 1`) are
    `torch.where` on device tensors: nothing is read back to the host.
`center_head_loss` returns the sigmoided heads as a new list and leaves the
model's outputs as they are.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch



def clamped_sigmoid(x: torch.Tensor, lo: float = 1e-4) -> torch.Tensor:
    return torch.clamp(torch.sigmoid(x), lo, 1.0 - lo)


def focal_loss(pred: torch.Tensor, gt: torch.Tensor, alpha: float, gamma: float) -> torch.Tensor:
    """CornerNet-style focal loss; pred: probabilities, gt: one-hot heatmap."""
    pos = (gt == 1.0).float()
    neg = (gt == 0.0).float()
    pos_loss = torch.log(pred) * torch.pow(1 - pred, gamma) * pos * alpha
    neg_loss = torch.log(1 - pred + 1e-4) * torch.pow(pred, gamma) * neg * (1 - alpha)
    num_pos = pos.sum()
    total = pos_loss.sum() + neg_loss.sum()
    return torch.where(num_pos == 0, -neg_loss.sum(), -total / num_pos.clamp_min(1e-12))


def gather_feat(feat: torch.Tensor, ind: torch.Tensor) -> torch.Tensor:
    """feat [B, C, H, W], ind [B, P] flat (y·W + x) -> [B, P, C]."""
    B, C = feat.shape[:2]
    flat = feat.reshape(B, C, -1)
    return torch.gather(flat, 2, ind.long()[:, None, :].expand(B, C, ind.shape[1])).permute(0, 2, 1)


def reg_loss(pred: torch.Tensor, mask: torch.Tensor, ind: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Masked L1 per code dim, summed over batch and objects, over the
    positive count. pred [B, D, H, W]; target [B, P, D]. Returns [D]."""
    p = gather_feat(pred, ind)
    num = mask.float().sum()
    finite = torch.isfinite(target)
    m = mask.float()[..., None] * finite.float()
    t = torch.where(finite, target, torch.zeros_like(target))
    return torch.abs(p * m - t * m).sum((0, 1)) / (num + 1e-4)


def automatic_weighted_loss(params: torch.Tensor, losses: List[torch.Tensor]) -> torch.Tensor:
    """Uncertainty weighting: Σ 0.5/p_i²·L_i + log(1 + p_i²)."""
    total = 0.0
    for i, loss in enumerate(losses):
        total = total + 0.5 / (params[i] ** 2) * loss + torch.log1p(params[i] ** 2)
    return total


def _axis_aligned_3d_iou(t_ox, t_oy, t_whl, t_z, p_ox, p_oy, p_whl, p_z):
    """The reference's extent indexing kept: x <- whl[0], y <- whl[2],
    z <- whl[1]."""
    def overlap(c1, e1, c2, e2):
        return torch.clamp_min(torch.minimum(c1 + e1 / 2, c2 + e2 / 2)
                               - torch.maximum(c1 - e1 / 2, c2 - e2 / 2), 1e-3)

    ix = overlap(p_ox, p_whl[..., 0], t_ox, t_whl[..., 0])
    iy = overlap(p_oy, p_whl[..., 2], t_oy, t_whl[..., 2])
    iz = overlap(p_z, p_whl[..., 1], t_z, t_whl[..., 1])
    inter = ix * iy * iz
    vol_p = torch.clamp_min(p_whl[..., 0] * p_whl[..., 2] * p_whl[..., 1], 1e-3)
    vol_t = torch.clamp_min(t_whl[..., 0] * t_whl[..., 2] * t_whl[..., 1], 1e-3)
    return inter / (vol_p + vol_t - inter)


def _nearest_bev_iou_elementwise(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Paired axis-aligned nearest-BEV IoU; boxes [..., 7] (x, y, z, dx, dy,
    dz, heading)."""
    def aligned(b):
        rot = torch.abs(b[..., 6] - torch.floor(b[..., 6] / torch.pi + 0.5) * torch.pi)
        swap = (rot >= torch.pi / 4)[..., None]
        dims = torch.where(swap, b[..., [4, 3]], b[..., [3, 4]])
        return torch.cat([b[..., 0:2] - dims / 2, b[..., 0:2] + dims / 2], dim=-1)

    a, b = aligned(boxes_a), aligned(boxes_b)
    xlen = torch.clamp_min(torch.minimum(a[..., 2], b[..., 2]) - torch.maximum(a[..., 0], b[..., 0]), 0)
    ylen = torch.clamp_min(torch.minimum(a[..., 3], b[..., 3]) - torch.maximum(a[..., 1], b[..., 1]), 0)
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    inter = xlen * ylen
    return inter / torch.clamp_min(area_a + area_b - inter, 1e-6)


def iou_losses(pred_cat: torch.Tensor, target_encoding: torch.Tensor, ind: torch.Tensor,
               mask: torch.Tensor, stride: int, voxel_size: Tuple[float, float]):
    """IoU regression and IoU-aware prediction losses. pred_cat [B, 11, H, W]
    = (reg 2, height 1, dim 3, rot 2, vel 2, iou 1); target_encoding
    [B, P, 10]. Returns (iou_loss, iou_aware_loss)."""
    pred = gather_feat(pred_cat[:, :10], ind)  # [B, P, 10]

    def decode(e):
        off_x = e[..., 0] * stride * voxel_size[0]
        off_y = e[..., 1] * stride * voxel_size[1]
        whl = torch.clamp(torch.exp(e[..., 3:6]), 0.001, 30.0)
        rot = torch.atan2(e[..., 6], e[..., 7])
        return off_x, off_y, whl, rot, e[..., 2]

    t_ox, t_oy, t_whl, t_rot, t_z = decode(target_encoding)
    p_ox, p_oy, p_whl, p_rot, p_z = decode(pred)
    iou = _axis_aligned_3d_iou(t_ox, t_oy, t_whl, t_z, p_ox, p_oy, p_whl, p_z)
    m = mask.float()
    iou_loss = ((1.0 - torch.clamp(iou, 0.0, 1.0)) * m).sum() / m.sum().clamp_min(1.0)

    t_box = torch.stack([t_ox, t_oy, t_z, t_whl[..., 0], t_whl[..., 1], t_whl[..., 2], t_rot], -1)
    p_box = torch.stack([p_ox, p_oy, p_z, p_whl[..., 0], p_whl[..., 1], p_whl[..., 2], p_rot], -1).detach()
    tar = 2.0 * (_nearest_bev_iou_elementwise(t_box, p_box) - 0.5)
    iou_aware = reg_loss(pred_cat[:, 10:11], mask, ind, tar[..., None]).sum()
    return iou_loss, iou_aware


HEAD_CAT = ("reg", "height", "dim", "rot", "vel", "iou")


def center_head_loss(
    preds: List[Dict[str, torch.Tensor]],
    targets: List[Dict[str, torch.Tensor]],
    awl_params: torch.Tensor,
    code_weights: Tuple[float, ...],
    iou_weight: float,
    stride: int,
    voxel_size: Tuple[float, float],
    focal_alpha: float,
    focal_gamma: float,
):
    """The whole IoU-aware CenterHead loss. Returns (total, metrics, preds with 'hm' replaced by its
    clamped sigmoid)."""
    cw = torch.tensor(code_weights, dtype=torch.float32, device=awl_params.device)
    total = 0.0
    metrics: Dict[str, torch.Tensor] = {}
    new_preds = []
    for tid, (pd, tg) in enumerate(zip(preds, targets)):
        pd = dict(pd, hm=clamped_sigmoid(pd["hm"]))
        new_preds.append(pd)
        hm_loss = focal_loss(pd["hm"], tg["heatmap"], focal_alpha, focal_gamma)
        pred_cat = torch.cat([pd[k] for k in HEAD_CAT], dim=1)  # [B, 11, H, W]
        box_l = reg_loss(pred_cat[:, :10], tg["mask"], tg["ind"], tg["box_encoding"])
        loc_loss = (box_l * cw).sum()
        iou_l, iou_aware_l = iou_losses(pred_cat, tg["box_encoding"], tg["ind"], tg["mask"],
                                        stride, voxel_size)
        task_loss = automatic_weighted_loss(awl_params, [hm_loss, loc_loss, iou_aware_l])
        task_loss = task_loss + torch.where(loc_loss < 1.0, iou_l * iou_weight, torch.zeros_like(iou_l))
        total = total + task_loss
        metrics[f"task_{tid}/hm_loss"] = hm_loss
        metrics[f"task_{tid}/loc_loss"] = loc_loss
        metrics[f"task_{tid}/iou_loss"] = iou_l
        metrics[f"task_{tid}/iou_aware_loss"] = iou_aware_l
        metrics[f"task_{tid}/num_positive"] = tg["mask"].sum()
    return total, metrics, new_preds
