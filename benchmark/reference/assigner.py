"""Center target assigner; counterpart of the JAX `targets/assigner.py`
(`assign_targets`), in plain PyTorch on the batch's device, with no host
read-back.

Per task:
  * anchors on the stride-8 grid, anchor n = (x = (n % W)·8, y = (n // W)·8)
    in voxel units;
  * positives: the union over the task's GT boxes of each box's 9 anchors
    nearest its centre, found in the 4×4 window of grid points that brackets
    the centre, by a stable sort on (distance, anchor id) so that ties
    break towards the lower anchor id as the JAX `lax.sort` does;
  * each positive anchor regresses its nearest task GT (argmin, first on
    ties); a sample without a GT of the task has no positives (`has_gt`);
  * encoding [dx/8, dy/8, z, log dx, log dy, log dz, sin r, cos r, vx, vy]
    with r wrapped to [-π, π); non-finite values set to 0;
  * positives compacted into `max_pos` slots in anchor order by their
    cumsum rank; positives past the cap are dropped.

Returns per task: heatmap [B, ncls, H, W] (NCHW, the port's head layout),
ind [B, P] (y·W + x), mask [B, P] bool, box_encoding [B, P, 10],
cat [B, P] (class within the task), with P = cfg.max_pos.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .config import CLASS_TO_IDX, AssignerConfig


def limit_period(val: torch.Tensor, offset: float = 0.5, period: float = 2 * math.pi) -> torch.Tensor:
    return val - torch.floor(val / period + offset) * period


def _compact(values: torch.Tensor, slot: torch.Tensor, P: int) -> torch.Tensor:
    """values [B, ANC, ...] scattered to their slots [B, ANC] (P = dropped)
    -> [B, P, ...]; empty slots are 0."""
    B = values.shape[0]
    out = values.new_zeros((B, P + 1) + tuple(values.shape[2:]))
    idx = slot.reshape(slot.shape + (1,) * (values.dim() - 2)).expand_as(values)
    return out.scatter_(1, idx, values)[:, :P]


def assign_targets(
    gt_boxes: torch.Tensor,
    cfg: AssignerConfig,
    tasks: Tuple[Tuple[str, ...], ...],
    grid_size: Tuple[int, int, int],
    pc_range: Tuple[float, ...],
    voxel_size: Tuple[float, ...],
) -> List[Dict[str, torch.Tensor]]:
    """gt_boxes: [B, G, 10] (x, y, z, dx, dy, dz, rot, vx, vy, cls) float32,
    cls 1-based, zero rows as padding."""
    B, G, _ = gt_boxes.shape
    dev = gt_boxes.device
    osf = cfg.out_size_factor
    W = grid_size[0] // osf
    H = grid_size[1] // osf
    ANC = H * W
    P = cfg.max_pos

    n = torch.arange(ANC, dtype=torch.int32, device=dev)
    ax = (n % W).float() * osf
    ay = torch.div(n, W, rounding_mode="floor").float() * osf

    boxes = gt_boxes[..., :9]
    cls = gt_boxes[..., 9].to(torch.int32)
    valid = gt_boxes.abs().sum(-1) > 0  # [B, G]
    cx = (boxes[..., 0] - pc_range[0]) / voxel_size[0]
    cy = (boxes[..., 1] - pc_range[1]) / voxel_size[1]
    d2 = (ax[None, None] - cx[..., None]) ** 2 + (ay[None, None] - cy[..., None]) ** 2  # [B, G, ANC]

    # the 9 nearest grid points lie in the 4×4 window that brackets the centre
    gx0 = torch.floor(cx / osf - 1.0).to(torch.int32).clamp(0, W - 4)
    gy0 = torch.floor(cy / osf - 1.0).to(torch.int32).clamp(0, H - 4)
    r4 = torch.arange(4, dtype=torch.int32, device=dev)
    wy = gy0[..., None, None] + r4[:, None]  # [B, G, 4, 1]
    wx = gx0[..., None, None] + r4[None, :]  # [B, G, 1, 4]
    aid = (wy * W + wx).reshape(B, G, 16)  # ascending anchor ids
    d2w = ((wx.float() * osf - cx[..., None, None]) ** 2
           + (wy.float() * osf - cy[..., None, None]) ** 2).reshape(B, G, 16)
    order = torch.sort(d2w, dim=2, stable=True).indices
    topk_idx = torch.gather(aid, 2, order[..., : cfg.topk]).long()  # [B, G, topk]

    enc_rot = limit_period(boxes[..., 6])
    out = []
    for task_classes in tasks:
        ids = torch.tensor([CLASS_TO_IDX[c] for c in task_classes], dtype=torch.int32, device=dev)
        local = cls[..., None] == ids  # [B, G, ncls]
        is_task = local.any(-1) & valid  # [B, G]
        local_cls = local.int().argmax(-1)  # [B, G], first match

        ok = is_task[..., None].expand_as(topk_idx)
        pos = torch.zeros(B, ANC, dtype=torch.int32, device=dev).scatter_reduce_(
            1, torch.where(ok, topk_idx, 0).reshape(B, -1), ok.int().reshape(B, -1), reduce="amax")
        has_gt = is_task.any(1)  # no GT of the task -> no positives
        pos_mask = (pos > 0) & has_gt[:, None]

        d2_task = torch.where(is_task[..., None], d2, torch.full_like(d2, math.inf))
        g = torch.argmin(d2_task, dim=1)  # [B, ANC]
        a_cat = torch.gather(local_cls, 1, g)  # [B, ANC]
        hm = F.one_hot(a_cat, len(task_classes)).float() * pos_mask[..., None]
        heatmap = hm.permute(0, 2, 1).reshape(B, len(task_classes), H, W)

        gb = torch.gather(boxes, 1, g[..., None].expand(B, ANC, 9))  # [B, ANC, 9]
        rot = torch.gather(enc_rot, 1, g)
        enc = torch.stack([
            (torch.gather(cx, 1, g) - ax) / osf,
            (torch.gather(cy, 1, g) - ay) / osf,
            gb[..., 2],
            torch.log(gb[..., 3]),
            torch.log(gb[..., 4]),
            torch.log(gb[..., 5]),
            torch.sin(rot),
            torch.cos(rot),
            gb[..., 7],
            gb[..., 8],
        ], dim=-1)  # [B, ANC, 10]
        enc = torch.where(torch.isfinite(enc), enc, torch.zeros_like(enc))

        rank = torch.cumsum(pos_mask.int(), dim=1) - 1
        slot = torch.where(pos_mask & (rank < P), rank, P).long()
        out.append(dict(
            heatmap=heatmap,
            ind=_compact(n[None].expand(B, ANC), slot, P),
            mask=_compact(pos_mask, slot, P),
            box_encoding=_compact(enc, slot, P),
            cat=_compact(a_cat.int(), slot, P),
        ))
    return out
