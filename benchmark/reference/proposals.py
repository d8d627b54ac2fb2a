"""Box decoding + IoU-aware rotated NMS -> fixed-size ROIs; counterpart of
the JAX `decode/proposals.py`.

Per task: global top-K over (class, y, x) of the sigmoided heatmap, sub-cell
offsets, exp-clamped dims, atan2 rotation, post-center-range and score
masks, NMS score = score^(1-α)·iou^α. Invalid candidates sort to the bottom
(a stable sort, as `jnp.argsort`). All (task, sample) lanes then go through
one batched NMS (`ops/nms.py`: kernels K2 and K3 on the card).

The head maps are NCHW here ([B, C, H, W]); the outputs are the JAX ones.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .config import ProposalConfig
from .nms import nms_bev_batched


def decode_task(
    pred: Dict[str, torch.Tensor],
    cfg: ProposalConfig,
    task_id: int,
    pc_range: Tuple[float, float],
    voxel_size: Tuple[float, float],
    out_size_factor: int,
    training: bool,
):
    """One task's candidates. pred maps head name -> [B, C, H, W] (hm = raw
    logits). Returns boxes [B, K, 9], scores, nms_scores, labels (0-based in
    the task), valid [B, K], sorted by nms_score descending."""
    K = cfg.nms_pre_max_size_train if training else cfg.nms_pre_max_size_test
    hm = torch.sigmoid(pred["hm"].float())
    B, ncls, H, W = hm.shape
    K = min(K, ncls * H * W)
    scores, inds = torch.topk(hm.reshape(B, ncls * H * W), K, dim=1)
    clses = (inds // (H * W)).to(torch.int32)
    pos = inds % (H * W)
    ys = (pos // W).float()
    xs = (pos % W).float()

    def gat(name):  # [B, C, H, W] -> [B, K, C] at the candidates' cells
        p = pred[name].float().reshape(B, -1, H * W)
        return torch.gather(p, 2, pos[:, None, :].expand(B, p.shape[1], K)).transpose(1, 2)

    reg = gat("reg")
    xs = xs + reg[..., 0]
    ys = ys + reg[..., 1]
    rotp = gat("rot")
    rot = torch.atan2(rotp[..., 0], rotp[..., 1])
    hei = gat("height")[..., 0]
    dim = torch.clamp(torch.exp(gat("dim")), 0.001, 30.0)
    vel = gat("vel")
    iouscore = torch.clamp(gat("iou")[..., 0] / 2.0 + 0.5, 0.0, 1.0)

    alpha = cfg.iou_aware_alpha[task_id]
    nms_scores = torch.pow(scores, 1.0 - alpha) * torch.pow(iouscore, alpha)

    xs = xs * out_size_factor * voxel_size[0] + pc_range[0]
    ys = ys * out_size_factor * voxel_size[1] + pc_range[1]
    boxes = torch.cat([xs[..., None], ys[..., None], hei[..., None], dim, rot[..., None], vel], dim=-1)

    pcl = torch.tensor(cfg.post_center_limit_range, dtype=torch.float32, device=boxes.device)
    in_range = (boxes[..., :3] >= pcl[:3]).all(-1) & (boxes[..., :3] <= pcl[3:]).all(-1)
    valid = in_range & (scores > cfg.score_threshold)

    key = torch.where(valid, -nms_scores, torch.full_like(nms_scores, float("inf")))
    order = torch.argsort(key, dim=-1, stable=True)
    take = lambda a: torch.gather(a, 1, order)
    return (
        torch.gather(boxes, 1, order[..., None].expand(B, K, boxes.shape[-1])),
        take(scores), take(nms_scores), take(clses), take(valid),
    )


def generate_proposals(
    preds: List[Dict[str, torch.Tensor]],
    cfg: ProposalConfig,
    tasks: Tuple[Tuple[str, ...], ...],
    pc_range: Tuple[float, float],
    voxel_size: Tuple[float, float],
    out_size_factor: int,
    training: bool = False,
) -> Dict[str, torch.Tensor]:
    """All tasks -> merged fixed-size ROI buffers: boxes [B, R, 9], scores
    [B, R], labels [B, R] (global, 1-based), mask [B, R]; R = tasks·post_max."""
    thr = cfg.nms_iou_threshold_train if training else cfg.nms_iou_threshold_test
    post = cfg.nms_post_max_size_train if training else cfg.nms_post_max_size_test
    dec = [
        decode_task(preds[tid], cfg, tid, pc_range, voxel_size, out_size_factor, training)
        for tid in range(len(tasks))
    ]
    # per-task K differs on tiny grids: pad every task with invalid rows
    Kmax = max(d[0].shape[1] for d in dec)
    pad = lambda a, v: F.pad(a, (0, 0) * (a.dim() - 2) + (0, Kmax - a.shape[1]), value=v)
    boxes = torch.stack([pad(d[0], 0.0) for d in dec])  # [T, B, K, 9]
    scores = torch.stack([pad(d[1], 0.0) for d in dec])
    clses = torch.stack([pad(d[3], 0) for d in dec])
    valid = torch.stack([pad(d[4], False) for d in dec])
    T, B, K = boxes.shape[:3]
    lanes = lambda a: a.reshape((T * B,) + tuple(a.shape[2:]))
    keep_idx, keep_mask = nms_bev_batched(
        lanes(boxes[..., :7]), lanes(valid), thr, post, cap=cfg.nms_cap
    )  # [T*B, post]
    cap = min(cfg.nms_cap, K)
    gidx = torch.clamp(keep_idx.long(), max=cap - 1)  # clamp, then mask below
    kb = torch.gather(lanes(boxes)[:, :cap], 1, gidx[..., None].expand(-1, -1, boxes.shape[-1]))
    ks = torch.gather(lanes(scores)[:, :cap], 1, gidx)
    kc = torch.gather(lanes(clses)[:, :cap], 1, gidx)

    # per-task global label offsets (labels start from 1)
    offsets = torch.tensor(
        [1 + sum(len(t) for t in tasks[:tid]) for tid in range(len(tasks))],
        dtype=kc.dtype, device=kc.device,
    )
    kl = kc + offsets.repeat_interleave(B)[:, None]

    unlane = lambda a: a.reshape((T, B) + tuple(a.shape[1:]))
    kb, ks, kl, keep_mask = map(unlane, (kb, ks, kl, keep_mask))
    merge = lambda a: torch.cat([a[t] for t in range(T)], dim=1)  # task-major
    return dict(
        boxes=merge(torch.where(keep_mask[..., None], kb, torch.zeros_like(kb))),
        scores=merge(torch.where(keep_mask, ks, torch.zeros_like(ks))),
        labels=merge(torch.where(keep_mask, kl, torch.zeros_like(kl))),
        mask=merge(keep_mask),
    )
