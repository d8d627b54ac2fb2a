"""Rotated-BEV-IoU greedy NMS, plain PyTorch (a frozen copy of the port's
plain versions: `_clip_contrib_2d` clips, the IoU > threshold mask of the
upper pairs, then the serial greedy walk). Lanes of (x, y, z, dx, dy, dz,
rot) rows sorted by NMS score, invalid rows last.
"""
from __future__ import annotations

from typing import Tuple

import torch


_EPS = 1e-8
_PAR = 1e-5  # |den| below PAR·|d| -> the segment is parallel to the half-plane
_BND = 1e-5  # boundary tolerance in meters
_WORD = 64   # rows per mask word
# K2's pair filter (csrc/nms.cu has the argument for each value): the margin
# in metres beside its share of the pair's scale, the least dim of a "tame"
# box per metre of 1 m + |cx| + |cy|, and the largest scale of a tame box
_MARGIN, _REL_MARGIN, _TAME, _MAX_SCALE = 1e-2, 1e-5, 1e-5, 5e3
# a mask bit may differ between K2 and its plain version only where the IoU
# lies within this band of the threshold (libm cos/sin may differ by an ulp)


def _corner_xy_lists(cx, cy, dx, dy, r):
    """ccw corners of rotated rects as two lists of 4 tensors."""
    c, s = torch.cos(r), torch.sin(r)
    hx, hy = dx * 0.5, dy * 0.5
    xs, ys = [], []
    for sx, sy in ((1, 1), (-1, 1), (-1, -1), (1, -1)):
        lx, ly = sx * hx, sy * hy
        xs.append(cx + lx * c - ly * s)
        ys.append(cy + lx * s + ly * c)
    return xs, ys


def _clip_contrib_2d(p0x, p0y, p1x, p1y, qxs, qys, exclude_boundary):
    """Shoelace term of segment p0->p1 clipped to the convex ccw quad."""
    dx = p1x - p0x
    dy = p1y - p0y
    dlen = torch.sqrt(dx * dx + dy * dy) + _EPS
    thresh = -_BND if exclude_boundary else _BND
    zero = torch.zeros((), dtype=dx.dtype, device=dx.device)
    t_lo = zero
    t_hi = zero + 1.0
    par_out = torch.zeros((), dtype=torch.bool, device=dx.device)
    for i in range(4):
        ax, ay = qxs[i], qys[i]
        bx, by = qxs[(i + 1) % 4], qys[(i + 1) % 4]
        ex, ey = bx - ax, by - ay
        elen = torch.sqrt(ex * ex + ey * ey) + _EPS
        nx, ny = -ey / elen, ex / elen  # inward unit normal (ccw quad)
        den = nx * dx + ny * dy
        num = nx * (ax - p0x) + ny * (ay - p0y)
        is_par = torch.abs(den) <= _PAR * dlen
        t = num / torch.where(is_par, zero + 1.0, den)
        t_lo = torch.maximum(t_lo, torch.where(~is_par & (den > 0), t, zero))
        t_hi = torch.minimum(t_hi, torch.where(~is_par & (den < 0), t, zero + 1.0))
        par_out = par_out | (is_par & (num > thresh))
    t0 = torch.clamp(t_lo, 0.0, 1.0)
    t1 = torch.clamp(t_hi, 0.0, 1.0)
    ok = (t1 > t0) & ~par_out
    q0x = p0x + t0 * dx
    q0y = p0y + t0 * dy
    q1x = p0x + t1 * dx
    q1y = p0y + t1 * dy
    return torch.where(ok, q0x * q1y - q0y * q1x, zero)


def rotated_iou_bev_plain(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """[L, M, 5] x [L, N, 5] -> [L, M, N] IoU (plain version of K2)."""
    a = boxes_a.float()[:, :, None, :]
    b = boxes_b.float()[:, None, :, :]
    axs, ays = _corner_xy_lists(*(a[..., i] for i in range(5)))
    bxs, bys = _corner_xy_lists(*(b[..., i] for i in range(5)))
    total = 0.0
    for i in range(4):
        j = (i + 1) % 4
        total = total + _clip_contrib_2d(axs[i], ays[i], axs[j], ays[j], bxs, bys, False)
        total = total + _clip_contrib_2d(bxs[i], bys[i], bxs[j], bys[j], axs, ays, True)
    inter = torch.clamp(0.5 * total, min=0.0)
    area_a = a[..., 2] * a[..., 3]
    area_b = b[..., 2] * b[..., 3]
    return inter / torch.clamp(area_a + area_b - inter, min=_EPS)


def iou_over_plain(bev: torch.Tensor, valid: torch.Tensor, thr: float) -> torch.Tensor:
    """Plain version of K2's mask mode, unpacked: bool [L, C, C], true where
    j > i, valid[j] and iou(i, j) > thr."""
    C = bev.shape[1]
    iou = rotated_iou_bev_plain(bev, bev)
    ar = torch.arange(C, device=bev.device)
    tri = ar[:, None] < ar[None, :]
    return (iou > thr) & valid[:, None, :] & tri[None]


def keep_select_plain(alive: torch.Tensor, post_max_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """First `post_max_size` alive indices per lane, padded with C."""
    L, C = alive.shape
    rank = torch.cumsum(alive.int(), dim=1) - 1
    tgt = torch.where(alive & (rank < post_max_size), rank,
                      torch.full_like(rank, post_max_size)).long()
    keep = torch.full((L, post_max_size + 1), C, dtype=torch.int32, device=alive.device)
    src = torch.arange(C, dtype=torch.int32, device=alive.device).expand(L, C)
    keep.scatter_(1, tgt, src)  # column post_max_size collects the rest
    keep = keep[:, :post_max_size].contiguous()
    return keep, keep < C


def greedy_select_plain(over: torch.Tensor, valid: torch.Tensor,
                        post_max_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K3: serial greedy over the upper-triangular `over`
    [L, C, C] (all lanes at once), then the first `post_max_size` kept rows."""
    alive = valid.clone()
    for i in range(over.shape[1]):
        alive &= ~(over[:, i, :] & alive[:, i:i + 1])
    return keep_select_plain(alive, post_max_size)


def bev_boxes(boxes: torch.Tensor) -> torch.Tensor:
    """[..., 7] (x, y, z, dx, dy, dz, rot) -> [..., 5] (cx, cy, dx, dy, rot)."""
    return torch.cat([boxes[..., 0:2], boxes[..., 3:5], boxes[..., 6:7]], dim=-1)


def _candidate_lanes(boxes, valid, post_max_size, cap):
    """The first C = min(cap, K) rows of each lane as BEV boxes [L, C', 5]
    and valid [L, C'], padded with invalid rows to C' = a multiple of 64."""
    L, K = boxes.shape[:2]
    C = min(cap, K)
    if post_max_size > C:
        raise ValueError(f"post_max_size={post_max_size} exceeds C={C}")
    b = boxes[:, :C].float()
    v = valid[:, :C]
    pad = (-C) % _WORD
    if pad:
        b = torch.cat([b, b.new_zeros(L, pad, b.shape[-1])], dim=1)
        v = torch.cat([v, v.new_zeros(L, pad)], dim=1)
    return bev_boxes(b).contiguous(), v.contiguous()


def nms_bev_batched_plain(boxes, valid, iou_threshold, post_max_size, cap=512):
    """Plain version of `nms_bev_batched` (any device)."""
    bev, v = _candidate_lanes(boxes, valid, post_max_size, cap)
    over = iou_over_plain(bev, v, iou_threshold)
    return greedy_select_plain(over, v, post_max_size)


# ---------------------------------------------------------------------------
# the custom ops: `nms_bev_batched` reaches K2 and K3 through these on both
# devices (a CUDA tensor the kernel's wrapper, a CPU tensor its plain
# version, each looked up by name at the call)
# ---------------------------------------------------------------------------


# the reference runs the plain NMS on every device
nms_bev_batched = nms_bev_batched_plain
