"""Rotated-BEV-IoU greedy NMS with fixed shapes.

Counterpart of the JAX package's `ops/nms.py`. Boxes are (x, y, z, dx, dy,
dz, rot) rows, lanes already sorted by NMS score with invalid rows last;
the IoU works on the BEV part (cx, cy, dx, dy, rot).

On CUDA tensors:
  * `rotated_iou_bev` launches kernel K2 in float mode ([L, M, N] IoU);
  * `nms_bev_batched` runs the custom ops `unidistill::rotated_iou_mask`,
    kernel K2 in mask mode (the upper triangle of
    `(iou > thr) & valid[j]` packed into 64-bit words [L, C, C/64], the
    layout of mmdet3d's `iou3d_nms_cuda`; at thr >= 0 it clips only the
    pairs that `pairs_to_clip_plain` keeps, since the others have IoU 0),
    then `unidistill::nms_greedy_select`, kernel K3, the serial greedy
    walk, one warp per lane.
On CPU tensors they run the plain versions below, which repeat the kernels'
arithmetic in PyTorch (`_clip_contrib_2d` of the JAX package term for term).
`nms_bev` is the single-lane serial oracle and is plain only.
"""
from __future__ import annotations

from typing import Tuple

import torch

from unidistill_torch.kernels import build

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
K2_THR_BAND = 1e-5


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


def _check_cuda(name: str, t: torch.Tensor, dtype: torch.dtype, shape) -> None:
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def rotated_iou_cuda(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Kernel K2, float mode: [L, M, 5] x [L, N, 5] f32 -> [L, M, N] f32."""
    L, M = boxes_a.shape[:2]
    N = boxes_b.shape[1]
    _check_cuda("boxes_a", boxes_a, torch.float32, (L, M, 5))
    _check_cuda("boxes_b", boxes_b, torch.float32, (L, N, 5))
    out = torch.empty(L, M, N, dtype=torch.float32, device=boxes_a.device)
    err = build.library("nms").rotated_iou_f32(
        boxes_a.data_ptr(), boxes_b.data_ptr(), out.data_ptr(), L, M, N,
        torch.cuda.current_stream(boxes_a.device).cuda_stream,
    )
    build.check(err, "rotated_iou_f32")
    build.LAUNCHES["rotated_iou"] += 1
    return out


def rotated_iou_bev(boxes_a: torch.Tensor, boxes_b: torch.Tensor) -> torch.Tensor:
    """Pairwise rotated BEV IoU: [M, 5] x [N, 5] -> [M, N], or lanes
    [L, M, 5] x [L, N, 5] -> [L, M, N]."""
    batched = boxes_a.dim() == 3
    if not batched:
        boxes_a, boxes_b = boxes_a[None], boxes_b[None]
    if boxes_a.is_cuda:
        out = rotated_iou_cuda(boxes_a.float().contiguous(), boxes_b.float().contiguous())
    else:
        out = rotated_iou_bev_plain(boxes_a, boxes_b)
    return out if batched else out[0]


def iou_over_plain(bev: torch.Tensor, valid: torch.Tensor, thr: float) -> torch.Tensor:
    """Plain version of K2's mask mode, unpacked: bool [L, C, C], true where
    j > i, valid[j] and iou(i, j) > thr."""
    C = bev.shape[1]
    iou = rotated_iou_bev_plain(bev, bev)
    ar = torch.arange(C, device=bev.device)
    tri = ar[:, None] < ar[None, :]
    return (iou > thr) & valid[:, None, :] & tri[None]


def _reach_terms(bev: torch.Tensor):
    """Per box, what K2's pair filter reads (`reach_terms` in csrc/nms.cu):
    centre, cos and sin of the yaw, half-extents and the scale
    |cx| + |cy| + |dx| + |dy| (inf for a box that is not tame)."""
    cx, cy, dx, dy, r = bev.float().unbind(-1)
    adx, ady = dx.abs(), dy.abs()
    scale = cx.abs() + cy.abs() + adx + ady
    tame = (torch.minimum(adx, ady) >= _TAME * (1.0 + cx.abs() + cy.abs())) & (scale < _MAX_SCALE)
    scale = torch.where(tame, scale, torch.full_like(cx, float("inf")))
    return dict(cx=cx, cy=cy, cos=torch.cos(r), sin=torch.sin(r), hx=adx * 0.5, hy=ady * 0.5, scale=scale)


def pairs_to_clip_plain(bev: torch.Tensor, valid: torch.Tensor, thr: float) -> torch.Tensor:
    """K2's pair filter, plain: bool [L, C, C], true for the pairs (i, j) that
    the mask mode clips: j > i, valid[j], and at thr >= 0 boxes that no axis
    of either separates by more than the margin (`may_meet` in csrc/nms.cu,
    the same float arithmetic). Every other pair has IoU exactly 0, so bit
    0. Used by the tests and to count the kernel's clipped pairs; no path
    on the card runs it."""
    C = bev.shape[1]
    ar = torch.arange(C, device=bev.device)
    out = (ar[:, None] < ar[None, :])[None] & valid[:, None, :]
    if not thr >= 0:
        return out
    t = _reach_terms(bev)
    a = {k: v[:, :, None] for k, v in t.items()}
    b = {k: v[:, None, :] for k, v in t.items()}
    ss = a["scale"] + b["scale"]
    m = _MARGIN + _REL_MARGIN * ss
    ddx, ddy = b["cx"] - a["cx"], b["cy"] - a["cy"]
    co = (a["cos"] * b["cos"] + a["sin"] * b["sin"]).abs()
    si = (a["sin"] * b["cos"] - a["cos"] * b["sin"]).abs()
    out &= ~((ddx * a["cos"] + ddy * a["sin"]).abs() > a["hx"] + b["hx"] * co + b["hy"] * si + m)
    out &= ~((ddy * a["cos"] - ddx * a["sin"]).abs() > a["hy"] + b["hx"] * si + b["hy"] * co + m)
    out &= ~((ddx * b["cos"] + ddy * b["sin"]).abs() > b["hx"] + a["hx"] * co + a["hy"] * si + m)
    out &= ~((ddy * b["cos"] - ddx * b["sin"]).abs() > b["hy"] + a["hx"] * si + a["hy"] * co + m)
    return out


def pack_mask_bits(over: torch.Tensor) -> torch.Tensor:
    """bool [L, C, C] -> int64 words [L, C, C/64]; bit j of word w is column
    64 w + j (the bit pattern of K2's uint64 output)."""
    L, C, _ = over.shape
    bits = torch.ones((), dtype=torch.int64, device=over.device) << torch.arange(
        _WORD, dtype=torch.int64, device=over.device)
    return (over.reshape(L, C, C // _WORD, _WORD).long() * bits).sum(-1)


def unpack_mask_bits(words: torch.Tensor) -> torch.Tensor:
    """int64 words [L, C, C/64] -> bool [L, C, C]."""
    L, C, W = words.shape
    sh = torch.arange(_WORD, dtype=torch.int64, device=words.device)
    return ((words[..., None] >> sh) & 1).bool().reshape(L, C, W * _WORD)


def rotated_iou_mask_cuda(bev: torch.Tensor, valid: torch.Tensor, thr: float) -> torch.Tensor:
    """Kernel K2, mask mode: bev [L, C, 5] f32, valid [L, C] bool, C % 64 == 0
    -> int64 words [L, C, C/64] holding the uint64 bit pattern. Equals
    `pack_mask_bits(iou_over_plain(...))` wherever the IoU lies outside
    K2_THR_BAND of thr."""
    L, C = bev.shape[:2]
    if C % _WORD:
        raise ValueError(f"rotated_iou_mask: C={C} must be a multiple of {_WORD}")
    _check_cuda("bev", bev, torch.float32, (L, C, 5))
    _check_cuda("valid", valid, torch.bool, (L, C))
    words = torch.empty(L, C, C // _WORD, dtype=torch.int64, device=bev.device)
    err = build.library("nms").rotated_iou_mask(
        bev.data_ptr(), valid.data_ptr(), words.data_ptr(), L, C, float(thr),
        torch.cuda.current_stream(bev.device).cuda_stream,
    )
    build.check(err, "rotated_iou_mask")
    build.LAUNCHES["rotated_iou_mask"] += 1
    return words


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


def nms_greedy_select_cuda(words: torch.Tensor, valid: torch.Tensor,
                           post_max_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K3: words [L, C, C/64] from K2, valid [L, C] bool ->
    keep_idx [L, post] int32 (padded with C), keep_mask [L, post] bool."""
    L, C = valid.shape
    if C % _WORD:
        raise ValueError(f"nms_greedy_select: C={C} must be a multiple of {_WORD}")
    _check_cuda("words", words, torch.int64, (L, C, C // _WORD))
    _check_cuda("valid", valid, torch.bool, (L, C))
    if not 0 < post_max_size <= C:
        raise ValueError(f"post_max_size={post_max_size} must be in (0, {C}]")
    keep_idx = torch.empty(L, post_max_size, dtype=torch.int32, device=valid.device)
    keep_mask = torch.empty(L, post_max_size, dtype=torch.bool, device=valid.device)
    err = build.library("nms").nms_greedy_select(
        words.data_ptr(), valid.data_ptr(), keep_idx.data_ptr(),
        keep_mask.data_ptr(), L, C, post_max_size,
        torch.cuda.current_stream(valid.device).cuda_stream,
    )
    build.check(err, "nms_greedy_select")
    build.LAUNCHES["nms_greedy_select"] += 1
    return keep_idx, keep_mask


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


@torch.library.custom_op("unidistill::rotated_iou_mask", mutates_args=(), device_types="cuda")
def rotated_iou_mask_op(bev: torch.Tensor, valid: torch.Tensor, thr: float) -> torch.Tensor:
    """K2 in mask mode (`rotated_iou_mask_cuda`): int64 words [L, C, C/64]."""
    return rotated_iou_mask_cuda(bev, valid, thr)


@rotated_iou_mask_op.register_kernel("cpu")
def _rotated_iou_mask_cpu(bev, valid, thr):
    return pack_mask_bits(iou_over_plain(bev, valid, thr))


@rotated_iou_mask_op.register_fake
def _rotated_iou_mask_fake(bev, valid, thr):
    L, C = valid.shape
    return bev.new_empty(L, C, C // _WORD, dtype=torch.int64)


@torch.library.custom_op("unidistill::nms_greedy_select", mutates_args=(), device_types="cuda")
def nms_greedy_select_op(words: torch.Tensor, valid: torch.Tensor,
                         post_max_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3 (`nms_greedy_select_cuda`): keep_idx [L, post] int32, keep_mask
    [L, post] bool."""
    return nms_greedy_select_cuda(words, valid, post_max_size)


@nms_greedy_select_op.register_kernel("cpu")
def _nms_greedy_select_cpu(words, valid, post_max_size):
    return greedy_select_plain(unpack_mask_bits(words), valid, post_max_size)


@nms_greedy_select_op.register_fake
def _nms_greedy_select_fake(words, valid, post_max_size):
    L = valid.shape[0]
    return (valid.new_empty(L, post_max_size, dtype=torch.int32),
            valid.new_empty(L, post_max_size, dtype=torch.bool))


def nms_bev_batched(
    boxes: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    post_max_size: int,
    cap: int = 512,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched greedy rotated-BEV NMS over independent lanes.

    boxes [L, K, 7] sorted per lane, valid [L, K] bool. Only the first
    C = min(cap, K) rows take part, padded to a multiple of 64 with invalid
    rows. Returns keep_idx [L, post_max_size] int32 (padded with the padded
    C) and keep_mask [L, post_max_size] bool.
    """
    bev, v = _candidate_lanes(boxes, valid, post_max_size, cap)
    words = torch.ops.unidistill.rotated_iou_mask(bev, v, float(iou_threshold))
    return torch.ops.unidistill.nms_greedy_select(words, v, post_max_size)


def nms_bev(
    boxes: torch.Tensor,
    scores: torch.Tensor,
    valid: torch.Tensor,
    iou_threshold: float,
    post_max_size: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Serial greedy NMS over one lane [K, 7], rows sorted by score (the
    reference semantics oracle; plain PyTorch on any device)."""
    K = boxes.shape[0]
    bev = bev_boxes(boxes.float())[None]
    suppress_from = (rotated_iou_bev_plain(bev, bev)[0] > iou_threshold) & valid[None, :]
    alive = valid.clone()
    for i in range(K):
        if alive[i]:
            sup = suppress_from[i].clone()
            sup[i] = False
            alive &= ~sup
    keep_idx, keep_mask = keep_select_plain(alive[None], post_max_size)
    return keep_idx[0], keep_mask[0]
