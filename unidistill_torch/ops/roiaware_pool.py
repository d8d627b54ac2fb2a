"""RoI-aware 3D pooling, counterpart of the JAX `ops/roiaware_pool.py` (the
reference's `roiaware_pool3d` extension).

For each ROI box (x, y, z, dx, dy, dz, heading) the points are rotated into
the box's frame, binned into an (out_x, out_y, out_z) grid over the box
(floor of (local + d/2) / (d / out), clipped to the grid; points on the
box's faces count as inside), and each cell's features are max- or
avg-pooled; empty cells are 0. As in JAX, no cap on the points of a cell
(the CUDA extension keeps at most 128), and the avg count is float32 (a
bf16 count stops at 256).

Plain PyTorch on the tensors' device (XLA's segment ops in JAX; no kernel):
only the (ROI, point) pairs inside a box are gathered (`nonzero`, a host
sync on the card), then `scatter_reduce("amax", include_self=False)` or
`index_add_` into the cells. Gradients come from autograd: avg spreads a
cell's gradient over its points, 1/count each; max routes it to the point
that holds the maximum. Where several points of a cell tie for a channel's
maximum, torch splits that channel's gradient evenly among them (a
difference from the CUDA extension, which routes it to one point). On the
card the avg sums add with atomics, in no fixed order.
"""
from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

from unidistill_torch.ops.points_in_boxes import points_in_boxes_3d, points_in_boxes_bev


def _roi_local_coords(rois: torch.Tensor, pts: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """rois [N, 7], pts [P, 3] -> the points in each ROI's frame, (lx, ly,
    lz) each [N, P]."""
    px = pts[None, :, 0] - rois[:, None, 0]
    py = pts[None, :, 1] - rois[:, None, 1]
    pz = pts[None, :, 2] - rois[:, None, 2]
    c = torch.cos(-rois[:, None, 6])
    s = torch.sin(-rois[:, None, 6])
    return px * c - py * s, px * s + py * c, pz


def roi_point_cells(rois: torch.Tensor, pts: torch.Tensor,
                    out_size: Tuple[int, int, int]) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """rois [N, 7], pts [P, 3] -> (roi, pt, cell), one entry per (ROI, point)
    pair with the point inside the ROI: the cell is the flat index
    roi · cells + (vx · out_y + vy) · out_z + vz."""
    ox, oy, oz = out_size
    lx, ly, lz = _roi_local_coords(rois, pts)
    dx, dy, dz = (rois[:, None, i] for i in (3, 4, 5))
    # the cell sizes d / out as a division by a tensor: CUDA divides by a
    # host scalar as a product with its reciprocal, which rounds otherwise
    # (and a point then changes cells)
    sx, sy, sz = (rois[:, 3:6] / rois.new_tensor([ox, oy, oz]))[:, None, :].unbind(-1)
    vx = torch.floor((lx + dx / 2) / sx).clamp(0, ox - 1).long()
    vy = torch.floor((ly + dy / 2) / sy).clamp(0, oy - 1).long()
    vz = torch.floor((lz + dz / 2) / sz).clamp(0, oz - 1).long()
    in_box = (lx.abs() <= dx / 2) & (ly.abs() <= dy / 2) & (lz.abs() <= dz / 2)
    roi, pt = in_box.nonzero(as_tuple=True)
    return roi, pt, roi * (ox * oy * oz) + (vx[roi, pt] * oy + vy[roi, pt]) * oz + vz[roi, pt]


def roiaware_pool3d(rois: torch.Tensor, pts: torch.Tensor, pts_feature: torch.Tensor,
                    out_size: Union[int, Tuple[int, int, int]], pool_method: str = "max") -> torch.Tensor:
    """rois [N, 7], pts [P, 3], pts_feature [P, C] -> pooled
    [N, out_x, out_y, out_z, C] in the features' dtype."""
    if pool_method not in ("max", "avg"):
        raise ValueError(f"pool_method must be max|avg, got {pool_method}")
    ox, oy, oz = (out_size,) * 3 if isinstance(out_size, int) else tuple(out_size)
    n, C = rois.shape[0], pts_feature.shape[-1]
    cells = ox * oy * oz
    _, pt, flat = roi_point_cells(rois, pts, (ox, oy, oz))
    feats = pts_feature[pt]
    if pool_method == "max":
        pooled = feats.new_zeros(n * cells, C).scatter_reduce(
            0, flat[:, None].expand(-1, C), feats, "amax", include_self=False)
    else:
        counts = torch.zeros(n * cells, device=pts.device).index_add_(
            0, flat, torch.ones(flat.shape[0], device=pts.device))
        sums = torch.zeros(n * cells, C, device=pts.device).index_add(0, flat, feats.float())
        pooled = (sums / counts.clamp(min=1.0)[:, None]).to(pts_feature.dtype)
    return pooled.reshape(n, ox, oy, oz, C)


def points_in_boxes_index(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """points [P, 3], boxes [M, 7] -> [P] int32: the first box that holds
    the point (boxes scanned in order), -1 for none."""
    inside = points_in_boxes_3d(points, boxes)
    first = inside.to(torch.uint8).argmax(dim=0).to(torch.int32)
    return torch.where(inside.any(dim=0), first, -1)


def bev_in_boxes(bev_coords: torch.Tensor, boxes: torch.Tensor, bev_range: Sequence[float]) -> torch.Tensor:
    """BEV cells' world xy [X, Y, 2], boxes [M, 7], bev_range (x_min, y_min,
    z_min, x_max, y_max, z_max) -> [X, Y] int32: the first box whose BEV
    rectangle holds the cell, -1 for none or outside the range."""
    x_min, y_min, _, x_max, y_max, _ = bev_range
    xdim, ydim = bev_coords.shape[:2]
    flat = bev_coords.reshape(-1, 2)
    inside = points_in_boxes_bev(flat, boxes)
    in_range = (flat[:, 0] >= x_min) & (flat[:, 0] <= x_max) & (flat[:, 1] >= y_min) & (flat[:, 1] <= y_max)
    first = inside.to(torch.uint8).argmax(dim=0).to(torch.int32)
    return torch.where(inside.any(dim=0) & in_range, first, -1).reshape(xdim, ydim)
