"""Points in rotated boxes, counterpart of the JAX `ops/points_in_boxes.py`
(the reference's `roiaware_pool3d` query ops). Boxes are (x, y, z, dx, dy,
dz, heading) with z at the box's centre; plain tensor products on the
tensors' device (no kernel: XLA ops in the JAX package)."""
from __future__ import annotations

import torch


def points_in_boxes_bev(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """points [N, >=2], boxes [M, >=7] -> [M, N] bool: the point lies in
    the box's rotated BEV rectangle (edges included)."""
    px = points[None, :, 0] - boxes[:, None, 0]
    py = points[None, :, 1] - boxes[:, None, 1]
    c = torch.cos(-boxes[:, None, 6])
    s = torch.sin(-boxes[:, None, 6])
    lx = px * c - py * s
    ly = px * s + py * c
    return (lx.abs() <= boxes[:, None, 3] / 2) & (ly.abs() <= boxes[:, None, 4] / 2)


def points_in_boxes_3d(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """[M, N] bool, the z extent included."""
    dz = points[None, :, 2] - boxes[:, None, 2]
    return points_in_boxes_bev(points, boxes) & (dz.abs() <= boxes[:, None, 5] / 2)


def remove_points_in_boxes(points: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """[N] bool, True where a point lies in no box (the points to keep)."""
    return ~points_in_boxes_3d(points, boxes).any(dim=0)
