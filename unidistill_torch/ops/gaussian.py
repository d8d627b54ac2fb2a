"""Gaussian response masks of the distillation loss; counterpart of the JAX
`ops/gaussian.py`.

  * radius = floor(min(r1, r2, r3)) of CornerNet's overlap quadratics
    (min_overlap 0.7) on the box's (dx, dy) in feature cells;
  * the Gaussian is centred at the truncated cell (trunc(cx), trunc(cy)),
    has σ = (2r + 1)/6 and the exponent −d²/(2σ² + 1e-12), is cut to
    |dx|, |dy| <= r, and the boxes of a frame combine by an elementwise max;
  * rows that sum to zero are padding.
"""
from __future__ import annotations

import torch


def gaussian_radius(height: torch.Tensor, width: torch.Tensor, min_overlap: float = 0.7) -> torch.Tensor:
    b1 = height + width
    c1 = width * height * (1 - min_overlap) / (1 + min_overlap)
    r1 = (b1 + torch.sqrt(torch.clamp_min(b1 ** 2 - 4 * c1, 0.0))) / 2

    a2 = 4.0
    b2 = 2 * (height + width)
    c2 = (1 - min_overlap) * width * height
    r2 = (b2 + torch.sqrt(torch.clamp_min(b2 ** 2 - 4 * a2 * c2, 0.0))) / 2

    a3 = 4.0 * min_overlap
    b3 = -2 * min_overlap * (height + width)
    c3 = (min_overlap - 1) * width * height
    r3 = (b3 + torch.sqrt(torch.clamp_min(b3 ** 2 - 4 * a3 * c3, 0.0))) / 2
    return torch.minimum(torch.minimum(r1, r2), r3)


def box_mask_gaussian(gt_boxes: torch.Tensor, hw, pc_range, voxel_size, out_size_scale: int) -> torch.Tensor:
    """gt_boxes [B, G, >=7] (x, y, z, dx, dy, dz, rot, ...) -> [B, H, W] f32."""
    H, W = hw
    cell_x = voxel_size[0] * out_size_scale
    cell_y = voxel_size[1] * out_size_scale
    valid = gt_boxes.abs().sum(-1) > 0  # [B, G]
    radius = torch.floor(torch.clamp_min(gaussian_radius(gt_boxes[..., 3] / cell_x,
                                                         gt_boxes[..., 4] / cell_y), 0.0))
    cx = torch.trunc((gt_boxes[..., 0] - pc_range[0]) / cell_x)
    cy = torch.trunc((gt_boxes[..., 1] - pc_range[1]) / cell_y)
    ys = torch.arange(H, dtype=torch.float32, device=gt_boxes.device).reshape(1, 1, H, 1)
    xs = torch.arange(W, dtype=torch.float32, device=gt_boxes.device).reshape(1, 1, 1, W)
    dx = xs - cx[..., None, None]
    dy = ys - cy[..., None, None]
    sigma = (2.0 * radius + 1.0) / 6.0
    r = radius[..., None, None]
    g = torch.exp(-(dx * dx + dy * dy) / (2.0 * sigma[..., None, None] ** 2 + 1e-12))
    inside = (dx.abs() <= r) & (dy.abs() <= r) & valid[..., None, None]
    return torch.where(inside, g, torch.zeros_like(g)).amax(1)
