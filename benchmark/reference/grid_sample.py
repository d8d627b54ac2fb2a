"""Bilinear sampling of the distillation losses; counterpart of the JAX
`ops/grid_sample.py`, which rewrites `torch.nn.functional.grid_sample`
(bilinear, zeros padding, align_corners=False) for the TPU. The port calls
that function itself on the NCHW map."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def grid_sample_2d(feat: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """feat [N, C, H, W]; grid [N, Ho, Wo, 2] in [-1, 1], grid[..., 0] the x
    (width) coordinate -> [N, Ho, Wo, C]; taps outside the map add 0."""
    out = F.grid_sample(feat, grid.to(feat.dtype), mode="bilinear", padding_mode="zeros",
                        align_corners=False)
    return out.permute(0, 2, 3, 1)
