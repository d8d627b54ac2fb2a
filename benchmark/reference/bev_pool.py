"""Camera frustum -> BEV pooling, plain PyTorch (a frozen copy of the port's
plain version): every frustum point inside the grid adds depth[p] ·
context[ray(p)] into its BEV cell (y, x); the [B, points, C] product is
materialised and `index_add_`ed, and autograd gives the backward.

  bev_pool_outer(geom_xyz [B, NC, D, fH, fW, 3] int32, depth [B, NC, D, fH, fW],
                 context [B, NC, fH, fW, C], (nx, ny, nz)) -> [B, ny, nx, C] f32
"""
from __future__ import annotations

from typing import Tuple

import torch


def _linear_index(geom_xyz: torch.Tensor, nx: int, ny: int, nz: int) -> torch.Tensor:
    """[..., 3] int coords -> flat BEV index y*nx+x, or nx*ny if out of grid."""
    x, y, z = geom_xyz[..., 0], geom_xyz[..., 1], geom_xyz[..., 2]
    valid = (x >= 0) & (x < nx) & (y >= 0) & (y < ny) & (z >= 0) & (z < nz)
    return torch.where(valid, y * nx + x, torch.full_like(x, nx * ny))


def bev_pool_cells_plain(
    cell: torch.Tensor, depth: torch.Tensor, context: torch.Tensor, ncells: int,
) -> torch.Tensor:
    """Plain version of the plan and K1: materialise the [B, points, C]
    product and index_add_ it into one extra drop row per sample. cell,
    depth, context as `bev_pool_cells_cuda`; returns [B, ncells, C] in
    float32, or in float64 for float64 inputs (finite-difference checks)."""
    B = depth.shape[0]
    C = context.shape[-1]
    dt = torch.promote_types(torch.promote_types(depth.dtype, context.dtype), torch.float32)
    idx = torch.where((cell >= 0) & (cell < ncells), cell, ncells).reshape(B, -1).long()
    w = (depth.to(dt)[..., None] * context.to(dt)[:, :, None]).reshape(B, -1, C)
    rows = idx + torch.arange(B, device=idx.device)[:, None] * (ncells + 1)
    out = torch.zeros(B * (ncells + 1), C, dtype=dt, device=depth.device)
    out.index_add_(0, rows.reshape(-1), w.reshape(-1, C))
    return out.reshape(B, ncells + 1, C)[:, :ncells].contiguous()


def bev_pool_outer_plain(
    geom_xyz: torch.Tensor,
    depth: torch.Tensor,
    context: torch.Tensor,
    voxel_num: Tuple[int, int, int],
) -> torch.Tensor:
    """Plain version of `bev_pool_outer` (any device): `bev_pool_cells_plain`
    on the points' cells."""
    nx, ny, nz = voxel_num
    out = bev_pool_cells_plain(_linear_index(geom_xyz, nx, ny, nz), depth, context, nx * ny)
    return out.reshape(depth.shape[0], ny, nx, context.shape[-1])


# ---------------------------------------------------------------------------
# the custom ops: the model path reaches K1 and K5 through these on both
# devices (a CUDA tensor the kernel's wrapper, a CPU tensor its plain
# version, each looked up by name at the call)
# ---------------------------------------------------------------------------


# the reference pools by autograd through the plain product
bev_pool_outer = bev_pool_outer_plain
