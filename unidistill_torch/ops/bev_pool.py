"""Camera frustum -> BEV scatter-add pooling (depth x context, fused).

Counterpart of the JAX package's `ops/bev_pool.py`. Layouts are the JAX ones:

  bev_pool_outer(geom_xyz [B, NC, D, fH, fW, 3] int32,
                 depth    [B, NC, D, fH, fW]    f32,
                 context  [B, NC, fH, fW, C]    f32, (nx, ny, nz))
      -> [B, ny, nx, C] f32

Every frustum point whose (x, y, z) lies inside the grid adds
depth[p] * context[ray(p)] into BEV cell (y, x); other points are dropped.

On a CUDA tensor this launches kernel K1 (`csrc/bev_pool.cu`); on a CPU
tensor it runs `bev_pool_outer_plain`, the same function in plain PyTorch.
"""
from __future__ import annotations

from typing import Tuple

import torch

from unidistill_torch.kernels import build


def _linear_index(geom_xyz: torch.Tensor, nx: int, ny: int, nz: int) -> torch.Tensor:
    """[..., 3] int coords -> flat BEV index y*nx+x, or nx*ny if out of grid."""
    x, y, z = geom_xyz[..., 0], geom_xyz[..., 1], geom_xyz[..., 2]
    valid = (x >= 0) & (x < nx) & (y >= 0) & (y < ny) & (z >= 0) & (z < nz)
    return torch.where(valid, y * nx + x, torch.full_like(x, nx * ny))


def bev_pool_outer_plain(
    geom_xyz: torch.Tensor,
    depth: torch.Tensor,
    context: torch.Tensor,
    voxel_num: Tuple[int, int, int],
) -> torch.Tensor:
    """Plain version: materialise the [B, points, C] product and index_add_ it
    into one extra drop row per sample."""
    B, NC, D, fH, fW = depth.shape
    C = context.shape[-1]
    nx, ny, nz = voxel_num
    ncells = nx * ny
    idx = _linear_index(geom_xyz, nx, ny, nz).reshape(B, -1).long()
    w = (depth.float()[..., None] * context.float()[:, :, None]).reshape(B, -1, C)
    rows = idx + torch.arange(B, device=idx.device)[:, None] * (ncells + 1)
    out = torch.zeros(B * (ncells + 1), C, dtype=torch.float32, device=depth.device)
    out.index_add_(0, rows.reshape(-1), w.reshape(-1, C))
    return out.reshape(B, ncells + 1, C)[:, :ncells].reshape(B, ny, nx, C)


def bev_pool_cells_cuda(
    cell: torch.Tensor, depth: torch.Tensor, context: torch.Tensor, ncells: int,
) -> torch.Tensor:
    """Kernel K1. cell: [B, NC, D, fH, fW] int32 flat cells (out of range =
    dropped); depth: same shape f32; context: [B, NC, fH, fW, C] f32.
    Returns [B, ncells, C] f32."""
    B, NC, D, fH, fW = depth.shape
    C = context.shape[-1]
    for name, t, dt in (("cell", cell, torch.int32), ("depth", depth, torch.float32),
                        ("context", context, torch.float32)):
        if not t.is_cuda:
            raise ValueError(f"bev_pool: {name} must be a CUDA tensor")
        if t.dtype != dt:
            raise ValueError(f"bev_pool: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"bev_pool: {name} must be contiguous")
    if tuple(cell.shape) != tuple(depth.shape):
        raise ValueError(f"bev_pool: cell {tuple(cell.shape)} != depth {tuple(depth.shape)}")
    if tuple(context.shape[:4]) != (B, NC, fH, fW):
        raise ValueError(f"bev_pool: context {tuple(context.shape)} does not match depth")
    if B * NC * fH * fW >= 2**31:
        raise ValueError("bev_pool: too many camera rays for int32 indexing")
    out = torch.zeros(B, ncells, C, dtype=torch.float32, device=depth.device)
    lib = build.library("bev_pool")
    err = lib.bev_pool_fwd(
        cell.data_ptr(), depth.data_ptr(), context.data_ptr(), out.data_ptr(),
        B * NC * fH * fW, NC * fH * fW, D, fH * fW, C, ncells,
        torch.cuda.current_stream(depth.device).cuda_stream,
    )
    build.check(err, "bev_pool_fwd")
    build.LAUNCHES["bev_pool_fwd"] += 1
    return out


def bev_pool_outer(
    geom_xyz: torch.Tensor,
    depth: torch.Tensor,
    context: torch.Tensor,
    voxel_num: Tuple[int, int, int],
) -> torch.Tensor:
    """Fused depth x context BEV pooling -> [B, ny, nx, C] f32."""
    if not depth.is_cuda:
        return bev_pool_outer_plain(geom_xyz, depth, context, voxel_num)
    B = depth.shape[0]
    C = context.shape[-1]
    nx, ny, nz = voxel_num
    cell = _linear_index(geom_xyz, nx, ny, nz).to(torch.int32).contiguous()
    out = bev_pool_cells_cuda(
        cell, depth.float().contiguous(), context.float().contiguous(), nx * ny
    )
    return out.reshape(B, ny, nx, C)
