"""Camera frustum -> BEV scatter-add pooling (depth x context, fused).

Counterpart of the JAX package's `ops/bev_pool.py`. Layouts are the JAX ones:

  bev_pool_outer(geom_xyz [B, NC, D, fH, fW, 3] int32,
                 depth    [B, NC, D, fH, fW]    f32,
                 context  [B, NC, fH, fW, C]    f32, (nx, ny, nz))
      -> [B, ny, nx, C] f32

Every frustum point whose (x, y, z) lies inside the grid adds
depth[p] * context[ray(p)] into BEV cell (y, x); other points are dropped.

On a CUDA tensor this runs `BevPool`, an autograd Function whose forward is
kernel K1 and whose backward is kernel K5 (`csrc/bev_pool.cu`); on a CPU
tensor it runs `bev_pool_outer_plain`, the same function in plain PyTorch,
which autograd differentiates. K5 computes, for the gradient g [B, ncells, C]
of the output,

  g_depth[p]    = <g[b, cell[p]], context[ray(p)]>     (0 outside the grid)
  g_context[r]  = sum of depth[p]·g[b, cell[p]] over the points p of ray r

and `bev_pool_outer_bwd_plain` is its plain version.
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
    into one extra drop row per sample. Computes in float32, or in float64
    for float64 inputs (finite-difference checks)."""
    B, NC, D, fH, fW = depth.shape
    C = context.shape[-1]
    nx, ny, nz = voxel_num
    ncells = nx * ny
    dt = torch.promote_types(torch.promote_types(depth.dtype, context.dtype), torch.float32)
    idx = _linear_index(geom_xyz, nx, ny, nz).reshape(B, -1).long()
    w = (depth.to(dt)[..., None] * context.to(dt)[:, :, None]).reshape(B, -1, C)
    rows = idx + torch.arange(B, device=idx.device)[:, None] * (ncells + 1)
    out = torch.zeros(B * (ncells + 1), C, dtype=dt, device=depth.device)
    out.index_add_(0, rows.reshape(-1), w.reshape(-1, C))
    return out.reshape(B, ncells + 1, C)[:, :ncells].reshape(B, ny, nx, C)


def _check_pool_args(cell: torch.Tensor, depth: torch.Tensor, context: torch.Tensor) -> None:
    B, NC, D, fH, fW = depth.shape
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
    if context.dim() != 5 or tuple(context.shape[:4]) != (B, NC, fH, fW) or context.shape[4] < 1:
        raise ValueError(f"bev_pool: context {tuple(context.shape)} does not match depth")
    if B * NC * fH * fW >= 2**31:
        raise ValueError("bev_pool: too many camera rays for int32 indexing")


def bev_pool_cells_cuda(
    cell: torch.Tensor, depth: torch.Tensor, context: torch.Tensor, ncells: int,
) -> torch.Tensor:
    """Kernel K1. cell: [B, NC, D, fH, fW] int32 flat cells (out of range =
    dropped); depth: same shape f32; context: [B, NC, fH, fW, C] f32.
    Returns [B, ncells, C] f32."""
    B, NC, D, fH, fW = depth.shape
    C = context.shape[-1]
    _check_pool_args(cell, depth, context)
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


def bev_pool_outer_bwd_plain(
    cell: torch.Tensor, depth: torch.Tensor, context: torch.Tensor, g: torch.Tensor, ncells: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of K5: gather each point's g row (a zero row for points
    outside the grid), then reduce over channels for g_depth and over depth
    bins for g_context. Shapes as `bev_pool_bwd_cuda`."""
    B, NC, D, fH, fW = depth.shape
    C = context.shape[-1]
    valid = (cell >= 0) & (cell < ncells)
    idx = torch.where(valid, cell, ncells).long().reshape(B, -1)
    gz = torch.cat([g.float(), g.new_zeros(B, 1, C, dtype=torch.float32)], 1)
    rows = gz[torch.arange(B, device=g.device)[:, None], idx].reshape(B, NC, D, fH, fW, C)
    g_depth = (rows * context.float()[:, :, None]).sum(-1)
    g_context = (rows * depth.float()[..., None]).sum(2)
    return g_depth, g_context


def bev_pool_bwd_cuda(
    cell: torch.Tensor, depth: torch.Tensor, context: torch.Tensor, g: torch.Tensor, ncells: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K5. cell, depth, context as `bev_pool_cells_cuda`; g [B, ncells,
    C] f32, the gradient of its output. Returns (g_depth [B, NC, D, fH, fW],
    g_context [B, NC, fH, fW, C]), f32."""
    B, NC, D, fH, fW = depth.shape
    C = context.shape[-1]
    _check_pool_args(cell, depth, context)
    if not g.is_cuda or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("bev_pool_bwd: g must be a contiguous float32 CUDA tensor")
    if tuple(g.shape) != (B, ncells, C):
        raise ValueError(f"bev_pool_bwd: g {tuple(g.shape)} != {(B, ncells, C)}")
    g_depth = torch.empty_like(depth)
    g_context = torch.empty_like(context)
    lib = build.library("bev_pool")
    err = lib.bev_pool_bwd(
        cell.data_ptr(), depth.data_ptr(), context.data_ptr(), g.data_ptr(),
        g_depth.data_ptr(), g_context.data_ptr(),
        B * NC * fH * fW, NC * fH * fW, D, fH * fW, C, ncells,
        torch.cuda.current_stream(depth.device).cuda_stream,
    )
    build.check(err, "bev_pool_bwd")
    build.LAUNCHES["bev_pool_bwd"] += 1
    return g_depth, g_context


class BevPool(torch.autograd.Function):
    """K1 forward, K5 backward; no gradient for the cells."""

    @staticmethod
    def forward(ctx, cell, depth, context, ncells):
        ctx.save_for_backward(cell, depth, context)
        ctx.ncells = ncells
        return bev_pool_cells_cuda(cell, depth, context, ncells)

    @staticmethod
    def backward(ctx, g):
        cell, depth, context = ctx.saved_tensors
        g_depth, g_context = bev_pool_bwd_cuda(cell, depth, context, g.contiguous(), ctx.ncells)
        return None, g_depth, g_context, None


def bev_pool_outer(
    geom_xyz: torch.Tensor,
    depth: torch.Tensor,
    context: torch.Tensor,
    voxel_num: Tuple[int, int, int],
) -> torch.Tensor:
    """Fused depth x context BEV pooling -> [B, ny, nx, C] f32,
    differentiable in depth and context."""
    if not depth.is_cuda:
        return bev_pool_outer_plain(geom_xyz, depth, context, voxel_num)
    B = depth.shape[0]
    C = context.shape[-1]
    nx, ny, nz = voxel_num
    cell = _linear_index(geom_xyz, nx, ny, nz).to(torch.int32).contiguous()
    out = BevPool.apply(cell, depth.float().contiguous(), context.float().contiguous(), nx * ny)
    return out.reshape(B, ny, nx, C)
