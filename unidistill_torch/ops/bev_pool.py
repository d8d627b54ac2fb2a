"""Camera frustum -> BEV scatter-add pooling (depth x context, fused).

Counterpart of the JAX package's `ops/bev_pool.py`. Layouts are the JAX ones:

  bev_pool_outer(geom_xyz [B, NC, D, fH, fW, 3] int32,
                 depth    [B, NC, D, fH, fW]    f32,
                 context  [B, NC, fH, fW, C]    f32, (nx, ny, nz))
      -> [B, ny, nx, C] f32

Every frustum point whose (x, y, z) lies inside the grid adds
depth[p] * context[ray(p)] into BEV cell (y, x); other points are dropped.

It runs the custom op `unidistill::bev_pool`: on a CUDA tensor a plan and
kernel K1, with kernel K5 (`unidistill::bev_pool_bwd`) as its registered
backward (`csrc/bev_pool.cu`); on a CPU tensor their plain versions
`bev_pool_cells_plain` and `bev_pool_outer_bwd_plain`. The plan (`bev_pool_plan`, plain
PyTorch on the tensors' device, no host sync) sorts the points stably by
output row b*ncells + cell; K1 reduces each row's interval of that order
with one warp and writes the row once, so its result is bit-identical from
run to run (`bev_pool_intervals_plain` is its plain version given a plan).
K5 computes, for the gradient g [B, ncells, C] of the output,

  g_depth[p]    = <g[b, cell[p]], context[ray(p)]>     (0 outside the grid)
  g_context[r]  = sum of depth[p]·g[b, cell[p]] over the points p of ray r

with one block per two neighbouring camera columns (b, n, w), whose rays
share their cell at most depth bins, so that it reads each g row about once
per column (`bev_pool_bwd_reads` counts the rows); no atomics,
bit-identical from run to run. `bev_pool_outer_bwd_plain` is its plain version.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

from unidistill_torch.kernels import build


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


def _check_tensors(fn: str, *specs) -> None:
    for name, t, dt in specs:
        if not t.is_cuda:
            raise ValueError(f"{fn}: {name} must be a CUDA tensor")
        if t.dtype != dt:
            raise ValueError(f"{fn}: {name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def _check_pool_args(cell: torch.Tensor, depth: torch.Tensor, context: torch.Tensor) -> None:
    B, NC, D, fH, fW = depth.shape
    _check_tensors("bev_pool", ("cell", cell, torch.int32), ("depth", depth, torch.float32),
                   ("context", context, torch.float32))
    if tuple(cell.shape) != tuple(depth.shape):
        raise ValueError(f"bev_pool: cell {tuple(cell.shape)} != depth {tuple(depth.shape)}")
    if context.dim() != 5 or tuple(context.shape[:4]) != (B, NC, fH, fW) or context.shape[4] < 1:
        raise ValueError(f"bev_pool: context {tuple(context.shape)} does not match depth")
    if B * NC * fH * fW >= 2**31:
        raise ValueError("bev_pool: too many camera rays for int32 indexing")


def bev_pool_plan(cell: torch.Tensor, ncells: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's plan. cell: [B, NC, D, fH, fW] int flat BEV cells (outside
    [0, ncells) = dropped). Numbers the points ray-major, q = ray*D + d with
    ray = (b, n, h, w), and sorts them stably by output row b*ncells + cell,
    the points outside the grid last. Returns (order [N] int64: the q of the
    points, row by row, ray and then depth bin ascending inside a row;
    offsets [B*ncells + 1] int64: row k's points are
    order[offsets[k]:offsets[k+1]], and none past offsets[-1] is in the
    grid). Runs on the tensor's device without a host sync."""
    B = cell.shape[0]
    n_rows = B * ncells
    if n_rows >= 2**31:
        raise ValueError("bev_pool_plan: too many BEV rows for int32 keys")
    base = torch.arange(0, n_rows, ncells, dtype=torch.int32, device=cell.device).view(B, 1, 1, 1, 1)
    key = torch.where((cell >= 0) & (cell < ncells), cell.int() + base, n_rows)
    key, order = torch.sort(key.permute(0, 1, 3, 4, 2).reshape(-1), stable=True)
    offsets = torch.searchsorted(key, torch.arange(n_rows + 1, dtype=torch.int32, device=cell.device))
    return order, offsets


def bev_pool_intervals_plain(
    order: torch.Tensor, offsets: torch.Tensor, depth: torch.Tensor, context: torch.Tensor,
) -> torch.Tensor:
    """Plain version of K1 given a `bev_pool_plan`: gather each point's
    depth and context row in the plan's order, multiply, and sum each row's
    interval (the points past offsets[-1] into a dropped row). Returns
    [B, ncells, C] in float32, or float64 for float64 inputs."""
    B, NC, D, fH, fW = depth.shape
    C = context.shape[-1]
    n_rows = offsets.numel() - 1
    dt = torch.promote_types(torch.promote_types(depth.dtype, context.dtype), torch.float32)
    w = depth.to(dt).permute(0, 1, 3, 4, 2).reshape(-1)[order]
    prod = w[:, None] * context.to(dt).reshape(-1, C)[order // D]
    pos = torch.arange(order.numel(), device=order.device)
    row = torch.searchsorted(offsets, pos, right=True) - 1
    out = torch.zeros(n_rows + 1, C, dtype=dt, device=depth.device)
    out.index_add_(0, row, prod)
    return out[:n_rows].reshape(B, n_rows // B, C)


def bev_pool_intervals_cuda(
    order: torch.Tensor, offsets: torch.Tensor, depth: torch.Tensor, context: torch.Tensor,
) -> torch.Tensor:
    """Kernel K1: the reduce of a `bev_pool_plan` (order, offsets) over
    depth [B, NC, D, fH, fW] f32 and context [B, NC, fH, fW, C] f32.
    Returns [B, ncells, C] f32; every row is written once."""
    B, NC, D, fH, fW = depth.shape
    C = context.shape[-1]
    n_rows = offsets.numel() - 1
    _check_tensors("bev_pool", ("order", order, torch.int64), ("offsets", offsets, torch.int64),
                   ("depth", depth, torch.float32), ("context", context, torch.float32))
    if order.numel() != depth.numel() or n_rows % B or not 0 < n_rows < 2**31:
        raise ValueError(f"bev_pool: a plan of {order.numel()} points and {n_rows} rows "
                         f"does not match depth {tuple(depth.shape)}")
    if tuple(context.shape[:4]) != (B, NC, fH, fW):
        raise ValueError(f"bev_pool: context {tuple(context.shape)} does not match depth")
    out = torch.empty(B, n_rows // B, C, dtype=torch.float32, device=depth.device)
    lib = build.library("bev_pool")
    err = lib.bev_pool_fwd(
        order.data_ptr(), offsets.data_ptr(), depth.data_ptr(), context.data_ptr(), out.data_ptr(),
        n_rows, D, fH * fW, C, torch.cuda.current_stream(depth.device).cuda_stream,
    )
    build.check(err, "bev_pool_fwd")
    build.LAUNCHES["bev_pool_fwd"] += 1
    return out


def bev_pool_cells_cuda(
    cell: torch.Tensor, depth: torch.Tensor, context: torch.Tensor, ncells: int,
) -> torch.Tensor:
    """The plan and kernel K1. cell: [B, NC, D, fH, fW] int32 flat cells (out
    of range = dropped); depth: same shape f32; context: [B, NC, fH, fW, C]
    f32. Returns [B, ncells, C] f32, bit-identical from run to run."""
    _check_pool_args(cell, depth, context)
    order, offsets = bev_pool_plan(cell, ncells)
    return bev_pool_intervals_cuda(order, offsets, depth, context)


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


K5_COLUMNS = 2          # neighbouring camera columns one K5 block walks (kCols)
K5_RAYS_PER_PASS = 16   # rays of each column it walks at once (kRows)


@functools.lru_cache(maxsize=None)
def _check_k5_schedule(lib: ctypes.CDLL) -> None:
    """The library's K5 schedule is the one `bev_pool_bwd_reads` models."""
    columns, rays = ctypes.c_int(), ctypes.c_int()
    build.check(lib.bev_pool_bwd_schedule(ctypes.byref(columns), ctypes.byref(rays)), "bev_pool_bwd_schedule")
    if (columns.value, rays.value) != (K5_COLUMNS, K5_RAYS_PER_PASS):
        raise RuntimeError(f"K5's schedule ({columns.value} columns, {rays.value} rays a pass) is not "
                           f"the modelled one ({K5_COLUMNS}, {K5_RAYS_PER_PASS})")


def bev_pool_bwd_reads(cell: torch.Tensor, ncells: int) -> Tuple[int, int]:
    """The g rows K5 reads, before and after its redesign, as modelled from
    its schedule (the kernel counts nothing). cell: [B, NC, D, fH, fW] int
    flat cells (outside [0, ncells) = dropped). Returns

      ray runs:     the ray-owned design's reads, one per in-grid point whose
                    cell differs from the ray's previous in-grid cell;
      column reads: the column-owned design's: a block walks K5_RAYS_PER_PASS
                    rays of K5_COLUMNS neighbouring columns (b, n, w) at a
                    time; at each depth bin where their cells (outside = -1)
                    differ from the previous bin's, it reads one row per
                    distinct in-grid cell among them."""
    B, NC, D, fH, fW = cell.shape
    q = torch.where((cell >= 0) & (cell < ncells), cell.long(), -1)
    rays = q.permute(0, 1, 4, 3, 2).reshape(-1, fH, D)  # [columns, h, d]
    inside = rays >= 0
    d = torch.arange(D, device=q.device).expand_as(rays)
    # the ray's last in-grid bin before d (-1 for none)
    last = torch.cummax(torch.where(inside, d, -1), 2).values
    prev = torch.cat([last.new_full(last.shape[:2] + (1,), -1), last[..., :-1]], 2)
    prev_q = torch.gather(rays, 2, prev.clamp(min=0))
    ray_runs = int((inside & ((prev < 0) | (prev_q != rays))).sum().item())

    pad = -fW % K5_COLUMNS
    cols = torch.nn.functional.pad(q, (0, pad), value=-1).permute(0, 1, 4, 3, 2)  # [B, NC, w, h, d]
    cols = cols.reshape(-1, K5_COLUMNS, fH, D)  # [column groups, column, h, d]
    column_reads = 0
    for h0 in range(0, fH, K5_RAYS_PER_PASS):
        qs = cols[:, :, h0:h0 + K5_RAYS_PER_PASS].flatten(1, 2).transpose(1, 2)  # [groups, d, rays]
        changed = torch.ones(qs.shape[:2], dtype=torch.bool, device=q.device)
        changed[:, 1:] = (qs[:, 1:] != qs[:, :-1]).any(-1)
        s = qs.sort(-1).values
        distinct = (s >= 0) & torch.cat([torch.ones_like(s[..., :1], dtype=torch.bool), s[..., 1:] != s[..., :-1]], -1)
        column_reads += int((distinct.sum(-1) * changed).sum().item())
    return ray_runs, column_reads


def bev_pool_bwd_cuda(
    cell: torch.Tensor, depth: torch.Tensor, context: torch.Tensor, g: torch.Tensor, ncells: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel K5, one block per two camera columns. cell, depth, context as
    `bev_pool_cells_cuda`; g [B, ncells, C] f32, the gradient of its output.
    Returns (g_depth [B, NC, D, fH, fW], g_context [B, NC, fH, fW, C]), f32,
    bit-identical from run to run."""
    B, NC, D, fH, fW = depth.shape
    C = context.shape[-1]
    _check_pool_args(cell, depth, context)
    if not g.is_cuda or g.dtype != torch.float32 or not g.is_contiguous():
        raise ValueError("bev_pool_bwd: g must be a contiguous float32 CUDA tensor")
    if tuple(g.shape) != (B, ncells, C):
        raise ValueError(f"bev_pool_bwd: g {tuple(g.shape)} != {(B, ncells, C)}")
    if B * ncells >= 2**31:
        raise ValueError("bev_pool_bwd: too many g rows for int32 indexing")
    g_depth = torch.empty_like(depth)
    g_context = torch.empty_like(context)
    # float4 loads and 16-byte row copies where the rows allow them
    vec = 4 if C % 4 == 0 and all(t.data_ptr() % 16 == 0 for t in (context, g, g_context)) else 1
    lib = build.library("bev_pool")
    _check_k5_schedule(lib)
    err = lib.bev_pool_bwd(
        cell.data_ptr(), depth.data_ptr(), context.data_ptr(), g.data_ptr(),
        g_depth.data_ptr(), g_context.data_ptr(), B, NC, D, fH, fW, C, ncells, vec,
        torch.cuda.current_stream(depth.device).cuda_stream,
    )
    build.check(err, "bev_pool_bwd")
    build.LAUNCHES["bev_pool_bwd"] += 1
    return g_depth, g_context


# ---------------------------------------------------------------------------
# the custom ops: the model path reaches K1 and K5 through these on both
# devices (a CUDA tensor the kernel's wrapper, a CPU tensor its plain
# version, each looked up by name at the call)
# ---------------------------------------------------------------------------


@torch.library.custom_op("unidistill::bev_pool", mutates_args=(), device_types="cuda")
def bev_pool_op(cell: torch.Tensor, depth: torch.Tensor, context: torch.Tensor,
                ncells: int) -> torch.Tensor:
    """The plan and K1 (`bev_pool_cells_cuda`): [B, ncells, C] float32."""
    return bev_pool_cells_cuda(cell, depth, context, ncells)


@bev_pool_op.register_kernel("cpu")
def _bev_pool_cpu(cell, depth, context, ncells):
    return bev_pool_cells_plain(cell, depth, context, ncells)


@bev_pool_op.register_fake
def _bev_pool_fake(cell, depth, context, ncells):
    return depth.new_empty(depth.shape[0], ncells, context.shape[-1], dtype=torch.float32)


@torch.library.custom_op("unidistill::bev_pool_bwd", mutates_args=(), device_types="cuda")
def bev_pool_bwd_op(cell: torch.Tensor, depth: torch.Tensor, context: torch.Tensor,
                    g: torch.Tensor, ncells: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """K5 (`bev_pool_bwd_cuda`): (g_depth, g_context)."""
    return bev_pool_bwd_cuda(cell, depth, context, g, ncells)


@bev_pool_bwd_op.register_kernel("cpu")
def _bev_pool_bwd_cpu(cell, depth, context, g, ncells):
    return bev_pool_outer_bwd_plain(cell, depth, context, g, ncells)


@bev_pool_bwd_op.register_fake
def _bev_pool_bwd_fake(cell, depth, context, g, ncells):
    return torch.empty_like(depth, dtype=torch.float32), torch.empty_like(context, dtype=torch.float32)


def _bev_pool_setup(ctx, inputs, output):
    cell, depth, context, ncells = inputs
    ctx.save_for_backward(cell, depth, context)
    ctx.ncells = ncells


def _bev_pool_backward(ctx, g):
    """K5; no gradient for the cells."""
    cell, depth, context = ctx.saved_tensors
    g_depth, g_context = torch.ops.unidistill.bev_pool_bwd(cell, depth, context, g.contiguous(), ctx.ncells)
    return None, g_depth, g_context, None


bev_pool_op.register_autograd(_bev_pool_backward, setup_context=_bev_pool_setup)


def bev_pool_outer(
    geom_xyz: torch.Tensor,
    depth: torch.Tensor,
    context: torch.Tensor,
    voxel_num: Tuple[int, int, int],
) -> torch.Tensor:
    """Fused depth x context BEV pooling -> [B, ny, nx, C] f32,
    differentiable in depth and context, through `unidistill::bev_pool`."""
    B = depth.shape[0]
    C = context.shape[-1]
    nx, ny, nz = voxel_num
    cell = _linear_index(geom_xyz, nx, ny, nz).to(torch.int32).contiguous()
    out = torch.ops.unidistill.bev_pool(cell, depth.float().contiguous(), context.float().contiguous(), nx * ny)
    return out.reshape(B, ny, nx, C)
