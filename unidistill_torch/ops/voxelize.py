"""Point cloud -> voxels + mean VFE, on the tensors' device.

Counterpart of the JAX package's `ops/voxelize.py::voxelize_batched`, with
its layouts and semantics:

  voxelize(points [B, P, C] f32, points_mask [B, P] bool, point_cloud_range,
           voxel_size, grid_size (nx, ny, nz), max_voxels, max_points_per_voxel)
      -> features [B, V, C] f32, coords [B, V, 3] int32 (z, y, x)

  * points outside `point_cloud_range` (or masked off) are dropped;
  * a stable sort on the xy-major key (y·nx + x)·nz + z keeps the points of a
    voxel in their input order, and only the first `max_points_per_voxel` of
    them count;
  * a voxel's feature is the mean over its kept points;
  * voxel slots are in ascending key order; when more than `max_voxels`
    voxels are occupied the ones with the lowest keys are kept (the JAX
    package's documented deviation from spconv's first-occurrence order);
  * unused slots have coords -1 and features 0.

Plain PyTorch: sort, cumulative max and `index_add_` have no TPU kernel
behind them in the JAX package (they are XLA there).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch


def voxelize(
    points: torch.Tensor,
    points_mask: torch.Tensor,
    point_cloud_range: Sequence[float],
    voxel_size: Sequence[float],
    grid_size: Sequence[int],
    max_voxels: int,
    max_points_per_voxel: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    B, P, C = points.shape
    nx, ny, nz = grid_size
    V = max_voxels
    dev = points.device
    pcr = torch.tensor(point_cloud_range[:3], dtype=points.dtype, device=dev)
    vsz = torch.tensor(voxel_size, dtype=points.dtype, device=dev)

    # clamp before the cast: a float far outside int32 has no defined cast,
    # and every clamped value is out of the grid either way
    vc = torch.floor((points[..., :3] - pcr) / vsz).clamp(-1, max(nx, ny, nz)).to(torch.int64)
    x, y, z = vc.unbind(-1)
    in_range = ((x >= 0) & (x < nx) & (y >= 0) & (y < ny) & (z >= 0) & (z < nz)
                & points_mask.bool())
    big = nx * ny * nz
    key = torch.where(in_range, (y * nx + x) * nz + z, torch.full_like(x, big))
    skey, order = torch.sort(key, dim=1, stable=True)
    spoints = torch.gather(points, 1, order[..., None].expand(B, P, C))
    svc = torch.gather(vc, 1, order[..., None].expand(B, P, 3))

    live = skey < big
    is_start = torch.ones_like(live)
    is_start[:, 1:] = skey[:, 1:] != skey[:, :-1]
    is_start &= live
    seg = torch.cumsum(is_start.to(torch.int64), 1) - 1
    seg = torch.where(live, seg.clamp(max=V), torch.full_like(seg, V))

    pos = torch.arange(P, device=dev).expand(B, P)
    runstart = torch.cummax(torch.where(is_start, pos, torch.zeros_like(pos)), 1).values
    keep = ((pos - runstart) < max_points_per_voxel) & (seg < V)

    boff = torch.arange(B, device=dev)[:, None] * (V + 1)
    gseg = (seg + boff).reshape(-1)
    sums = torch.zeros(B * (V + 1), C, dtype=points.dtype, device=dev)
    sums.index_add_(0, gseg, torch.where(keep[..., None], spoints, 0.0).reshape(-1, C))
    cnts = torch.zeros(B * (V + 1), dtype=torch.int64, device=dev)
    cnts.index_add_(0, gseg, keep.reshape(-1).to(torch.int64))
    sums = sums.reshape(B, V + 1, C)[:, :V]
    cnts = cnts.reshape(B, V + 1)[:, :V]
    feats = sums / cnts.clamp(min=1)[..., None].to(sums.dtype)

    # the first point of each kept voxel writes its slot's coords; the rest
    # go to the dump slot V (in any order: it is cut off)
    gdest = (torch.where(is_start, seg, torch.full_like(seg, V)) + boff).reshape(-1)
    coords = torch.full((B * (V + 1), 3), -1, dtype=torch.int32, device=dev)
    coords.index_copy_(0, gdest, svc.flip(-1).reshape(-1, 3).to(torch.int32))
    return feats, coords.reshape(B, V + 1, 3)[:, :V]
