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

Plain PyTorch: the sort, scan and gathers have no TPU kernel behind them in
the JAX package (they are XLA there). No sum uses atomics, so the result is
the same from run to run on the card and equals the CPU's bit for bit.

`voxelize_frame` voxelises one frame of the data loader on the host, in
the C++ library (`data.native.voxelize_mean_sorted_native`), as the JAX
package's `data/voxelize_host.py::voxelize_frame` does with its library
(its plain version, `data.native.voxelize_mean_sorted_plain`, is `voxelize`
on the CPU: the same coordinates, means summed in float32, within 1e-6).
"""
from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch

from unidistill_torch.data import native


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

    # seg ascends along each row, so slot v's points are the interval
    # [bounds[v], bounds[v + 1]) and it keeps the first max_points_per_voxel
    slots = torch.arange(V + 1, device=dev).expand(B, V + 1).contiguous()
    bounds = torch.searchsorted(seg, slots)
    start = bounds[:, :V]
    cnts = (bounds[:, 1:] - start).clamp(max=max_points_per_voxel)

    # each slot sums its kept points in point order, ((0 + p0) + p1) + ...,
    # one gather and one add per rank: no atomics, so the card gives the
    # same bits from run to run and as the CPU's sequential sum; ranks past
    # a slot's count read the zero row P
    src = torch.cat([spoints, spoints.new_zeros(B, 1, C)], 1)
    ranks = torch.arange(max_points_per_voxel, device=dev)
    rows = torch.where(ranks < cnts[..., None], start[..., None] + ranks, P)
    sums = torch.zeros(B, V, C, dtype=points.dtype, device=dev)
    for r in range(max_points_per_voxel):
        sums += torch.gather(src, 1, rows[..., r, None].expand(B, V, C))
    feats = sums / cnts.clamp(min=1)[..., None].to(sums.dtype)

    # a slot's coords are those of its first point; unused slots get -1
    first = torch.gather(svc, 1, start.clamp(max=P - 1)[..., None].expand(B, V, 3))
    coords = torch.where(cnts[..., None] > 0, first.flip(-1).to(torch.int32), -1)
    return feats, coords


def voxelize_frame(points: np.ndarray, mask: np.ndarray, cfg, training: bool):
    """One frame [P, C] with its mask [P], voxelised on the host by the C++
    library at the config's train or eval voxel cap:
    (feats [V, C] f32, coords [V, 3] int32 (z, y, x), -1 on unused slots),
    as the JAX package's `data/voxelize_host.py::voxelize_frame`."""
    caps = cfg.caps
    return native.voxelize_mean_sorted_native(
        np.asarray(points)[np.asarray(mask, bool)], cfg.point_cloud_range, cfg.voxel_size, cfg.grid_size,
        caps.max_voxels_train if training else caps.max_voxels_eval, caps.max_points_per_voxel)
