"""Point cloud -> voxels + mean VFE, plain PyTorch (a frozen copy of the
port's `voxelize`).

  voxelize(points [B, P, C] f32, points_mask [B, P] bool, point_cloud_range,
           voxel_size, grid_size (nx, ny, nz), max_voxels, max_points_per_voxel)
      -> features [B, V, C] f32, coords [B, V, 3] int32 (z, y, x)

Points outside the range or masked off are dropped; a stable sort on the
xy-major key (y·nx + x)·nz + z keeps a voxel's points in input order and the
first `max_points_per_voxel` count; slots ascend by key, and past
`max_voxels` the lowest keys are kept; unused slots have coords -1.
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
