"""PointPillars feature encoder and BEV scatter, counterpart of the JAX
`layers/pillar_vfe.py` (the reference's pillar path; no configuration of
the repository uses it).

Pillars come padded: features [P, N, C] (N point slots a pillar), coords
[P, 3] (z, y, x), point counts [P]. As in JAX, padded point slots are
zeroed before the first layer and after each ReLU, the BatchNorm sees only
the real points of non-empty pillars (`lidar_encoder.MaskedBatchNorm`, flax
momentum 0.99, eps 1e-3; the other rows come out 0), and the scatter drops
invalid pillars through a dump row (index nx·ny) that it then cuts.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from unidistill_torch.layers.common import Linear
from unidistill_torch.layers.lidar_encoder import MaskedBatchNorm


class PFNLayer(nn.Module):
    def __init__(self, in_channels: int, out_channels: int, use_norm: bool = True,
                 last_layer: bool = False):
        super().__init__()
        self.last_layer = last_layer
        out = out_channels if last_layer else out_channels // 2
        self.linear = Linear(in_channels, out, bias=not use_norm)
        self.norm = MaskedBatchNorm(out) if use_norm else None

    def forward(self, x: torch.Tensor, pillar_mask: torch.Tensor, point_mask: torch.Tensor) -> torch.Tensor:
        """x [P, N, C]; pillar_mask [P]; point_mask [P, N]."""
        x = self.linear(x)
        if self.norm is not None:
            rows = point_mask & pillar_mask[:, None]
            y = x.new_zeros(x.shape)
            y[rows] = self.norm(x[rows].float()).to(x.dtype)
            x = y
        x = torch.where(point_mask[..., None], F.relu(x), 0.0)
        x_max = x.max(dim=1, keepdim=True).values
        if self.last_layer:
            return x_max
        return torch.cat([x, x_max.expand_as(x)], dim=-1)


class PillarVFE(nn.Module):
    def __init__(self, num_point_features: int = 5, num_filters: Sequence[int] = (64,),
                 use_norm: bool = True, with_distance: bool = False, use_absolute_xyz: bool = True,
                 voxel_size: Tuple[float, float, float] = (0.075, 0.075, 8.0),
                 point_cloud_range: Tuple[float, ...] = (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0)):
        super().__init__()
        self.with_distance, self.use_absolute_xyz = with_distance, use_absolute_xyz
        self.voxel_size, self.point_cloud_range = tuple(voxel_size), tuple(point_cloud_range)
        cin = num_point_features + 6 - (0 if use_absolute_xyz else 3) + (1 if with_distance else 0)
        self.num_filters = tuple(num_filters)
        for i, f in enumerate(self.num_filters):
            last = i == len(self.num_filters) - 1
            self.add_module(f"pfn{i}", PFNLayer(cin, f, use_norm, last))
            cin = f

    def forward(self, voxel_features: torch.Tensor, voxel_coords: torch.Tensor,
                voxel_num_points: torch.Tensor) -> torch.Tensor:
        """voxel_features [P, N, C] raw points a pillar; voxel_coords [P, 3]
        (z, y, x); voxel_num_points [P]. Returns [P, num_filters[-1]]."""
        dt = voxel_features.dtype
        xyz = voxel_features[:, :, :3]
        n = voxel_num_points.clamp(min=1).to(dt)
        f_cluster = xyz - xyz.sum(1, keepdim=True) / n[:, None, None]
        vx, vy, vz = self.voxel_size
        pcr = self.point_cloud_range
        cxyz = torch.stack([voxel_coords[:, 2].to(dt) * vx + (vx / 2 + pcr[0]),
                            voxel_coords[:, 1].to(dt) * vy + (vy / 2 + pcr[1]),
                            voxel_coords[:, 0].to(dt) * vz + (vz / 2 + pcr[2])], dim=-1)
        feats = [voxel_features if self.use_absolute_xyz else voxel_features[..., 3:],
                 f_cluster, xyz - cxyz[:, None, :]]
        if self.with_distance:
            feats.append(torch.linalg.vector_norm(xyz, dim=-1, keepdim=True))
        x = torch.cat(feats, dim=-1)
        N = x.shape[1]
        point_mask = torch.arange(N, device=x.device)[None, :] < voxel_num_points[:, None]
        pillar_mask = voxel_num_points > 0
        x = torch.where(point_mask[..., None], x, 0.0)
        for i in range(len(self.num_filters)):
            x = getattr(self, f"pfn{i}")(x, pillar_mask, point_mask)
        return x[:, 0, :]


def pointpillar_scatter(pillar_features: torch.Tensor, voxel_coords: torch.Tensor,
                        valid: torch.Tensor, grid_size: Tuple[int, int, int]) -> torch.Tensor:
    """Pillar features [P, C], coords [P, 3] (z, y, x) and valid [P] ->
    the dense BEV canvas [ny, nx, C] (each valid pillar written once)."""
    nx, ny, nz = grid_size
    if nz != 1:
        raise ValueError(f"pointpillar_scatter takes a grid one cell high, got nz={nz}")
    idx = torch.where(valid, voxel_coords[:, 1].long() * nx + voxel_coords[:, 2].long(), nx * ny)
    canvas = pillar_features.new_zeros(nx * ny + 1, pillar_features.shape[-1])
    canvas[idx] = pillar_features
    return canvas[: nx * ny].reshape(ny, nx, -1)
