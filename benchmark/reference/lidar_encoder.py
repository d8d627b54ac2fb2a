"""LiDAR voxel encoder: sparse ResNet middle encoder + height compression.

Counterpart of the JAX package's `layers/lidar_encoder.py`
(`VoxelResBackBone8x`, `LidarEncoder`), following its per-voxel branch,
the plain statement of the math:

  conv_input  SubM(5→16) + BN + ReLU                   s0 (41, 1440, 1440)
  res1a/b     SparseBasicBlock(16)
  down2       SparseConv(16→32, k3, s2, p1) + BN + ReLU s2 (21, 720, 720)
  res2a/b     SparseBasicBlock(32)
  down3       SparseConv(32→64, k3, s2, p1) + BN + ReLU s3 (11, 360, 360)
  res3a/b     SparseBasicBlock(64)
  down4       SparseConv(64→128, k3, s2, p(0,1,1)) + BN + ReLU
                                                        s4 (5, 180, 180)
  res4a/b     SparseBasicBlock(128)
  conv_out    SparseConv(128→128, k(3,1,1), s(2,1,1)) + BN + ReLU
                                                        s5 (2, 180, 180)
  height compression -> NCHW [B, 128·2, 180, 180], channel c·2 + d

Module names are the JAX ones, so weights map by path
(`lidar_encoder.backbone_3d.res1a.conv1.weight` ...). A sparse conv's
weight keeps the JAX layout [K, Cin, Cout] with z-major taps.

Every one of the 21 sparse convs is one call of `sparse.sparse_conv` over
the whole batch. All rulebooks are built first, by `build_rulebooks`, from
the voxel coordinates alone. There are no fixed-shape stage caps: every
stage holds its true active sites. In training the MaskedBatchNorms take
their batch statistics over the active sites.

Numerics: weights are held in f32 and cast with the features to the
convs' `compute_dtype` (bf16 for the served model) at the call; the convs
sum in f32; BatchNorm (flax momentum 0.99), ReLU and the residual sums run
in f32.
The SparseBasicBlock convs carry a bias that is added before the BatchNorm
(a quirk of the reference, kept for its checkpoints).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from .config import LidarEncoderConfig
from .common import BatchNorm, cast, cast_bias
from .sparse import (
    Shape3,
    SparseTensor,
    down_rules,
    downsample_sites,
    from_voxels,
    sparse_conv,
    subm_rules,
    to_dense_bev,
)

# name, cin, cout, kernel (z, y, x), stride, padding
DOWN_CONVS = (
    ("down2", 16, 32, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ("down3", 32, 64, (3, 3, 3), (2, 2, 2), (1, 1, 1)),
    ("down4", 64, 128, (3, 3, 3), (2, 2, 2), (0, 1, 1)),
    ("conv_out", 128, 128, (3, 1, 1), (2, 1, 1), (0, 0, 0)),
)
# the residual stages: blocks, channels; stage i runs on sites[i]
RES_STAGES = (("res1", 16), ("res2", 32), ("res3", 64), ("res4", 128))


def stage_shapes(grid_size: Sequence[int]) -> Tuple[Shape3, ...]:
    """(D, H, W) of the stages s0, s2, s3, s4, s5."""
    nx, ny, nz = grid_size
    shapes = [(nz + 1, ny, nx)]
    for _, _, _, k, s, p in DOWN_CONVS:
        shapes.append(tuple((d + 2 * pd - kd) // sd + 1
                            for d, kd, sd, pd in zip(shapes[-1], k, s, p)))
    return tuple(shapes)


@dataclass(frozen=True)
class Rulebooks:
    """Sites and neighbour maps of one batch, from its voxel coordinates."""

    sites: List[SparseTensor]  # s0 (carrying the voxel features), s2, s3, s4, s5
    subm: List[torch.Tensor]   # SubM maps at s0, s2, s3, s4: [N_i, 27]
    down: List[torch.Tensor]   # maps of down2, down3, down4, conv_out: [N_out, K]


def build_rulebooks(voxel_feats: torch.Tensor, voxel_coords: torch.Tensor,
                    shapes: Sequence[Shape3]) -> Rulebooks:
    """Sites and maps of every stage."""
    sites = [from_voxels(voxel_feats, voxel_coords, shapes[0])]
    subm = [subm_rules(sites[0])]
    down = []
    for (_, _, _, k, s, p), shape in zip(DOWN_CONVS, shapes[1:]):
        out = downsample_sites(sites[-1], k, s, p, shape)
        down.append(down_rules(sites[-1], out, k, s, p))
        sites.append(out)
        if len(subm) < len(RES_STAGES):
            subm.append(subm_rules(out))
    return Rulebooks(sites, subm, down)


class MaskedBatchNorm(BatchNorm):
    """BatchNorm over the active voxels [N, C] (flax momentum 0.99, eps
    1e-3). The JAX module masks the padding slots of its fixed-size buffers;
    here every row is an active site, so nothing needs a mask."""

    def __init__(self, channels: int):
        super().__init__(channels, eps=1e-3, momentum=0.99)


class SubMConv(nn.Module):
    """3×3×3 submanifold conv; weight [27, Cin, Cout] in f32, cast with the
    features to `compute_dtype` at the call."""

    kernel_size = (3, 3, 3)
    compute_dtype = torch.float32

    def __init__(self, cin: int, cout: int, bias: bool):
        super().__init__()
        K = self.kernel_size[0] * self.kernel_size[1] * self.kernel_size[2]
        self.weight = nn.Parameter(torch.randn(K, cin, cout) * (2.0 / (K * cin)) ** 0.5)
        self.bias = nn.Parameter(torch.zeros(cout)) if bias else None

    def forward(self, x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
        """x [N_in, Cin] -> [N_out, Cout] in the compute dtype."""
        dt = self.compute_dtype
        return sparse_conv(cast(x, dt), nbr, cast(self.weight, dt), cast_bias(self.bias, dt))


class SparseDownConv(SubMConv):
    """Strided sparse conv; weight [kz·ky·kx, Cin, Cout], no bias."""

    def __init__(self, cin: int, cout: int, kernel_size, stride, padding):
        self.kernel_size = tuple(kernel_size)
        self.stride, self.padding = tuple(stride), tuple(padding)
        super().__init__(cin, cout, bias=False)


def bn_relu(bn: nn.Module, x: torch.Tensor) -> torch.Tensor:
    return F.relu(bn(x.float()))


class SparseBasicBlock(nn.Module):
    """conv1 + bias, bn1, ReLU, conv2 + bias, bn2, + identity, ReLU."""

    def __init__(self, planes: int):
        super().__init__()
        self.conv1 = SubMConv(planes, planes, bias=True)
        self.bn1 = MaskedBatchNorm(planes)
        self.conv2 = SubMConv(planes, planes, bias=True)
        self.bn2 = MaskedBatchNorm(planes)

    def forward(self, x: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
        out = bn_relu(self.bn1, self.conv1(x, nbr))
        out = self.bn2(self.conv2(out, nbr).float())
        return F.relu(out + x.float())


class VoxelResBackBone8x(nn.Module):
    def __init__(self, cfg: LidarEncoderConfig):
        super().__init__()
        self.shapes = stage_shapes(cfg.grid_size)
        self.conv_input = SubMConv(cfg.use_num_point_features, 16, bias=False)
        self.bn_input = MaskedBatchNorm(16)
        for i, (name, cin, cout, k, s, p) in enumerate(DOWN_CONVS):
            stage, planes = RES_STAGES[i]
            self.add_module(f"{stage}a", SparseBasicBlock(planes))
            self.add_module(f"{stage}b", SparseBasicBlock(planes))
            self.add_module(name, SparseDownConv(cin, cout, k, s, p))
            self.add_module("bn_out" if name == "conv_out" else f"bn{i + 2}", MaskedBatchNorm(cout))

    def forward(self, voxel_feats: torch.Tensor, voxel_coords: torch.Tensor) -> torch.Tensor:
        """voxel_feats [B, V, 5] (mean VFE), voxel_coords [B, V, 3] (z, y, x),
        -1 on padding -> BEV map [B, 256, 180, 180] (f32)."""
        rb = build_rulebooks(voxel_feats.float(), voxel_coords, self.shapes)
        f = bn_relu(self.bn_input, self.conv_input(rb.sites[0].features, rb.subm[0]))
        for i, (name, *_rest) in enumerate(DOWN_CONVS):
            stage, _ = RES_STAGES[i]
            f = getattr(self, f"{stage}a")(f, rb.subm[i])
            f = getattr(self, f"{stage}b")(f, rb.subm[i])
            bn = self.bn_out if name == "conv_out" else getattr(self, f"bn{i + 2}")
            f = bn_relu(bn, getattr(self, name)(f, rb.down[i]))
        return to_dense_bev(rb.sites[-1].with_features(f))


class LidarEncoder(nn.Module):
    def __init__(self, cfg: LidarEncoderConfig):
        super().__init__()
        self.backbone_3d = VoxelResBackBone8x(cfg)

    def forward(self, voxel_feats: torch.Tensor, voxel_coords: torch.Tensor) -> torch.Tensor:
        return self.backbone_3d(voxel_feats, voxel_coords)
