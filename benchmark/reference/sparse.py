"""Sparse 3D convolution, plain PyTorch (a frozen copy of the port's
rulebooks and plain convolution).

The voxels of every sample live in one tensor sorted by the batch-folded key
((b·(H+2) + y+1)·(W+2) + x+1)·(D+2) + z+1 on a grid padded by one site. A
rulebook `nbr [N_out, K] int32` holds, for tap k of output site i, the input
row it reads, or -1. Taps are z-major. Submanifold 3×3×3 maps keep the input
sites; a strided conv's output site is active iff an active input lies in
its receptive field (spconv's rule). The convolution is, per tap, an
`index_select` of the features with a zero row appended and a matmul,
summed in f32; autograd gives the backward.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch


Shape3 = Tuple[int, int, int]


@dataclass(frozen=True)
class SparseTensor:
    """Active sites of a batch at one stage, sorted by batch-folded key."""

    features: torch.Tensor  # [N, C]
    coords: torch.Tensor    # [N, 4] int64 (b, z, y, x)
    keys: torch.Tensor      # [N] int64 `batch_key`s, ascending
    spatial_shape: Shape3   # (D, H, W)
    batch_size: int

    def with_features(self, features: torch.Tensor) -> "SparseTensor":
        return replace(self, features=features)


def batch_key(b: torch.Tensor, zyx: torch.Tensor, spatial_shape: Shape3) -> torch.Tensor:
    """Batch-folded key on the padded grid of (b, z, y, x); defined for
    -1 <= z <= D, -1 <= y <= H, -1 <= x <= W."""
    D, H, W = spatial_shape
    z, y, x = zyx[..., 0] + 1, zyx[..., 1] + 1, zyx[..., 2] + 1
    return ((b * (H + 2) + y) * (W + 2) + x) * (D + 2) + z


def _tap_deltas(offsets: np.ndarray, spatial_shape: Shape3, device) -> torch.Tensor:
    """Key differences of the (dz, dy, dx) offsets [K, 3]: [K] int64."""
    D, H, W = spatial_shape
    dz, dy, dx = offsets.T
    return torch.as_tensor((dy * (W + 2) + dx) * (D + 2) + dz, dtype=torch.int64, device=device)


def _in_grid(zyx: torch.Tensor, spatial_shape: Shape3) -> torch.Tensor:
    return ((zyx >= 0) & (zyx < torch.as_tensor(spatial_shape, device=zyx.device))).all(-1)


def from_voxels(voxel_feats: torch.Tensor, voxel_coords: torch.Tensor,
                spatial_shape: Shape3) -> SparseTensor:
    """[B, V, C] features + [B, V, 3] (z, y, x) coords (-1 on padding) ->
    the batch's active voxels as one key-sorted SparseTensor."""
    B, V, _ = voxel_feats.shape
    zyx = voxel_coords.to(torch.int64)
    b = torch.arange(B, device=zyx.device)[:, None].expand(B, V)
    keys = torch.where(_in_grid(zyx, spatial_shape), batch_key(b, zyx, spatial_shape),
                       torch.full_like(b, -1)).reshape(-1)
    keys, order = torch.sort(keys, stable=True)
    live = torch.nonzero(keys >= 0).squeeze(1)  # the padding sorts first
    keys, order = keys[live], order[live]
    coords = torch.cat([b.reshape(-1, 1), zyx.reshape(-1, 3)], 1)[order]
    return SparseTensor(voxel_feats.reshape(B * V, -1)[order], coords, keys,
                        tuple(spatial_shape), B)


def _decode(keys: torch.Tensor, spatial_shape: Shape3) -> torch.Tensor:
    """Batch-folded keys -> [N, 4] (b, z, y, x)."""
    D, H, W = spatial_shape
    z, r = keys % (D + 2) - 1, keys // (D + 2)
    x, r = r % (W + 2) - 1, r // (W + 2)
    y, b = r % (H + 2) - 1, r // (H + 2)
    return torch.stack([b, z, y, x], 1)


def kernel_offsets(kernel_size: Sequence[int]) -> np.ndarray:
    """All taps (kz, ky, kx) of a kernel in z-major order, [K, 3]."""
    kz, ky, kx = kernel_size
    return np.stack(np.meshgrid(np.arange(kz), np.arange(ky), np.arange(kx), indexing="ij"),
                    axis=-1).reshape(-1, 3)


def _neighbour_rows(st: SparseTensor, base: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Row of `st` whose key is base + delta for every base key [M] and tap
    delta [K], -1 where no active site has it: [M, K] int32."""
    q = base[:, None] + deltas[None, :]
    # a sentinel above every key ends the table: no query finds it, and an
    # empty stage needs no branch
    keys = torch.cat([st.keys, st.keys.new_full((1,), torch.iinfo(torch.int64).max)])
    idx = torch.searchsorted(keys, q)
    return torch.where(keys[idx] == q, idx, -1).to(torch.int32)


def subm_rules(st: SparseTensor, kernel_size: int = 3) -> torch.Tensor:
    """Neighbour map of a submanifold conv on `st`: [N, k³] int32."""
    offs = kernel_offsets((kernel_size,) * 3) - kernel_size // 2
    return _neighbour_rows(st, st.keys, _tap_deltas(offs, st.spatial_shape, st.keys.device))


def downsample_sites(st: SparseTensor, kernel_size: Sequence[int], stride: Sequence[int],
                     padding: Sequence[int], out_shape: Shape3) -> SparseTensor:
    """Output sites of a strided sparse conv (features left empty): every
    output o with an active input i in its receptive field,
    o·s - p <= i <= o·s - p + k - 1 per dimension."""
    dev = st.coords.device
    k = torch.as_tensor(kernel_size, device=dev)
    s = torch.as_tensor(stride, device=dev)
    p = torch.as_tensor(padding, device=dev)
    i = st.coords[:, 1:]
    # at most ceil(k / s) candidates per dimension, counting down from the highest
    n_cand = [-(-kd // sd) for kd, sd in zip(kernel_size, stride)]
    deltas = torch.as_tensor(kernel_offsets(n_cand), device=dev)
    o = torch.div(i + p, s, rounding_mode="floor")[None] - deltas[:, None]  # [C, N, 3]
    ok = ((o * s - p <= i) & (i <= o * s - p + k - 1)).all(-1) & _in_grid(o, out_shape)
    keys = torch.unique(batch_key(st.coords[None, :, 0], o, out_shape)[ok], sorted=True)
    return SparseTensor(st.features.new_empty(0), _decode(keys, out_shape), keys,
                        tuple(out_shape), st.batch_size)


def down_rules(st_in: SparseTensor, st_out: SparseTensor, kernel_size: Sequence[int],
               stride: Sequence[int], padding: Sequence[int]) -> torch.Tensor:
    """Neighbour map of a strided conv from `st_in` to the sites of `st_out`:
    [N_out, prod(kernel_size)] int32. With padding <= 1 every input it reads
    lies at most one site outside the input grid, where keys are defined."""
    if max(padding) > 1:
        raise ValueError(f"down_rules: padding {tuple(padding)} > 1 leaves the padded grid")
    dev = st_out.coords.device
    first = (st_out.coords[:, 1:] * torch.as_tensor(stride, device=dev)
             - torch.as_tensor(padding, device=dev))  # input site of tap 0
    base = batch_key(st_out.coords[:, 0], first, st_in.spatial_shape)
    deltas = _tap_deltas(kernel_offsets(kernel_size), st_in.spatial_shape, dev)
    return _neighbour_rows(st_in, base, deltas)


def to_dense_bev(st: SparseTensor) -> torch.Tensor:
    """Height compression: [N, C] sites of a (D, H, W) grid -> NCHW
    [B, C·D, H, W] with channel c·D + d (torch's view(N, C·D, H, W) fold)."""
    D, H, W = st.spatial_shape
    C = st.features.shape[1]
    dense = st.features.new_zeros(st.batch_size, D, H, W, C)
    b, z, y, x = st.coords.unbind(1)
    dense[b, z, y, x] = st.features
    return dense.permute(0, 4, 1, 2, 3).reshape(st.batch_size, C * D, H, W)


# ---------------------------------------------------------------------------
# the convolution
# ---------------------------------------------------------------------------


def sparse_conv_plain(features: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                      bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain version: per tap, an index_select from the features with a zero
    row appended, then a matmul; summed in f32, rounded once to the
    features' dtype."""
    n_in, cin = features.shape
    fz = torch.cat([features.float(), features.new_zeros(1, cin, dtype=torch.float32)])
    idx = torch.where(nbr < 0, n_in, nbr).long()
    out = features.new_zeros(nbr.shape[0], weight.shape[2], dtype=torch.float32)
    for k in range(weight.shape[0]):
        out.addmm_(fz.index_select(0, idx[:, k]), weight[k].float())
    if bias is not None:
        out += bias.float()
    return out.to(features.dtype)


def sparse_conv(features, nbr, weight, bias=None):
    """The plain convolution (autograd through its gathers and products)."""
    return sparse_conv_plain(features, nbr, weight, bias)
