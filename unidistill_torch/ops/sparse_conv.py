"""Sparse 3D convolution: the sparse tensor, its rulebooks, and kernel K4.

Counterpart of the JAX package's `ops/sparse_conv.py` (rulebooks) and
`ops/sparse_conv_pallas.py` (the convolution). The voxels of every sample of
a batch live in ONE tensor, its rows sorted by the batch-folded key

    ((b·(H+2) + y+1)·(W+2) + x+1)·(D+2) + z+1

the JAX xy-major `linear_key` (y·W + x)·D + z on a grid padded by one site
on every side, with the sample index folded in above it. So one rulebook and
one kernel launch serve the whole batch, a neighbour search never matches
across samples, and every neighbour a conv asks for, even one just outside
the grid, has a key of its own: the key of (z+dz, y+dy, x+dx) is the key of
(z, y, x) plus a per-tap constant. There are no fixed-shape caps: a stage
holds exactly its active sites.

Rulebooks are output-stationary neighbour maps `nbr [N_out, K] int32`:
`nbr[i, k]` is the input row that tap k of output site i reads, or -1. Taps
are z-major, k = (kz·ky_size + ky)·kx_size + kx, as in the JAX
`_kernel_offsets`, so a JAX weight [K, Cin, Cout] is used as it is.
  * submanifold 3×3×3 (`subm_rules`): output sites = input sites, tap k
    reads the site at offset (kz-1, ky-1, kx-1);
  * strided (`downsample_sites` + `down_rules`): a site is active iff at
    least one active input lies in its receptive field (spconv's rule), and
    tap k of output o reads input o·stride - padding + k.
The rulebooks are index arithmetic, sort and binary search: plain PyTorch,
as they are XLA (not Pallas) in the JAX package.

`sparse_conv(features, nbr, weight, bias)` launches kernel K4
(`csrc/sparse_conv.cu`) for CUDA tensors and raises on any failure; for CPU
tensors it runs `sparse_conv_plain`, the same function in plain PyTorch.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from unidistill_torch.kernels import build

Shape3 = Tuple[int, int, int]
K4_COUTS = (16, 32, 64, 128)
K4_DTYPES = {torch.float32: 0, torch.bfloat16: 1}


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


def linear_key(coords: torch.Tensor, spatial_shape: Shape3) -> Tuple[torch.Tensor, torch.Tensor]:
    """[..., 3] (z, y, x) -> ((y·W + x)·D + z, in-bounds mask); out-of-bounds
    coordinates get the sentinel D·H·W (the JAX `linear_key`)."""
    D, H, W = spatial_shape
    z, y, x = coords[..., 0], coords[..., 1], coords[..., 2]
    ok = (z >= 0) & (z < D) & (y >= 0) & (y < H) & (x >= 0) & (x < W)
    key = (y * W + x) * D + z
    return torch.where(ok, key, torch.full_like(key, D * H * W)), ok


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
    n_pad = int((keys < 0).sum().item())
    keys, order = keys[n_pad:], order[n_pad:]
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
    if st.keys.numel() == 0:
        return torch.full(q.shape, -1, dtype=torch.int32, device=q.device)
    idx = torch.searchsorted(st.keys, q).clamp_(max=st.keys.numel() - 1)
    return torch.where(st.keys[idx] == q, idx, -1).to(torch.int32)


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


def sparse_conv_cuda(features: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K4. features [N_in, Cin], weight [K, Cin, Cout] in one dtype
    (float32 or bfloat16), nbr [N_out, K] int32, bias [Cout] -> [N_out, Cout]
    in that dtype. Cin is zero-padded to a multiple of 16 here (the kernel's
    16-byte row loads); the padded weight rows are zero."""
    n_in, cin = features.shape
    K, wcin, cout = weight.shape
    for name, t in (("features", features), ("nbr", nbr), ("weight", weight)):
        if not t.is_cuda:
            raise ValueError(f"sparse_conv: {name} must be a CUDA tensor")
    if features.dtype not in K4_DTYPES or weight.dtype != features.dtype:
        raise ValueError(f"sparse_conv: features {features.dtype} and weight {weight.dtype} "
                         "must both be float32 or both bfloat16")
    if nbr.dtype != torch.int32 or nbr.dim() != 2 or nbr.shape[1] != K:
        raise ValueError(f"sparse_conv: nbr must be int32 [N_out, {K}], got {nbr.dtype} {tuple(nbr.shape)}")
    if wcin != cin or cout not in K4_COUTS or K > 27:
        raise ValueError(f"sparse_conv: weight {tuple(weight.shape)} does not fit features "
                         f"[{n_in}, {cin}] (Cout in {K4_COUTS}, K <= 27)")
    if max(n_in, nbr.shape[0]) >= 2**31:
        raise ValueError("sparse_conv: too many rows for the kernel's int32 row counts")
    pad = -cin % 16
    if pad:
        features = torch.nn.functional.pad(features, (0, pad))
        weight = torch.nn.functional.pad(weight, (0, 0, 0, pad))
    features, nbr, weight = features.contiguous(), nbr.contiguous(), weight.contiguous()
    if features.data_ptr() % 16 or weight.data_ptr() % 16:
        raise ValueError("sparse_conv: features and weight must be 16-byte aligned")
    b32 = None
    if bias is not None:
        if tuple(bias.shape) != (cout,) or not bias.is_cuda:
            raise ValueError(f"sparse_conv: bias must be a CUDA tensor of shape ({cout},)")
        b32 = bias.float().contiguous()
    out = torch.empty(nbr.shape[0], cout, dtype=features.dtype, device=features.device)
    if out.shape[0] == 0:  # nothing to launch
        return out
    lib = build.library("sparse_conv")
    err = lib.sparse_conv_fwd(
        features.data_ptr(), nbr.data_ptr(), weight.data_ptr(),
        None if b32 is None else b32.data_ptr(), out.data_ptr(),
        n_in, nbr.shape[0], K, cin + pad, cout, K4_DTYPES[features.dtype],
        torch.cuda.current_stream(features.device).cuda_stream,
    )
    build.check(err, "sparse_conv_fwd")
    build.LAUNCHES["sparse_conv_fwd"] += 1
    return out


def sparse_conv(features: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[i] = bias + Σ_k weight[k]ᵀ·features[nbr[i, k]] (missing taps add
    nothing), summed in f32 and returned in the features' dtype. On the card
    K4 has no backward yet, so a call that autograd would differentiate
    raises instead of returning a result without a gradient."""
    if not features.is_cuda:
        return sparse_conv_plain(features, nbr, weight, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (features, weight, bias)):
        raise NotImplementedError("sparse_conv: K4 has no backward yet; run the LiDAR encoder "
                                  "on the card under torch.no_grad() or with frozen weights")
    return sparse_conv_cuda(features, nbr, weight, bias)
