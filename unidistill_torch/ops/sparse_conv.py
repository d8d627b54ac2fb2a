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

The backward reads the same maps the other way round. `transpose_rules`
gives the input-stationary map `nbr_t [N_in, K]`: nbr_t[i, k] = o iff
nbr[o, k] = i (-1 where no output reads input i at tap k). Every (input,
tap) pair is read by at most one output: at stride 1 the offset fixes it,
at stride s the output o = (i + p - k) / s per dimension. For a submanifold
map nbr_t is nbr with its taps reversed.

`sparse_conv(features, nbr, weight, bias, nbr_t=None)` launches kernel K4
(`csrc/sparse_conv.cu`) for CUDA tensors and raises on any failure; when
autograd needs its gradient it runs as `SparseConv`, whose backward is
  dfeat = K4 over nbr_t with W[k]ᵀ (`sparse_conv_dgrad_cuda`),
  dW[k] = Σ_o features[nbr[o, k]]ᵀ·g[o], kernel K6 (`sparse_conv_wgrad_cuda`),
  dbias = Σ_o g[o] (a plain reduction);
the counterpart of the JAX custom VJP `_subm_bwd`. In bf16 (every model
path) K4 and K6 multiply on the tensor cores. K6 there is a gathered GEMM
per tap (M = Cin, N = Cout, summed over row tiles of `k6_tile_rows`): one
block per (tap, chunk of rows), the tap fastest so that a chunk's blocks
share its map and g rows in L2, the chunks (`k6_plan`, about K6_WAVES
waves) added in order by a second kernel, so reruns are bit-identical.
Like K4's tiles, it multiplies every row of a tile that has any neighbour
at the tap, so at 64 and 128 channels its dense-tile mma work bounds it,
at 16 and 32 channels its gathers and map reads. For CPU tensors it runs
`sparse_conv_plain`, the same function in plain PyTorch, which autograd
differentiates; `sparse_conv_dgrad_plain` and `sparse_conv_wgrad_plain` are
the backward kernels' plain versions.
"""
from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass, replace
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from unidistill_torch.kernels import build

Shape3 = Tuple[int, int, int]
K4_COUTS = (16, 32, 64, 128)
K4_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
K4_TILE_ROWS = 128  # output rows a block of K4's bf16 kernel owns (`kTcRows` in csrc/sparse_conv.cu)
K6_CHANNELS = (16, 32, 64, 128)  # Cin (after padding to 16) and Cout
# K6 splits the output rows into chunks of whole row tiles (`k6_plan`); one
# block per (tap, chunk) writes its partial [Cin, Cout] sum, a second kernel
# adds the chunks in chunk order. The f32 kernel takes 32-row tiles
# (`kWRows` in csrc/sparse_conv.cu) in up to 64 chunks, the bf16 kernel
# `k6_tile_rows` in about K6_WAVES waves of blocks, at most K6_MAX_CHUNKS:
# with few taps (conv_out, K = 3) two waves would give chunks of a few tiles
# whose [Cin, Cout] partials, written and read back, outweigh their rows.
K6_F32_ROWS = 32
K6_F32_CHUNKS = 64
K6_WAVES = 2
K6_MAX_CHUNKS = 128


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


def _check_conv_args(what: str, features: torch.Tensor, nbr: torch.Tensor, K: int, cin: int) -> None:
    """features [N_in, cin] float32 or bfloat16 and nbr [N, K] int32, both
    on the card, with row counts the kernels' int32 counters hold."""
    for name, t in (("features", features), ("nbr", nbr)):
        if not t.is_cuda:
            raise ValueError(f"{what}: {name} must be a CUDA tensor")
    if features.dtype not in K4_DTYPES:
        raise ValueError(f"{what}: features must be float32 or bfloat16, got {features.dtype}")
    if features.dim() != 2 or features.shape[1] != cin:
        raise ValueError(f"{what}: features {tuple(features.shape)} must be [N_in, {cin}]")
    if nbr.dtype != torch.int32 or nbr.dim() != 2 or nbr.shape[1] != K or K > 27:
        raise ValueError(f"{what}: nbr must be int32 [N, {K}] (K <= 27), got {nbr.dtype} {tuple(nbr.shape)}")
    if max(features.shape[0], nbr.shape[0]) >= 2**31:
        raise ValueError(f"{what}: too many rows for the kernel's int32 row counts")


def _pad16(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x zero-padded along `dim` (counted from the end) to a multiple of 16,
    contiguous and 16-byte aligned: the kernels load rows 16 bytes at a
    time."""
    pad = -x.shape[-dim] % 16
    if pad:
        x = torch.nn.functional.pad(x, (0, 0) * (dim - 1) + (0, pad))
    x = x.contiguous()
    if x.data_ptr() % 16:
        raise ValueError("sparse_conv: a kernel input is not 16-byte aligned")
    return x


def _launch_k4(name: str, features: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
               bias: Optional[torch.Tensor], transposed: bool = False) -> torch.Tensor:
    """One launch of K4, counted under `name` (none for an empty map). With
    `transposed` the conv's weight is `weight.transpose(1, 2)`: the bf16
    kernel reads it so (w_layout 1), the f32 kernel from a transposed copy."""
    w = weight.transpose(1, 2) if transposed else weight
    K, cin, cout = w.shape
    _check_conv_args(name, features, nbr, K, cin)
    if not weight.is_cuda or weight.dtype != features.dtype:
        raise ValueError(f"{name}: weight must be a CUDA tensor of the features' dtype {features.dtype}")
    if cout not in K4_COUTS:
        raise ValueError(f"{name}: Cout {cout} is not one of {K4_COUTS}")
    b32 = None
    if bias is not None:
        if tuple(bias.shape) != (cout,) or not bias.is_cuda:
            raise ValueError(f"{name}: bias must be a CUDA tensor of shape ({cout},)")
        b32 = bias.float().contiguous()
    out = torch.empty(nbr.shape[0], cout, dtype=features.dtype, device=features.device)
    if out.shape[0] == 0:  # nothing to launch
        return out
    w_layout = int(transposed and features.dtype == torch.bfloat16)
    features, nbr = _pad16(features, 1), nbr.contiguous()
    w = _pad16(weight, 1) if w_layout else _pad16(w, 2)
    lib = build.library("sparse_conv")
    err = lib.sparse_conv_fwd(
        features.data_ptr(), nbr.data_ptr(), w.data_ptr(),
        None if b32 is None else b32.data_ptr(), out.data_ptr(),
        features.shape[0], nbr.shape[0], K, features.shape[1], cout, K4_DTYPES[features.dtype],
        w_layout, torch.cuda.current_stream(features.device).cuda_stream,
    )
    build.check(err, name)
    build.LAUNCHES[name] += 1
    return out


def sparse_conv_cuda(features: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Kernel K4. features [N_in, Cin], weight [K, Cin, Cout] in one dtype
    (float32 or bfloat16), nbr [N_out, K] int32, bias [Cout] -> [N_out, Cout]
    in that dtype. bfloat16 runs on the tensor cores (bf16 `mma.sync`, f32
    sums), float32 on the CUDA cores. Cin is zero-padded to a multiple of 16
    here (the kernel's 16-byte row loads); the padded weight rows are zero."""
    return _launch_k4("sparse_conv_fwd", features, nbr, weight, bias)


def sparse_conv_dgrad_plain(g: torch.Tensor, nbr_t: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """Plain version of the input gradient: the conv of g [N_out, Cout] over
    the transposed map nbr_t [N_in, K] with W[k]ᵀ -> [N_in, Cin]."""
    return sparse_conv_plain(g, nbr_t, weight.transpose(1, 2))


def sparse_conv_dgrad_cuda(g: torch.Tensor, nbr_t: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """K4 as the input gradient of a sparse conv, counted as
    `sparse_conv_dgrad`: g [N_out, Cout] and weight [K, Cin, Cout] in one
    dtype, nbr_t [N_in, K] int32 (`transpose_rules`) -> dfeat [N_in, Cin] in
    that dtype. Cin must be one of K4's output widths. In bfloat16 the
    kernel reads W[k]ᵀ from the weight as it is (no transposed copy)."""
    return _launch_k4("sparse_conv_dgrad", g, nbr_t, weight, None, transposed=True)


def sparse_conv_wgrad_plain(features: torch.Tensor, g: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """Plain version of K6: per tap, the feature rows it read
    (`index_select`, a zero row for -1) times g, in f32 -> [K, Cin, Cout]."""
    n_in, cin = features.shape
    fz = torch.cat([features.float(), features.new_zeros(1, cin, dtype=torch.float32)])
    idx = torch.where(nbr < 0, n_in, nbr).long()
    g32 = g.float()
    return torch.stack([fz.index_select(0, idx[:, k]).t().mm(g32) for k in range(nbr.shape[1])])


def k6_tile_rows(cin: int, cout: int) -> int:
    """Output rows a step of K6's bf16 kernel stages (`WgradTc::kRows` in
    csrc/sparse_conv.cu): 128, or 64 where the channels are wide."""
    return 64 if cin + cout > 128 else 128


def k6_plan(n_out: int, tile_rows: int, want_chunks: int) -> Tuple[int, int]:
    """K6's row split: (chunks, rows a chunk), each chunk a whole number of
    `tile_rows`-row tiles, none empty, as close to `want_chunks` (and at
    most K6_MAX_CHUNKS) as whole tiles allow. A function of its arguments
    only, so a rerun sums in the same order."""
    tiles = -(-n_out // tile_rows)
    per = -(-tiles // max(1, min(want_chunks, tiles, K6_MAX_CHUNKS)))
    return -(-tiles // per), per * tile_rows


def k6_chunks_wanted(K: int, sms: int, blocks_per_sm: int) -> int:
    """Chunks that make about K6_WAVES waves of K6's (tap, chunk) blocks on
    `sms` SMs that hold `blocks_per_sm` blocks each."""
    return -(-K6_WAVES * sms * blocks_per_sm // K)


@functools.lru_cache(maxsize=None)
def _k6_blocks_per_sm(cin: int, cout: int, device_index: int) -> int:
    lib = build.library("sparse_conv")
    blocks = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        build.check(lib.sparse_conv_wgrad_blocks_per_sm(cin, cout, ctypes.byref(blocks)),
                    "sparse_conv_wgrad_blocks_per_sm")
    if blocks.value < 1:
        raise RuntimeError(f"sparse_conv_wgrad: the bf16 instance {cin}x{cout} fits no SM")
    return blocks.value


def k6_launch_plan(n_out: int, K: int, cin: int, cout: int, dtype: torch.dtype,
                   device: torch.device) -> Tuple[int, int]:
    """(chunks, rows a chunk) of a K6 launch on `device`; Cin as padded.
    float32: 32-row tiles in up to 64 chunks; bfloat16: `k6_tile_rows`,
    about K6_WAVES waves of blocks on the device's SMs."""
    if dtype == torch.float32:
        return k6_plan(n_out, K6_F32_ROWS, K6_F32_CHUNKS)
    index = device.index if device.index is not None else torch.cuda.current_device()
    sms = torch.cuda.get_device_properties(index).multi_processor_count
    want = k6_chunks_wanted(K, sms, _k6_blocks_per_sm(cin, cout, index))
    return k6_plan(n_out, k6_tile_rows(cin, cout), want)


def sparse_conv_wgrad_cuda(features: torch.Tensor, g: torch.Tensor, nbr: torch.Tensor) -> torch.Tensor:
    """Kernel K6: dW[k] = Σ_o features[nbr[o, k]]ᵀ · g[o], summed in f32 in a
    fixed order (deterministic). features [N_in, Cin] and g [N_out, Cout] in
    one dtype (float32 or bfloat16), nbr [N_out, K] int32 -> [K, Cin, Cout]
    float32. bfloat16 runs on the tensor cores (bf16 `mma.sync`, f32 sums),
    float32 on the CUDA cores. Cin is zero-padded to a multiple of 16 here,
    as for K4."""
    n_in, cin = features.shape
    K = nbr.shape[-1]
    _check_conv_args("sparse_conv_wgrad", features, nbr, K, cin)
    if not g.is_cuda or g.dtype != features.dtype or g.dim() != 2 or g.shape[0] != nbr.shape[0]:
        raise ValueError(f"sparse_conv_wgrad: g {g.dtype} {tuple(g.shape)} must be a CUDA tensor of the "
                         f"features' dtype with one row per row of nbr {tuple(nbr.shape)}")
    n_out, cout = g.shape
    cin_p = cin + -cin % 16
    if cin_p not in K6_CHANNELS or cout not in K6_CHANNELS:
        raise ValueError(f"sparse_conv_wgrad: Cin {cin} (padded {cin_p}) and Cout {cout} "
                         f"must be in {K6_CHANNELS}")
    if n_out == 0:  # nothing to launch
        return torch.zeros(K, cin, cout, dtype=torch.float32, device=g.device)
    dw = torch.empty(K, cin_p, cout, dtype=torch.float32, device=g.device)
    x, g, nbr = _pad16(features, 1), _pad16(g, 1), nbr.contiguous()
    chunks, rows = k6_launch_plan(n_out, K, cin_p, cout, g.dtype, g.device)
    partial = torch.empty(chunks, K, cin_p, cout, dtype=torch.float32, device=g.device)
    lib = build.library("sparse_conv")
    err = lib.sparse_conv_wgrad(
        x.data_ptr(), g.data_ptr(), nbr.data_ptr(), partial.data_ptr(), dw.data_ptr(),
        n_in, n_out, K, cin_p, cout, chunks, rows, K4_DTYPES[g.dtype],
        torch.cuda.current_stream(g.device).cuda_stream,
    )
    build.check(err, "sparse_conv_wgrad")
    build.LAUNCHES["sparse_conv_wgrad"] += 1
    return dw[:, :cin]


def transpose_rules(nbr: torch.Tensor, n_in: int) -> torch.Tensor:
    """The input-stationary map of `nbr` [N_out, K]: [n_in, K] int32 with
    nbr_t[i, k] = o where nbr[o, k] = i, else -1. One scatter; entries with
    no input land in a dump slot past the end, which is cut off."""
    n_out, K = nbr.shape
    dev = nbr.device
    flat = torch.where(nbr >= 0, nbr.long() * K + torch.arange(K, device=dev), n_in * K).reshape(-1)
    rows = torch.arange(n_out, dtype=torch.int32, device=dev)[:, None].expand(n_out, K).reshape(-1)
    nbr_t = torch.full((n_in * K + 1,), -1, dtype=torch.int32, device=dev)
    nbr_t.scatter_(0, flat, rows)
    return nbr_t[: n_in * K].reshape(n_in, K)


class SparseConv(torch.autograd.Function):
    """K4 forward; backward K4 over the transposed map (dfeat) and K6 (dW),
    as the JAX custom VJP `_subm_bwd` (sparse_conv_pallas.py:279)."""

    @staticmethod
    def forward(ctx, features, nbr, weight, bias, nbr_t):
        ctx.save_for_backward(features, nbr, weight, nbr_t)
        ctx.bias_dtype = None if bias is None else bias.dtype
        return sparse_conv_cuda(features, nbr, weight, bias)

    @staticmethod
    def backward(ctx, g):
        features, nbr, weight, nbr_t = ctx.saved_tensors
        g = g.to(features.dtype).contiguous()  # as JAX: g in the features' dtype
        dfeat = dweight = dbias = None
        if ctx.needs_input_grad[0]:
            if nbr_t is None:
                nbr_t = transpose_rules(nbr, features.shape[0])
            dfeat = sparse_conv_dgrad_cuda(g, nbr_t, weight)
        if ctx.needs_input_grad[2]:
            dweight = sparse_conv_wgrad_cuda(features, g, nbr).to(weight.dtype)
        if ctx.needs_input_grad[3]:
            dbias = g.float().sum(0).to(ctx.bias_dtype)
        return dfeat, None, dweight, dbias, None


def sparse_conv(features: torch.Tensor, nbr: torch.Tensor, weight: torch.Tensor,
                bias: Optional[torch.Tensor] = None, nbr_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """out[i] = bias + Σ_k weight[k]ᵀ·features[nbr[i, k]] (missing taps add
    nothing), summed in f32 and returned in the features' dtype. On the card
    a call that autograd differentiates runs as `SparseConv`; `nbr_t`, the
    transposed map (`transpose_rules(nbr, N_in)`), may be given so that convs
    sharing a map share it too, else the backward builds it."""
    if not features.is_cuda:
        return sparse_conv_plain(features, nbr, weight, bias)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (features, weight, bias)):
        return SparseConv.apply(features, nbr, weight, bias, nbr_t)
    return sparse_conv_cuda(features, nbr, weight, bias)
