"""Swin Transformer image backbone, counterpart of the JAX `layers/swin.py`.

The reference's Swin-T camera variant (embed 96, depths (2, 2, 6, 2), heads
(3, 6, 12, 24), window 7, out_indices (1, 2, 3)): a 4×4/4 patch-embed conv
and LayerNorm; per stage, alternating W-MSA / SW-MSA blocks with relative
position bias and 4× MLPs; patch merging (2×2 concat -> LayerNorm ->
linear) between stages; a LayerNorm on each emitted output. No drop path
(the JAX module has none).

Numerics kept from the JAX module:
  * every LayerNorm runs in float32 (eps 1e-5); the linear layers and the
    patch-embed conv in the compute dtype (`common.Linear`, `Conv2d`);
  * the residual stream keeps the dtype it entered with: float32 after
    `patch_norm`, the compute dtype after a patch merge;
  * scores are q·kᵀ in the compute dtype, times head_dim^-0.5, plus the
    bias table's entries and the shift mask cast to that dtype; the
    softmax runs in float32 and is cast back;
  * GELU is erf's; the shift mask holds -100 (not -inf);
  * each stage pads H and W to a multiple of the window once, before its
    blocks, and crops after them (the padded zeros take part in the
    LayerNorms and the attention, as in JAX);
  * windows are ordered (B, H/ws, W/ws); merging concatenates the 2×2
    positions position-major, channel (2ky+kx)·C + c (mmdet's Unfold is
    channel-major: `training/torch_import.py` permutes).
The attention is plain tensor products in the JAX order (no kernel: the
JAX module computes it with `einsum`, outside any Pallas kernel).

Input and outputs are NCHW, as the neck takes them; inside, NHWC.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn
import torch.nn.functional as F

from unidistill_torch.layers.common import Conv2d, LayerNorm, Linear


def _window_partition(x: torch.Tensor, ws: int) -> torch.Tensor:
    """[B, H, W, C] -> [B·(H/ws)·(W/ws), ws·ws, C]."""
    B, H, W, C = x.shape
    x = x.reshape(B, H // ws, ws, W // ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)


def _window_reverse(wins: torch.Tensor, ws: int, B: int, H: int, W: int) -> torch.Tensor:
    C = wins.shape[-1]
    x = wins.reshape(B, H // ws, W // ws, ws, ws, C)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(B, H, W, C)


def _shift_attn_mask(H: int, W: int, ws: int, shift: int) -> np.ndarray:
    """[nW, N, N] additive mask (0 or -100) of the shifted windows."""
    img = np.zeros((1, H, W, 1), np.float32)
    cnt = 0
    for h in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
        for w in (slice(0, -ws), slice(-ws, -shift), slice(-shift, None)):
            img[:, h, w, :] = cnt
            cnt += 1
    wins = img.reshape(1, H // ws, ws, W // ws, ws, 1)
    wins = wins.transpose(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws)
    diff = wins[:, None, :] - wins[:, :, None]
    return np.where(diff != 0, -100.0, 0.0).astype(np.float32)


def _relative_index(ws: int) -> np.ndarray:
    """[N·N] rows of the bias table for each (query, key) pair of a window."""
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws), indexing="ij")).reshape(2, -1)
    rel = coords[:, :, None] - coords[:, None, :]
    rel = (rel + ws - 1).transpose(1, 2, 0)
    return (rel[..., 0] * (2 * ws - 1) + rel[..., 1]).reshape(-1)


class WindowAttention(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int):
        super().__init__()
        self.dim, self.num_heads, self.window_size = dim, num_heads, window_size
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("rel_index", torch.from_numpy(_relative_index(window_size)),
                             persistent=False)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x [nW·B, N, C] in the compute dtype; mask [nW, N, N] or None."""
        nh, N = self.num_heads, self.window_size ** 2
        hd = self.dim // nh
        dt = self.qkv.compute_dtype
        q, k, v = self.qkv(x).reshape(-1, N, 3, nh, hd).permute(2, 0, 3, 1, 4)
        attn = torch.matmul(q, k.transpose(-2, -1)) * hd ** -0.5
        bias = self.relative_position_bias_table[self.rel_index].reshape(N, N, nh)
        attn = attn + bias.permute(2, 0, 1)[None].to(attn.dtype)
        if mask is not None:
            nW = mask.shape[0]
            attn = attn.reshape(-1, nW, nh, N, N) + mask[None, :, None].to(attn.dtype)
            attn = attn.reshape(-1, nh, N, N)
        attn = torch.softmax(attn.float(), dim=-1).to(dt)
        out = torch.matmul(attn, v.to(dt)).transpose(1, 2).reshape(-1, N, self.dim)
        return self.proj(out)


class SwinBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int = 7, shift: int = 0,
                 mlp_ratio: float = 4.0):
        super().__init__()
        self.window_size, self.shift = window_size, shift
        self.norm1 = LayerNorm(dim)
        self.attn = WindowAttention(dim, num_heads, window_size)
        self.norm2 = LayerNorm(dim)
        self.mlp_fc1 = Linear(dim, int(dim * mlp_ratio))
        self.mlp_fc2 = Linear(int(dim * mlp_ratio), dim)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor]) -> torch.Tensor:
        """x [B, H, W, C], H and W multiples of the window; `mask` the
        shifted windows' mask (used when the block shifts)."""
        B, H, W, _ = x.shape
        ws, s = self.window_size, self.shift
        shortcut = x
        y = self.norm1(x)
        if s:
            y = torch.roll(y, (-s, -s), dims=(1, 2))
        wins = self.attn(_window_partition(y.to(self.attn.qkv.compute_dtype), ws), mask if s else None)
        y = _window_reverse(wins, ws, B, H, W)
        if s:
            y = torch.roll(y, (s, s), dims=(1, 2))
        x = shortcut + y.to(shortcut.dtype)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))
        return x + y.to(x.dtype)


def _same_pad(x: torch.Tensor, k: int, s: int) -> torch.Tensor:
    """flax's "SAME" padding of an NCHW input for a k×k / s conv."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // s) - 1) * s + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


class SwinTransformer(nn.Module):
    def __init__(self, embed_dim: int = 96, depths: Sequence[int] = (2, 2, 6, 2),
                 num_heads: Sequence[int] = (3, 6, 12, 24), window_size: int = 7,
                 out_indices: Tuple[int, ...] = (1, 2, 3)):
        super().__init__()
        self.depths, self.window_size, self.out_indices = tuple(depths), window_size, tuple(out_indices)
        self.patch_embed = Conv2d(3, embed_dim, 4, stride=4, bias=True)
        self.patch_norm = LayerNorm(embed_dim)
        dim = embed_dim
        for stage, depth in enumerate(self.depths):
            for blk in range(depth):
                self.add_module(f"stage{stage}_block{blk}", SwinBlock(
                    dim, num_heads[stage], window_size, 0 if blk % 2 == 0 else window_size // 2))
            if stage in self.out_indices:
                self.add_module(f"out_norm{stage}", LayerNorm(dim))
            if stage < len(self.depths) - 1:
                self.add_module(f"merge_norm{stage}", LayerNorm(4 * dim))
                self.add_module(f"merge_reduction{stage}", Linear(4 * dim, 2 * dim, bias=False))
                dim *= 2
        # the shifted windows' masks by (padded H, W, device), made once (a
        # copy to the card waits for it); an exported program holds its own
        self._masks: Dict[tuple, torch.Tensor] = {}

    def _mask(self, H: int, W: int, device: torch.device) -> torch.Tensor:
        ws = self.window_size
        if torch.compiler.is_exporting():
            return torch.from_numpy(_shift_attn_mask(H, W, ws, ws // 2)).to(device)
        key = (H, W, str(device))
        if key not in self._masks:
            self._masks[key] = torch.from_numpy(_shift_attn_mask(H, W, ws, ws // 2)).to(device)
        return self._masks[key]

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        """x [B, 3, H, W] -> float32 NCHW maps of `out_indices` (stage i:
        stride 4·2^i, width embed·2^i)."""
        x = self.patch_norm(self.patch_embed(_same_pad(x, 4, 4)).permute(0, 2, 3, 1))
        ws = self.window_size
        outs = []
        for stage, depth in enumerate(self.depths):
            B, H, W, C = x.shape
            xp = F.pad(x, (0, 0, 0, -W % ws, 0, -H % ws))
            mask = self._mask(xp.shape[1], xp.shape[2], x.device) if depth > 1 else None
            for blk in range(depth):
                xp = getattr(self, f"stage{stage}_block{blk}")(xp, mask)
            x = xp[:, :H, :W]
            if stage in self.out_indices:
                outs.append(getattr(self, f"out_norm{stage}")(x).permute(0, 3, 1, 2))
            if stage < len(self.depths) - 1:
                xm = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
                B2, H2, W2, _ = xm.shape
                xm = xm.reshape(B2, H2 // 2, 2, W2 // 2, 2, C).permute(0, 1, 3, 2, 4, 5)
                xm = getattr(self, f"merge_norm{stage}")(xm.reshape(B2, H2 // 2, W2 // 2, 4 * C))
                x = getattr(self, f"merge_reduction{stage}")(xm)
        return outs
