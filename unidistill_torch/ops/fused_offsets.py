"""The chunked submanifold conv's offsets as one fused select + product
(kernel K7), the smoke kernel (K8), and `fused_subm`, the conv that runs K7.

Counterparts of the JAX experiment `experiments/mb_pallas_fused.py`:

  fused_offsets(g [B, 8, S, 10C] bf16, case_oh [B, 8, S, 4] bf16 one-hot,
                W8 [8, 6C, 4co] bf16) -> [B, S, 4co] f32
      = sum_{o=0..7} win(case_o, g[:, o]) @ W8[o]

where win selects the 6C window lanes of a gathered window-table row by its
case (`ops.sparse_conv_chunked._extract_subm_window`) as a multiply-add by
the one-hot: case 0 lanes 0:6C, case 1 lanes 4C:10C, case 2 [zeros 4C |
lanes 0:2C], in the inputs' dtype as the Pallas kernel computes it. On a
CUDA tensor it launches K7 (`csrc/fused_offsets.cu`); on a CPU tensor it
runs `fused_offsets_plain`, the same function in plain PyTorch with the
products in f32. K7 copies a one-hot row's window piece by piece
(`piece_sources` models which lanes); `k7_work` counts what its inputs
need of the card.

  axpy2(x, y) = 2x + y in bf16 (the Pallas `smoke` kernel's body): K8 on a
  CUDA tensor, `smoke_plain` on a CPU tensor.

`fused_subm` is the chunked subm conv (`_subm_impl`) with its 8 offsets'
case select and products fused into K7: window table -> per-sample
`rowgather` -> one-hot of the case -> K7 -> the center offset's product ->
occupancy mask.
"""
from __future__ import annotations

import torch

from unidistill_torch.kernels import build
from unidistill_torch.ops.sparse_conv_chunked import (
    _OFFS8, ChunkedTables, _band_weight, _w_zyx, _window_table, rowgather, zmask)

K7_CO4 = (64, 128, 256)  # 4·co the kernel is built for (co 16, 32, 64)
# sites a K7 tile holds, by 4·co: the W8 stack crosses L2 once a tile
K7_TILE_ROWS = {64: 256, 128: 256, 256: 128}
_ONE = 0x3F80  # bf16 bits of 1.0


def _select_window(g: torch.Tensor, case_oh: torch.Tensor) -> torch.Tensor:
    """[..., 10C] rows and [..., 4] one-hot -> [..., 6C] windows in f32:
    the Pallas kernel's multiply-add (oh0·w0 + oh1·w1) + oh2·w2 in the
    inputs' dtype, each product and sum rounded to it (exact for one-hot
    rows)."""
    C = g.shape[-1] // 10
    m = case_oh.to(g.dtype)
    w0 = g[..., 0:6 * C]
    w1 = g[..., 4 * C:10 * C]
    w2 = torch.cat([torch.zeros_like(g[..., 0:4 * C]), g[..., 0:2 * C]], -1)
    return (m[..., 0:1] * w0 + m[..., 1:2] * w1 + m[..., 2:3] * w2).float()


def fused_offsets_plain(g: torch.Tensor, case_oh: torch.Tensor, W8: torch.Tensor) -> torch.Tensor:
    """Plain version of K7: the select as the Pallas kernel computes it, the
    products in f32."""
    return torch.einsum("bosw,owk->bsk", _select_window(g, case_oh), W8.float())


def piece_sources(case_oh: torch.Tensor, C: int):
    """K7's select as copies (`k7_case` and the producer's lane arithmetic
    in `csrc/fused_offsets.cu`): for each 8-lane piece p of a row's 6C
    window, the first g lane it copies, or -1 where the copy writes zeros;
    and which rows are not copies but the multiply-add, those whose first
    three one-hot values are not one 1.0 and zeros (of either sign).
    case_oh [..., 4] bf16 -> (src [..., 6C / 8] int64, general [...] bool)."""
    bits = case_oh.contiguous().view(torch.int16).long() & 0xFFFF
    h = bits[..., :3]
    zero = (h & 0x7FFF) == 0
    one = h == _ONE
    z0, z1, z2 = zero.unbind(-1)
    o0, o1, o2 = one.unbind(-1)
    case = torch.full(h.shape[:-1], 4, dtype=torch.int64, device=h.device)
    case = torch.where(z0 & z1 & o2, 2, case)
    case = torch.where(z0 & o1 & z2, 1, case)
    case = torch.where(o0 & z1 & z2, 0, case)
    case = torch.where(z0 & z1 & z2, 3, case)
    shift = torch.tensor([0, 4 * C, -4 * C, 0, 0], device=h.device)[case]  # source lane - window lane
    low = torch.tensor([0, 0, 4 * C, 6 * C, 0], device=h.device)[case]    # window lanes below are zero
    p = torch.arange(0, 6 * C, 8, device=h.device)
    src = torch.where(p >= low[..., None], p + shift[..., None], -1)
    return src, case == 4


def k7_work(case_oh: torch.Tensor, C: int, co4: int, tile_rows: int) -> dict:
    """What K7's inputs need of the card: the g lanes read (the union of
    the lanes each nonzero one-hot value selects: 6C for case 0 or 1, 2C
    for case 2, none for an all-zero row), the window lanes that can be
    nonzero (the products' depth), HBM bytes (those g lanes, the one-hot
    and W8 read once, the f32 output written once), operations (2 per
    multiply-add of those window lanes by 4·co outputs), and the bytes of
    W8 that cross L2 when every block of `tile_rows` sites reads the whole
    stack. case_oh [B, 8, S, 4]."""
    B, _, S, _ = case_oh.shape
    nz = (case_oh[..., :3] != 0).reshape(-1, 3).long()
    n0, n1, n2 = nz.unbind(-1)
    # g in five blocks of 2C lanes: oh0 reads blocks 0-2, oh1 blocks 2-4, oh2 block 0
    g_blocks = ((n0 | n2) + n0 + (n0 | n1) + n1 + n1).sum().item()
    # the window in three blocks of 2C: oh0 and oh1 fill all three, oh2 the last
    w_blocks = (3 * (n0 | n1) + ((n0 | n1) ^ 1) * n2).sum().item()
    w8_bytes = 8 * 6 * C * co4 * 2
    return dict(g_lanes=2 * C * g_blocks, window_lanes=2 * C * w_blocks,
                hbm_bytes=2 * C * g_blocks * 2 + case_oh.numel() * 2 + w8_bytes + B * S * co4 * 4,
                ops=2 * 2 * C * w_blocks * co4, w8_l2_bytes=B * -(-S // tile_rows) * w8_bytes)


def _check_fused_args(g, case_oh, W8):
    if g.dim() != 4 or g.shape[1] != 8 or g.shape[3] % 10:
        raise ValueError(f"fused_offsets: g must be [B, 8, S, 10C], got {tuple(g.shape)}")
    B, _, S, L = g.shape
    C = L // 10
    if tuple(case_oh.shape) != (B, 8, S, 4):
        raise ValueError(f"fused_offsets: case_oh {tuple(case_oh.shape)} != {(B, 8, S, 4)}")
    if W8.dim() != 3 or tuple(W8.shape[:2]) != (8, 6 * C):
        raise ValueError(f"fused_offsets: W8 must be [8, {6 * C}, 4co], got {tuple(W8.shape)}")
    return B, S, C, W8.shape[2]


def fused_offsets_cuda(g: torch.Tensor, case_oh: torch.Tensor, W8: torch.Tensor) -> torch.Tensor:
    """Kernel K7; shapes as `fused_offsets`, C a multiple of 16, 4co in
    K7_CO4, all bf16 contiguous CUDA tensors. Two launches: W8 laid out
    as the kernel's shared memory holds it (into scratch of W8's size),
    then K7."""
    B, S, C, co4 = _check_fused_args(g, case_oh, W8)
    for name, t in (("g", g), ("case_oh", case_oh), ("W8", W8)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"fused_offsets: {name} must be a contiguous bfloat16 CUDA tensor")
    if C % 16 or co4 not in K7_CO4:
        raise ValueError(f"fused_offsets: C={C} (a multiple of 16) and 4co={co4} (one of {K7_CO4})")
    out = torch.empty(B, S, co4, dtype=torch.float32, device=g.device)
    w8_tiles = torch.empty_like(W8)  # W8 in the kernel's shared-memory layout, one k-step a tile
    err = build.library("fused_offsets").fused_offsets(
        g.data_ptr(), case_oh.data_ptr(), W8.data_ptr(), w8_tiles.data_ptr(), out.data_ptr(), B, S, C, co4,
        torch.cuda.current_stream(g.device).cuda_stream)
    build.check(err, "fused_offsets")
    build.LAUNCHES["fused_offsets"] += 1
    return out


def fused_offsets(g: torch.Tensor, case_oh: torch.Tensor, W8: torch.Tensor) -> torch.Tensor:
    """K7 for CUDA tensors, its plain version for CPU tensors."""
    if g.is_cuda:
        return fused_offsets_cuda(g, case_oh, W8)
    _check_fused_args(g, case_oh, W8)
    return fused_offsets_plain(g, case_oh, W8)


def smoke_plain(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Plain version of K8: 2x + y in f32, rounded once to bf16."""
    return (2 * x.float() + y.float()).to(torch.bfloat16)


def axpy2_cuda(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Kernel K8: 2x + y for contiguous bf16 CUDA tensors of one shape, any
    size, at any 2-byte offset (16-byte vectors where all three pointers
    allow them)."""
    for name, t in (("x", x), ("y", y)):
        if not t.is_cuda or t.dtype != torch.bfloat16 or not t.is_contiguous():
            raise ValueError(f"axpy2: {name} must be a contiguous bfloat16 CUDA tensor")
    if x.shape != y.shape:
        raise ValueError(f"axpy2: x {tuple(x.shape)} != y {tuple(y.shape)}")
    out = torch.empty_like(x)
    err = build.library("fused_offsets").axpy2_bf16(
        x.data_ptr(), y.data_ptr(), out.data_ptr(), x.numel(),
        torch.cuda.current_stream(x.device).cuda_stream)
    build.check(err, "axpy2_bf16")
    build.LAUNCHES["axpy2_bf16"] += 1
    return out


def axpy2(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """K8 for CUDA tensors, its plain version for CPU tensors."""
    return axpy2_cuda(x, y) if x.is_cuda else smoke_plain(x, y)


def smoke(device) -> float:
    """The Pallas smoke test's computation: 2·1 + 3 on [256, 256] bf16;
    returns out[0, 0] (5.0)."""
    x = torch.ones(256, 256, dtype=torch.bfloat16, device=device)
    y = torch.full((256, 256), 3.0, dtype=torch.bfloat16, device=device)
    return float(axpy2(x, y)[0, 0])


def offset_operands(tab: torch.Tensor, tables: ChunkedTables, S: int, C: int, dt):
    """K7's g [B, 8, S, 10C] (the 8 offsets' gathered window-table rows, one
    `rowgather` per sample) and case one-hot [B, 8, S, 4] in dt."""
    offs = torch.tensor(_OFFS8, device=tab.device)
    g = torch.stack([rowgather(tab[b], tables.nbr_idx[b][offs].reshape(-1)).reshape(8, S, 10 * C)
                     for b in range(tab.shape[0])])
    case = tables.nbr_case[:, offs].to(torch.int32)
    oh = (case[..., None] == torch.arange(4, dtype=torch.int32, device=tab.device)).to(dt)
    return g, oh


def fused_subm(feats, occ_bits, colkey, chunk, valid, weight, tables: ChunkedTables,
               C: int, co: int, dt=torch.bfloat16) -> torch.Tensor:
    """`_subm_impl` (no bias, forward) with the 8 offsets' select and products
    fused into K7; feats [B, S, 4·C] -> [B, S, 4·co] in dt."""
    B, S, _ = feats.shape
    tab = _window_table(feats, occ_bits, colkey, chunk, valid, dt)
    W6 = _band_weight(_w_zyx(weight), C, co, 6, 1, dt)
    g, oh = offset_operands(tab, tables, S, C, dt)
    acc = fused_offsets(g, oh, W6[list(_OFFS8)].contiguous()).to(dt)
    gc = tab[:, :S, 0:6 * C].reshape(B * S, 6 * C)
    acc = acc + (gc @ W6[4]).reshape(B, S, 4 * co)
    return zmask(occ_bits, co, acc)
