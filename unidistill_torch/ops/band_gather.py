"""Banded row gather: three hand-written designs, kernels K9-K11.

Counterparts of the Pallas gather kernels of the JAX experiment
`experiments/mb_gather_pallas.py`. One function,

  band_gather(tab [n_tab, W], idx [S] int32, w [ceil(S / R)] int32, R, band)
      -> out [S, W],  out[k] = tab[clip(idx[k], w[j], w[j] + band - 1)], j = k / R

with 0 <= w[j] <= n_tab - band: each R-row block gathers from its own band
of `band` table rows. Designs (`csrc/band_gather.cu`), each bit-exact:

  band_gather_fori(..., unroll=1 | 4)  K9   one warp per row (per 4 rows)
  band_gather_take                     K10  one thread per (row, 16 bytes)
                                            (K9, K10: rows of a multiple
                                            of 16 bytes)
  band_gather_onehot                   K11  onehot[R, band] @ band on the
                                            tensor cores, only the k16
                                            slabs where a row group's
                                            one-hot is not all zero (bf16
                                            tables; R % 128, band % 32,
                                            W % 8 == 0)

Each launches its kernel for CUDA tensors and runs `band_gather_plain`,
the same function in plain PyTorch, for CPU tensors.
`onehot_slabs_plain` models which products K11 runs, and
`onehot_skip_plain` runs just those products in plain PyTorch.
"""
from __future__ import annotations

import torch

from unidistill_torch.kernels import build

ONEHOT_ROWS = 128  # K11's launch contract: R a multiple of this
ONEHOT_BAND_STEP = 32  # and band a multiple of this


def band_source_rows(idx: torch.Tensor, w: torch.Tensor, R: int, band: int) -> torch.Tensor:
    """The table row each output row reads: clip(idx[k], w[k/R], w[k/R]+band-1)."""
    lo = w.repeat_interleave(R)[: idx.shape[0]]
    return torch.minimum(torch.maximum(idx, lo), lo + band - 1)


def band_gather_plain(tab: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, R: int,
                      band: int) -> torch.Tensor:
    """Plain version of K9-K11: index_select at the clipped rows."""
    return tab.index_select(0, band_source_rows(idx, w, R, band).long())


ONEHOT_SLAB = 16  # K11's k16 step: band rows a slab, rows an m16 group


def onehot_slabs_plain(idx: torch.Tensor, w: torch.Tensor, R: int, band: int):
    """K11's order and products. K11 orders each R-row block's rows by slab
    (band position // 16) and cuts the order into m16 groups of 16
    consecutive rows from the block's start; a group runs one product a
    distinct slab of its rows (per n8 tile of columns).

    Returns (order, groups, slabs): order [S] int64 the rows in that order,
    block j at positions [j R, j R + its rows), equal slabs by row number
    as in the kernel's stable sort; groups, slabs [P] int64 the (m16 group,
    slab) products, group g holding positions [16 g, 16 g + 16). The dense
    one-hot product runs ceil(S / 16) x band / 16 of them."""
    if R % ONEHOT_SLAB or band % ONEHOT_SLAB:
        raise ValueError(f"onehot_slabs_plain: R={R} and band={band} must be multiples of {ONEHOT_SLAB}")
    S = idx.shape[0]
    nslab = band // ONEHOT_SLAB
    block = torch.arange(S, device=idx.device) // R
    slab = (band_source_rows(idx, w, R, band) - w.repeat_interleave(R)[:S]).long() // ONEHOT_SLAB
    order = torch.sort(block * nslab + slab, stable=True).indices
    pairs = torch.unique(torch.arange(S, device=idx.device) // ONEHOT_SLAB * nslab + slab[order])
    return order, pairs // nslab, pairs % nslab


def onehot_skip_plain(tab: torch.Tensor, idx: torch.Tensor, w: torch.Tensor, R: int,
                      band: int) -> torch.Tensor:
    """K11's arithmetic in plain PyTorch: only the (group, slab) products of
    `onehot_slabs_plain`, each a [16, 16] one-hot by the slab's [16, W]
    band rows in f32, summed per row in f32 and rounded once to bf16."""
    order, groups, slabs = onehot_slabs_plain(idx, w, R, band)
    S, n = idx.shape[0], ONEHOT_SLAB
    lo = w.repeat_interleave(R)[:S].long()
    loc = band_source_rows(idx, w, R, band).long() - lo
    rows = torch.full((-(-S // n) * n,), -1, dtype=torch.long, device=idx.device)
    rows[:S] = order
    rows = rows.view(-1, n)[groups]  # [P, 16] the groups' rows, -1 past the end
    ok = rows >= 0
    start = n * slabs[:, None]
    onehot = (loc[rows.clamp_min(0)] - start)[..., None] == torch.arange(n, device=idx.device)
    onehot &= ok[..., None]
    slab_rows = lo[rows[:, 0]][:, None] + start + torch.arange(n, device=idx.device)
    prod = torch.bmm(onehot.float(), tab.float()[slab_rows])  # [P, 16, W]
    out = torch.zeros(S, tab.shape[1], dtype=torch.float32, device=tab.device)
    out.index_add_(0, rows[ok], prod[ok])
    return out.to(tab.dtype)


def _check(tab, idx, w, R, band, onehot=False):
    if tab.dim() != 2 or idx.dim() != 1 or w.dim() != 1:
        raise ValueError("band_gather: tab [n_tab, W], idx [S], w [blocks]")
    S = idx.shape[0]
    if R <= 0 or not 0 < band <= tab.shape[0]:
        raise ValueError(f"band_gather: R={R}, band={band} for {tab.shape[0]} table rows")
    if w.shape[0] < -(-S // R):
        raise ValueError(f"band_gather: w has {w.shape[0]} entries for {-(-S // R)} blocks")
    if tab.shape[0] >= 2**31 or S >= 2**31:
        raise ValueError("band_gather: too many rows for int32 indices")
    for name, t in (("tab", tab), ("idx", idx), ("w", w)):
        if not t.is_cuda or not t.is_contiguous():
            raise ValueError(f"band_gather: {name} must be a contiguous CUDA tensor")
    if idx.dtype != torch.int32 or w.dtype != torch.int32:
        raise ValueError("band_gather: idx and w must be int32")
    row_bytes = tab.shape[1] * tab.element_size()
    if row_bytes % 16 or tab.data_ptr() % 16:
        raise ValueError(f"band_gather: rows of {row_bytes} bytes at a 16-byte aligned table "
                         "(16-byte pieces)")
    if onehot:
        W = tab.shape[1]
        if tab.dtype != torch.bfloat16 or W % 8 or R % ONEHOT_ROWS or band % ONEHOT_BAND_STEP:
            raise ValueError(f"band_gather_onehot: bf16 table with W % 8 == 0 (W={W}), "
                             f"R % {ONEHOT_ROWS} == 0 (R={R}), band % {ONEHOT_BAND_STEP} == 0 "
                             f"(band={band})")
        if -(-S // ONEHOT_ROWS) > 65535:
            raise ValueError(f"band_gather_onehot: S={S} rows exceed the grid")
    return S


def _copy_cuda(tab, idx, w, R, band, variant, counter):
    S = _check(tab, idx, w, R, band)
    out = tab.new_empty(S, tab.shape[1])
    err = build.library("band_gather").band_gather_copy(
        tab.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), tab.shape[0], S,
        tab.shape[1] * tab.element_size(), R, band, variant,
        torch.cuda.current_stream(tab.device).cuda_stream)
    build.check(err, counter)
    build.LAUNCHES[counter] += 1
    return out


def band_gather_fori(tab, idx, w, R: int, band: int, unroll: int = 1) -> torch.Tensor:
    """K9 (unroll 1 or 4) for CUDA tensors, the plain version for CPU ones."""
    if unroll not in (1, 4):
        raise ValueError(f"band_gather_fori: unroll {unroll} (1 or 4)")
    if not tab.is_cuda:
        return band_gather_plain(tab, idx, w, R, band)
    return _copy_cuda(tab, idx, w, R, band, 0 if unroll == 1 else 1,
                      "band_gather_fori" if unroll == 1 else "band_gather_fori4")


def band_gather_take(tab, idx, w, R: int, band: int) -> torch.Tensor:
    """K10 for CUDA tensors, the plain version for CPU ones."""
    if not tab.is_cuda:
        return band_gather_plain(tab, idx, w, R, band)
    return _copy_cuda(tab, idx, w, R, band, 2, "band_gather_take")


def band_gather_onehot(tab, idx, w, R: int, band: int) -> torch.Tensor:
    """K11 for CUDA tensors, the plain version for CPU ones."""
    if not tab.is_cuda:
        return band_gather_plain(tab, idx, w, R, band)
    S = _check(tab, idx, w, R, band, onehot=True)
    out = tab.new_empty(S, tab.shape[1])
    err = build.library("band_gather").band_gather_onehot(
        tab.data_ptr(), idx.data_ptr(), w.data_ptr(), out.data_ptr(), tab.shape[0], S,
        tab.shape[1], R, band, torch.cuda.current_stream(tab.device).cuda_stream)
    build.check(err, "band_gather_onehot")
    build.LAUNCHES["band_gather_onehot"] += 1
    return out
