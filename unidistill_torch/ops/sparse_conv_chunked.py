"""Z-chunked column-dense submanifold conv: the forward of the JAX package's
chunked layout, on torch tensors.

Counterpart of the forward subset of the JAX package's
`ops/sparse_conv_chunked.py`, with its layouts: a *slot* is an occupied
(BEV column, z-chunk of CHUNK=4 z levels) cell, slots sorted by (column key
y·W + x, chunk). Features are ``[B, S, 4·C]`` with the z position folded
into the channel minor (lane zp·C + c) and an int32 occupancy bitmap
``occ_bits [B, S]``. A 3³ submanifold conv gathers, per slot and xy offset,
one row of the window table ``[S+1, 10·C]`` (z ∈ [4s-1, 4s+8]); a per-row
case picks the 6-z window the slot's 4 outputs read (case 0: lanes 0:6C,
case 1: the row of chunk s-1, lanes 4C:10C; case 2: the row of chunk s+1,
[zeros 4C | lanes 0:2C]), and the 3 z taps fold into a banded weight
[9, 6C, 4co], so each offset is one product.

The port's own LiDAR encoder does not use this layout (it runs per-voxel
neighbour maps, `ops/sparse_conv.py`); this module carries the chunked
sparse-conv microbenchmarks (`unidistill_torch.experiments`), which measure
the gather and select+GEMM choices at the JAX layout's sizes. The tables
come from the host planner (`data/topology_host.py`). Gathers are
`index_select` and products `torch.einsum`, as they are XLA (not Pallas) in
the JAX package.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

CHUNK = 4  # z levels per chunk
_OFFS8 = (0, 1, 2, 3, 5, 6, 7, 8)  # the non-center xy offsets


class ChunkedTables(NamedTuple):
    """Per-stage neighbour tables from the host planner, shared by every conv
    on the slot set (the JAX tuple's device column map is not needed)."""

    nbr_idx: torch.Tensor   # [B, 9, S] int slot idx per xy offset; S = miss
    nbr_case: torch.Tensor  # [B, 9, S] int 0: row s, 1: row s-1, 2: row s+1


def rowgather(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """[R, L] table rows at idx [N] -> [N, L]. Every chunked-table index is in
    [0, R) by construction (a miss is the all-zero last row)."""
    return table.index_select(0, idx.long())


def zmask(occ_bits: torch.Tensor, C: int, x: torch.Tensor) -> torch.Tensor:
    """Zero the lanes of absent z sites: x [..., 4·C] by occ_bits [...]."""
    zi = torch.arange(x.shape[-1], device=x.device) // C
    keep = ((occ_bits[..., None].to(torch.int32) >> zi) & 1) == 1
    return torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))


def bits_of_occ(occ: torch.Tensor) -> torch.Tensor:
    """[..., 4] bool/int per-z occupancy -> int32 bitmap."""
    w = 1 << torch.arange(CHUNK, dtype=torch.int32, device=occ.device)
    return (occ.to(torch.int32) * w).sum(-1, dtype=torch.int32)


def _shift(x: torch.Tensor, k: int) -> torch.Tensor:
    """x [B, S, ...] shifted along S so out[o] = x[o+k], zeros rolled in."""
    pad = torch.zeros_like(x[:, :abs(k)])
    return torch.cat([x[:, k:], pad], 1) if k > 0 else torch.cat([pad, x[:, :k]], 1)


def _window_table(feats, occ_bits, colkey, chunk, valid, dt) -> torch.Tensor:
    """-> [B, S+1, 10·C] double-height halo rows, built by shifts and lane
    slices: [z3 of (c,s-1) : C | own 4C | 4C of (c,s+1) | z0 of (c,s+2) : C],
    z = 4s-1+q at lanes q·C..q·C+C. Row S is zero. (The JAX function's
    `with_occ` lanes and its rowz=13 rows serve the down conv only.)

    `valid` is not read: invalid slots are all-zero lanes (occ_bits 0) with
    the H·W sentinel column key, so no valid slot's neighbour test matches
    them; their own rows may take halo lanes, but no table gathers them."""
    B, S, FC = feats.shape
    C = FC // CHUNK
    src = zmask(occ_bits, C, feats.to(dt))  # padding / absent z are zero

    def delta_mask(k):
        if k > 0:
            return (_shift(colkey, k) == colkey) & (_shift(chunk, k) == chunk + k)
        return (_shift(colkey, -1) == colkey) & (_shift(chunk, -1) == chunk - 1)

    m_prev = delta_mask(-1)[..., None]
    m_next1 = delta_mask(1)[..., None]
    m_next2 = delta_mask(2)[..., None]
    # z0 of (c, s+2): at slot o+1 when (c, s+1) is absent, else at o+2
    m1_is_s2 = ((_shift(colkey, 1) == colkey) & (_shift(chunk, 1) == chunk + 2))[..., None]

    zero = torch.zeros((), dtype=dt, device=feats.device)
    n1 = _shift(src, 1)
    n2 = _shift(src, 2)
    halo_lo = torch.where(m_prev, _shift(src, -1)[:, :, 3 * C:4 * C], zero)
    blk_next = torch.where(m_next1, n1, zero)
    z_s2 = torch.where(m1_is_s2, n1[:, :, 0:C], torch.where(m_next2, n2[:, :, 0:C], zero))
    rows = torch.cat([halo_lo, src, blk_next, z_s2], 2)
    return torch.cat([rows, rows.new_zeros(B, 1, rows.shape[2])], 1)


def _case_view(tab: torch.Tensor, B: int, C: int) -> torch.Tensor:
    """Window table [B, S+1, 10·C] -> case-resolved 6-z views
    [B, (S+1)·3, 6·C]: one gather at 3·row + case fetches the final window.
    View 0 lanes 0:6C; view 1 lanes 4C:10C; view 2 [zeros 4C, lanes 0:2C]."""
    Sp1 = tab.shape[1]
    v0 = tab[:, :, 0:6 * C]
    v1 = tab[:, :, 4 * C:10 * C]
    v2 = torch.cat([torch.zeros_like(tab[:, :, 0:4 * C]), tab[:, :, 0:2 * C]], 2)
    return torch.stack([v0, v1, v2], 2).reshape(B, Sp1 * 3, 6 * C)


def _extract_subm_window(g: torch.Tensor, case: torch.Tensor, C: int) -> torch.Tensor:
    """Gathered rows [N, 10·C] + per-row case -> window [N, 6·C]: case 0
    lanes 0:6C; case 1 lanes 4C:10C; case 2 [zeros 4C, lanes 0:2C]."""
    w0 = g[:, 0:6 * C]
    w1 = g[:, 4 * C:10 * C]
    w2 = torch.cat([torch.zeros_like(g[:, 0:4 * C]), g[:, 0:2 * C]], 1)
    c = case[:, None]
    return torch.where(c == 0, w0, torch.where(c == 1, w1, w2))


def _fetch_windows(tab, tabv, mode, tables, oo, b, S, C) -> torch.Tensor:
    """One sample's windows [8, S, 6C] under the chosen subm mode."""
    if mode == "case_view":
        i3 = (tables.nbr_idx[b][oo] * 3 + tables.nbr_case[b][oo]).reshape(-1)
        return rowgather(tabv[b], i3).reshape(8, S, 6 * C)
    g = rowgather(tab[b], tables.nbr_idx[b][oo].reshape(-1))
    return _extract_subm_window(g, tables.nbr_case[b][oo].reshape(-1), C).reshape(8, S, 6 * C)


def _band_weight(w3: torch.Tensor, C: int, co: int, window: int, zstride: int, dt) -> torch.Tensor:
    """Fold the 3 z taps into a banded [9, window·C, 4·co] weight:

      W[o][(q, c), (zi, k)] = w3[q - zstride·zi, oy, ox, c, k]
                              when 0 <= q - zstride·zi <= 2, else 0."""
    wz = w3.reshape(3, 9, C, co)  # [dz, o, c, k]
    W = wz.new_zeros(window, 9, C, 4, co)
    for zi in range(4):
        W[zstride * zi:zstride * zi + 3, :, :, zi] = wz
    return W.permute(1, 0, 2, 3, 4).reshape(9, window * C, 4 * co).to(dt)


def _w_zyx(weight: torch.Tensor) -> torch.Tensor:
    """[27, Cin, Cout] (z-major taps) -> [3z, 3y, 3x, Cin, Cout]."""
    return weight.reshape(3, 3, 3, *weight.shape[1:])


def subm_mode(S: int, C: int) -> str:
    """The JAX package's measured auto rule for the window fetch: "case_view"
    (gather 6C rows of the 3-view table) while that table stays under ~78 MB,
    "select" (gather 10C rows, then the 3-way case select) above."""
    return "case_view" if (S + 1) * 18 * C * 2 < 78 * 2**20 else "select"


def _subm_impl(feats, occ_bits, colkey, chunk, valid, weight, bias,
               tables: ChunkedTables, dtype_str: str, reverse: bool = False,
               mode: Optional[str] = None) -> torch.Tensor:
    """feats [B, S, 4·Cin] flat -> occupancy-masked [B, S, 4·Cout].

    Per sample one [8·S] row gather from the window table, the case select,
    and one batched [8, S, 6C] x [8, 6C, 4co] product; the center offset
    reads the table's own lanes 0:6C (case 0 by construction) with no
    gather. `mode` is "select" or "case_view", default the `subm_mode`
    rule. reverse=True runs the offset-reversed conv: xy offsets o <-> 8-o
    through the same tables, z taps dz <-> 2-dz."""
    B, S, FC = feats.shape
    C = FC // CHUNK
    co = weight.shape[-1]
    dt = getattr(torch, dtype_str)
    w3 = _w_zyx(weight).to(dt)
    if reverse:
        w3 = w3.flip(0)  # with the banded weight: win[q]·w[2-(q-zi)]
    tab = _window_table(feats, occ_bits, colkey, chunk, valid, dt)
    W6 = _band_weight(w3, C, co, 6, 1, dt)  # [9, 6C, 4co]

    offs = torch.tensor(_OFFS8, device=feats.device)
    oo = (8 - offs) if reverse else offs  # gather-side offsets
    mode = mode or subm_mode(S, C)
    if mode not in ("select", "case_view"):
        raise ValueError(f"unknown subm mode {mode!r}")
    tabv = _case_view(tab, B, C) if mode == "case_view" else None
    accs = []
    for b in range(B):
        win = _fetch_windows(tab, tabv, mode, tables, oo, b, S, C)
        accs.append(torch.einsum("osw,owk->osk", win, W6[offs]).sum(0))
    acc = torch.stack(accs).reshape(B, S, 4 * co)

    gc = tab[:, :S, 0:6 * C].reshape(B * S, 6 * C)
    acc = acc + (gc @ W6[4]).reshape(B, S, 4 * co)
    if bias is not None:
        acc = acc + bias.to(dt).repeat(CHUNK)
    return zmask(occ_bits, co, acc)
