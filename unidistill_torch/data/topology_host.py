"""Host-side topology planner for the chunked sparse-conv layout, in numpy.

Counterpart of the JAX package's `data/topology_host.py`
(`plan_frame_topology_numpy` and its helpers), without the native C++
dispatch and without the backward's reverse tables (`_rev_tables`, which
only the chunked layout's backward reads; the port does not run that
backward). Layout and packing are the JAX ones (`ops/sparse_conv_chunked.py`
here): a *slot* is an occupied (BEV column, z-chunk of 4) cell, slots sorted
by (column key y·W + x, chunk); per stage the planner gives the slot
skeleton and integer gather tables, from the voxel coordinates alone.

Packing: subm tables pack (slot_idx, case) as ``idx·4 + case``; a miss is
``idx = S`` (the all-zero row of the window table).
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

CHUNK = 4
_PC = np.array([bin(i).count("1") for i in range(1 << 16)], np.int32)


def _popcount(x: np.ndarray) -> np.ndarray:
    return _PC[x & 0xFFFF] + _PC[(x >> 16) & 0xFFFF]


def _nch(D: int) -> int:
    return -(-D // CHUNK)


def stage_shapes(grid_size) -> Tuple[Tuple[int, int, int], ...]:
    """(s0, s2, s3) spatial shapes (D, H, W) of the LiDAR encoder's stages."""
    nx, ny, nz = grid_size
    s0 = (nz + 1, ny, nx)
    s2 = tuple((d + 2 - 3) // 2 + 1 for d in s0)
    s3 = tuple((d + 2 - 3) // 2 + 1 for d in s2)
    return s0, s2, s3


class _ColMap:
    """Per-frame column map: colkey -> (first-slot index, chunk bitmap)."""

    def __init__(self, colkey: np.ndarray, chunk: np.ndarray, valid: np.ndarray):
        ck = colkey[valid]
        ch = chunk[valid]
        first = np.ones(len(ck), bool)
        first[1:] = ck[1:] != ck[:-1]
        self.keys = ck[first]  # sorted unique columns
        self.base = np.nonzero(first)[0].astype(np.int32)
        bits = np.zeros(len(self.keys), np.int32)
        col_of = np.cumsum(first) - 1
        np.bitwise_or.at(bits, col_of, (1 << ch).astype(np.int32))
        self.bits = bits

    def lookup(self, q: np.ndarray):
        """q: flat column keys -> (has, base, bits); has=False for missing."""
        if len(self.keys) == 0:
            z = np.zeros(q.shape, np.int32)
            return np.zeros(q.shape, bool), z, z
        pos = np.searchsorted(self.keys, q)
        pos_c = np.minimum(pos, len(self.keys) - 1)
        has = (pos < len(self.keys)) & (self.keys[pos_c] == q)
        base = np.where(has, self.base[pos_c], 0).astype(np.int32)
        bits = np.where(has, self.bits[pos_c], 0).astype(np.int32)
        return has, base, bits


def _resolve(has, base, bits, s, nch: int, S: int):
    """3-way chunk resolve: chunk s -> case 0, else s-1 -> case 1, else
    s+1 -> case 2; miss -> idx=S, case=2."""
    def at(q):
        inr = (q >= 0) & (q < nch)
        qc = np.clip(q, 0, nch - 1)
        hit = has & inr & (((bits >> qc) & 1) == 1)
        idx = base + _popcount(bits & ((1 << qc) - 1))
        return hit, idx

    h0, i0 = at(s)
    h1, i1 = at(s - 1)
    h2, i2 = at(s + 1)
    case = np.where(h0, 0, np.where(h1, 1, 2)).astype(np.int32)
    idx = np.where(h0, i0, np.where(h1, i1, np.where(h2, i2, S)))
    return idx.astype(np.int32), case


def _resolve_exact(has, base, bits, s, nch: int, S: int):
    inr = (s >= 0) & (s < nch)
    sc = np.clip(s, 0, nch - 1)
    hit = has & inr & (((bits >> sc) & 1) == 1)
    idx = base + _popcount(bits & ((1 << sc) - 1))
    return np.where(hit, idx, S).astype(np.int32)


def _subm_tables(cm: _ColMap, colkey, chunk, valid, shape, S: int):
    """[9, S] packed idx·4+case for the 3³ subm conv's 9 xy offsets."""
    D, H, W = shape
    nch = _nch(D)
    yc, xc = colkey // W, colkey % W
    out = np.empty((9, S), np.int32)
    o = 0
    for dy in (-1, 0, 1):
        for dx in (-1, 0, 1):
            ny, nx_ = yc + dy, xc + dx
            inb = valid & (ny >= 0) & (ny < H) & (nx_ >= 0) & (nx_ < W)
            q = np.where(inb, ny * W + nx_, 0)
            has, base, bits = cm.lookup(q)
            has = has & inb
            idx, case = _resolve(has, base, bits, chunk, nch, S)
            idx = np.where(valid, idx, S)
            out[o] = idx * 4 + case
            o += 1
    return out


def _down_sites(cm_in: _ColMap, shape_in, shape_out, S_in: int, S_out: int):
    """Down-stage (k3/s2/p1) output skeleton + forward gather tables: out
    columns are the deduplicated strided 3×3 footprint candidates of occupied
    input columns; out chunk bitmaps via in chunk s -> out z in [2s, 2s+2];
    column-rank then slot-rank caps."""
    D, H, W = shape_in
    D2, H2, W2 = shape_out
    nch_in, nch_out = _nch(D), _nch(D2)

    ik = cm_in.keys
    ibits = cm_in.bits
    # out chunk bitmap contributed by each input column
    obits = np.zeros(len(ik), np.int32)
    for s in range(nch_in):
        lo, hi = 2 * s, min(2 * s + 2, D2 - 1)
        m = 0
        for zo in range(lo, hi + 1):
            m |= 1 << (zo // CHUNK)
        if m:
            obits |= np.where(((ibits >> s) & 1) == 1, m, 0)

    yc, xc = ik // W, ik % W
    cand_keys = []
    cand_bits = []
    for ay in (0, 1):
        for ax in (0, 1):
            yo = (yc + 1) // 2 - ay
            xo = (xc + 1) // 2 - ax
            ok = (
                (2 * yo + 1 >= yc) & (yc >= 2 * yo - 1)
                & (2 * xo + 1 >= xc) & (xc >= 2 * xo - 1)
                & (yo >= 0) & (yo < H2) & (xo >= 0) & (xo < W2)
            )
            cand_keys.append(np.where(ok, yo * W2 + xo, H2 * W2)[ok])
            cand_bits.append(obits[ok])
    ck4 = np.concatenate(cand_keys)
    cb4 = np.concatenate(cand_bits)
    order = np.argsort(ck4, kind="stable")
    sk, sb = ck4[order], cb4[order]
    if len(sk):
        first = np.ones(len(sk), bool)
        first[1:] = sk[1:] != sk[:-1]
        ucol = sk[first]
        col_of = np.cumsum(first) - 1
        ubits = np.zeros(len(ucol), np.int32)
        np.bitwise_or.at(ubits, col_of, sb)
    else:
        ucol = np.zeros(0, np.int64)
        ubits = np.zeros(0, np.int32)
    # column-rank cap
    ucol, ubits = ucol[:S_out], ubits[:S_out]

    # expand bitmaps to slots in (colkey, chunk) order; slot-rank cap
    nsl = _popcount(ubits)
    csum = np.concatenate([[0], np.cumsum(nsl)])
    n_slots = min(int(csum[-1]), S_out)
    colkey = np.full(S_out, H2 * W2, np.int32)
    chunk = np.zeros(S_out, np.int32)
    if n_slots:
        slot_col = np.searchsorted(csum, np.arange(n_slots), side="right") - 1
        within = np.arange(n_slots) - csum[slot_col]
        # chunk of the `within`-th set bit of ubits[slot_col]
        bts = ubits[slot_col]
        cc = np.zeros(n_slots, np.int32)
        acc = np.zeros(n_slots, np.int32)
        rem = within.astype(np.int32)
        for b in range(nch_out):
            bit = (bts >> b) & 1
            take = (bit == 1) & (acc == rem)
            cc = np.where(take, b, cc)
            acc += bit
        colkey[:n_slots] = ucol[slot_col]
        chunk[:n_slots] = cc
    valid = colkey < H2 * W2

    # forward gather tables into the INPUT slot space
    yo, xo = colkey // W2, colkey % W2
    a_pack = np.empty((9, S_out), np.int32)
    b_idx = np.empty((9, S_out), np.int32)
    o = 0
    for ky in range(3):
        for kx in range(3):
            yi = 2 * yo - 1 + ky
            xi = 2 * xo - 1 + kx
            inb = valid & (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            q = np.where(inb, yi * W + xi, 0)
            has, base, bits = cm_in.lookup(q)
            has = has & inb
            ia, ca = _resolve(has, base, bits, 2 * chunk, nch_in, S_in)
            a_pack[o] = ia * 4 + ca
            b_idx[o] = _resolve_exact(has, base, bits, 2 * chunk + 1, nch_in, S_in)
            o += 1
    return colkey, chunk, valid, a_pack, b_idx


def _col_zmask_lookup(keys: np.ndarray, zmask: np.ndarray, q: np.ndarray,
                      ok: np.ndarray) -> np.ndarray:
    """Sorted unique column keys + per-column z-bitmasks -> masks at q."""
    if len(keys) == 0:
        return np.zeros(q.shape, np.uint64)
    pos = np.searchsorted(keys, q)
    pos_c = np.minimum(pos, len(keys) - 1)
    has = ok & (pos < len(keys)) & (keys[pos_c] == q)
    return np.where(has, zmask[pos_c], np.uint64(0))


def _down_occ_bits(keys_in, zmask_in, colkey_out, chunk_out, valid_out,
                   shape_in, shape_out) -> np.ndarray:
    """Out-site occupancy of the k3/s2/p1 down conv ([S_out] int32 4-bit z
    bitmaps): out z is active iff at least one input z in [2z-1, 2z+1]
    exists in the 3×3 strided xy footprint (spconv's site rule)."""
    D2, H2, W2 = shape_out
    _, H, W = shape_in
    msh = zmask_in << np.uint64(1)  # bit z+1: window [2z-1, 2z+1] = bits [2z, 2z+2]
    yo, xo = colkey_out // W2, colkey_out % W2
    acc = np.zeros(len(colkey_out), np.uint64)
    for ky in range(3):
        for kx in range(3):
            yi = 2 * yo - 1 + ky
            xi = 2 * xo - 1 + kx
            inb = valid_out & (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
            q = np.where(inb, yi.astype(np.int64) * W + xi, -1)
            acc |= _col_zmask_lookup(keys_in, msh, q, inb)
    occ = np.zeros(len(colkey_out), np.int32)
    for zi in range(CHUNK):
        zo = CHUNK * chunk_out + zi
        sh = np.minimum(2 * zo, 62).astype(np.uint64)  # keeps the shift defined
        hit = ((acc >> sh) & np.uint64(7)) != 0
        hit &= (zo < D2) & valid_out
        occ |= np.where(hit, np.int32(1 << zi), 0)
    return occ


def _zmask_of_occ(keys: np.ndarray, colkey, chunk, occ_bits, valid) -> np.ndarray:
    """Per-unique-column z-bitmask from slot occupancy bitmaps."""
    zm = np.zeros(len(keys), np.uint64)
    vi = np.nonzero(valid)[0]
    col_idx = np.searchsorted(keys, colkey[vi])
    for zi in range(CHUNK):
        has = ((occ_bits[vi] >> zi) & 1) == 1
        np.bitwise_or.at(
            zm, col_idx[has],
            np.uint64(1) << (CHUNK * chunk[vi][has] + zi).astype(np.uint64),
        )
    return zm


def plan_frame_topology(
    coords: np.ndarray,
    grid_size,
    stage_caps,
    s0_cap: int | None = None,
) -> Dict[str, np.ndarray]:
    """One frame's chunked-encoder topology (stages s0, s2, s3).

    coords: [V, 3] int32 (z, y, x), -1 padding, key-sorted (the voxeliser's
    order); stage_caps: `lidar_encoder.stage_voxel_caps` (S2, S3, ...);
    s0_cap: `lidar_encoder.s0_slot_cap`, which truncates the stride-1 slot
    skeleton before the tables are built, so cut voxels are simply absent
    (`s0_dropped` counts them).

    Returns, per stage s ∈ {0, 2, 3}: `ck{s}` column keys, `ch{s}` chunks,
    `nbr{s}` [9, S] packed subm tables; `src0` [S0, 4] voxel row of each
    slot z (V = none); `a{s}`, `b{s}` the down convs' forward tables and
    `occ{s}` their exact output occupancy bitmaps (s ∈ {2, 3})."""
    s0, s2, s3 = stage_shapes(grid_size)
    V = coords.shape[0]
    S0 = V if s0_cap is None else min(V, int(s0_cap))
    S2, S3 = int(stage_caps[0]), int(stage_caps[1])
    D, H, W = s0

    z, y, x = coords[:, 0], coords[:, 1], coords[:, 2]
    ok = z >= 0
    ck = np.where(ok, y.astype(np.int64) * W + x, H * W)
    ch = np.where(ok, z // CHUNK, 0).astype(np.int32)
    zp = np.where(ok, z % CHUNK, 0).astype(np.int32)

    # slot skeleton: first occurrence of (colkey, chunk) in the sorted stream
    start = ok.copy()
    start[1:] &= (ck[1:] != ck[:-1]) | (ch[1:] != ch[:-1])
    start[0] = bool(ok[0])
    slot = np.cumsum(start) - 1
    keep = ok & (slot < S0)  # voxels past the slot cap are simply absent
    slot = np.where(keep, slot, S0)

    colkey0 = np.full(S0, H * W, np.int32)
    chunk0 = np.zeros(S0, np.int32)
    n_start = int(start.sum())
    n0 = min(n_start, S0)
    colkey0[:n0] = ck[start][:n0]
    chunk0[:n0] = ch[start][:n0]
    valid0 = colkey0 < H * W

    # voxel -> slot-z feature source map ([S0, 4]; V = miss -> zero row)
    src0 = np.full((S0, CHUNK), V, np.int32)
    vi = np.nonzero(keep)[0]
    src0[slot[vi], zp[vi]] = vi.astype(np.int32)

    cm0 = _ColMap(colkey0, chunk0, valid0)
    nbr0 = _subm_tables(cm0, colkey0, chunk0, valid0, s0, S0)

    colkey2, chunk2, valid2, a2, b2 = _down_sites(cm0, s0, s2, S0, S2)
    cm2 = _ColMap(colkey2, chunk2, valid2)
    nbr2 = _subm_tables(cm2, colkey2, chunk2, valid2, s2, S2)

    colkey3, chunk3, valid3, a3, b3 = _down_sites(cm2, s2, s3, S2, S3)
    cm3 = _ColMap(colkey3, chunk3, valid3)
    nbr3 = _subm_tables(cm3, colkey3, chunk3, valid3, s3, S3)

    # exact down-conv output occupancy
    zmask0 = np.zeros(len(cm0.keys), np.uint64)
    if len(cm0.keys):
        ci = np.searchsorted(cm0.keys, ck[vi])
        np.bitwise_or.at(zmask0, ci, np.uint64(1) << z[vi].astype(np.uint64))
    occ2 = _down_occ_bits(cm0.keys, zmask0, colkey2, chunk2, valid2, s0, s2)
    zmask2 = _zmask_of_occ(cm2.keys, colkey2, chunk2, occ2, valid2)
    occ3 = _down_occ_bits(cm2.keys, zmask2, colkey3, chunk3, valid3, s2, s3)

    return {
        "ck0": colkey0, "ch0": chunk0, "src0": src0, "nbr0": nbr0,
        "ck2": colkey2.astype(np.int32), "ch2": chunk2, "a2": a2, "b2": b2,
        "nbr2": nbr2,
        "ck3": colkey3.astype(np.int32), "ch3": chunk3, "a3": a3, "b3": b3,
        "nbr3": nbr3,
        "occ2": occ2, "occ3": occ3,
        "s0_dropped": np.int32(max(0, n_start - S0)),
    }
