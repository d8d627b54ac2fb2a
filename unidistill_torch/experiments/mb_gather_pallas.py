"""Microbenchmark: banded row-gather designs on the card (K9-K11).

Counterpart of the JAX experiment `experiments/mb_gather_pallas.py`, which
asked whether a kernel holding a band of the key-sorted slot table near the
cores can gather R arbitrary band-local rows per block at a few ns a row.

Variants (each checked bit-equal to the first):
  torch  : tab.index_select(0, idx), PyTorch's own gather (the JAX "xla")
  fori   : K9, one warp per row
  fori4  : K9, one warp per 4 rows, loads before stores
  take   : K10, one thread per (row, 16-byte piece)
  onehot : K11, the (R, band) one-hot product on the tensor cores

Shapes: s2-like. Table [S, W] = [65536, 640] bf16, R = 2048 rows a block,
band 4096, 32 blocks; `make_inputs` draws the JAX script's indices and
table from the same numpy seed, bit for bit.

    python -m unidistill_torch.experiments.mb_gather_pallas [--device cpu]

Prints `<variant> <ms> ms <ns> ns/row` per variant (CUDA events over ITERS
applications on the card; the host clock on the CPU).
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from unidistill_torch.experiments.harness import device_name, pick_device, timed_ms
from unidistill_torch.ops import band_gather as bg

S = 65536
W = 640
R = 2048
BAND = 4096


def make_inputs(seed: int = 0, S: int = S, W: int = W, R: int = R, band: int = BAND,
                device="cpu"):
    """(tab [S, W] bf16, idx [S] int32, w [S / R] int32): banded, roughly
    monotone neighbour indices idx[i] ~ i + noise, each block's indices
    clipped into its band; the JAX script's draws in its order."""
    rng = np.random.default_rng(seed)
    idx, w = _draw_indices(rng, S, R, band)
    tab = torch.from_numpy(rng.standard_normal((S, W)) * 0.1).to(torch.bfloat16)
    return tab.to(device), torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


def make_indices(seed: int = 0, S: int = S, R: int = R, band: int = BAND):
    """make_inputs' (idx, w) without drawing the table."""
    idx, w = _draw_indices(np.random.default_rng(seed), S, R, band)
    return torch.from_numpy(idx), torch.from_numpy(w)


def _draw_indices(rng, S, R, band):
    nblk = S // R
    idx = np.arange(S) + rng.integers(-1500, 1500, size=S)
    idx = np.clip(idx, 0, S - 1).astype(np.int32)
    w = np.zeros(nblk, np.int32)
    for j in range(nblk):
        blk = idx[j * R:(j + 1) * R]
        lo = max(0, int(blk.min()) - 16) & ~15
        lo = min(lo, S - band)
        w[j] = lo
        np.clip(blk, lo, lo + band - 1, out=blk)
    return idx, w


LAYOUTS = ("published", "one_position", "edges", "uniform", "ragged")


def band_layout(kind: str, S: int = S, W: int = W, R: int = R, band: int = BAND, seed: int = 0,
                device="cpu"):
    """(tab, idx, w) of one layout of the band positions, for K11's ordering:
      published     `make_inputs` (S % R == 0);
      one_position  every row of a block at one band position;
      edges         every row clipped to its band's first or last position;
      uniform       positions uniform over the band (band >> R spreads a
                    group over up to 16 slabs);
      ragged        `make_inputs`' draws at ceil(S / R) R rows and W
                    rounded up to 16, cut to S rows and W columns.
    The other layouts draw w uniformly, a table of max(S, band) rows."""
    if kind == "published":
        return make_inputs(seed, S, W, R, band, device)
    if kind == "ragged":
        tab, idx, w = make_inputs(seed, -(-S // R) * R, -(-W // 16) * 16, R, band)
        return tab[:, :W].contiguous().to(device), idx[:S].to(device), w.to(device)
    rng = np.random.default_rng(seed)
    n_tab, nblk = max(S, band), -(-S // R)
    w = rng.integers(0, n_tab - band + 1, nblk).astype(np.int32)
    lo = np.repeat(w, R)[:S]
    if kind == "one_position":
        idx = lo + np.repeat(rng.integers(0, band, nblk), R)[:S]
    elif kind == "edges":
        idx = np.where(rng.random(S) < 0.5, -1, n_tab)
    elif kind == "uniform":
        idx = lo + rng.integers(0, band, S)
    else:
        raise ValueError(f"band_layout: no layout {kind!r} (one of {LAYOUTS})")
    tab = torch.from_numpy(rng.standard_normal((n_tab, W)) * 0.1).to(torch.bfloat16)
    return tab.to(device), torch.from_numpy(idx.astype(np.int32)).to(device), torch.from_numpy(w).to(device)


def variants(R: int, band: int):
    """name -> fn(tab, idx, w) in the JAX script's order."""
    return {
        "torch": lambda t, i, w: t.index_select(0, i.long()),
        "fori": lambda t, i, w: bg.band_gather_fori(t, i, w, R, band, unroll=1),
        "fori4": lambda t, i, w: bg.band_gather_fori(t, i, w, R, band, unroll=4),
        "take": lambda t, i, w: bg.band_gather_take(t, i, w, R, band),
        "onehot": lambda t, i, w: bg.band_gather_onehot(t, i, w, R, band),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    dev = pick_device(args.device)
    tab, idx, w = make_inputs(0, device=dev)
    print(f"device {device_name(dev)}: table [{S}, {W}] bf16, R={R}, band={BAND}", flush=True)
    ref = None
    for name, fn in variants(R, BAND).items():
        out = fn(tab, idx, w)
        if ref is None:
            ref = out
        elif not torch.equal(out, ref):
            bad = int((out != ref).any(1).sum())
            print(f"  {name}: MISMATCH rows={bad}", flush=True)
        t = timed_ms(lambda: fn(tab, idx, w), dev)
        print(f"{name:7s} {t:8.3f} ms  {t / S * 1e6:6.2f} ns/row", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
