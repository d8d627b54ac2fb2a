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
    nblk = S // R
    rng = np.random.default_rng(seed)
    idx = np.arange(S) + rng.integers(-1500, 1500, size=S)
    idx = np.clip(idx, 0, S - 1).astype(np.int32)
    w = np.zeros(nblk, np.int32)
    for j in range(nblk):
        blk = idx[j * R:(j + 1) * R]
        lo = max(0, int(blk.min()) - 16) & ~15
        lo = min(lo, S - band)
        w[j] = lo
        np.clip(blk, lo, lo + band - 1, out=blk)
    tab = torch.from_numpy(rng.standard_normal((S, W)) * 0.1).to(torch.bfloat16)
    return tab.to(device), torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


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
