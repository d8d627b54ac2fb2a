"""Fixed-shape batch collation and the data loader; the port's counterpart
of the JAX package's `data/collate.py`.

Frames are already fixed-shape (`data/dataset.py` pads to the config caps),
so collation is a plain stack (`collate`, the JAX function as it is).

`DataLoader(...)` is a `torch.utils.data.DataLoader` whose batch sampler
gives the JAX loader's batches: the indices in order, or shuffled by one
`RandomState(seed)` that draws a new permutation every epoch, cut into
batches, the last dropped when short under `drop_last`. With
`num_workers=0` the frames and their order equal the JAX loader's.

With workers, each worker process reseeds the dataset's generator from
`torch.initial_seed()` (the loader's base seed plus the worker's id) once,
when it starts; the workers persist across epochs, and their generators
run on from one epoch to the next. The JAX
loader pickles the dataset, generator included, into every task of its pool
and never advances the parent's generator, so with workers every frame of
every batch draws the same augmentation (IDA, BDA, the empty-GT resample);
the port does not copy that. Workers start by `spawn`: the loader runs in a
process that may hold a CUDA context and PyTorch's thread pools, which a
forked child must not inherit. A worker touches no CUDA and runs one
intra-op thread (its frame's voxeliser runs on the CPU).
"""
from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np
import torch


def collate(frames: List[Dict]) -> Dict:
    out: Dict = {}
    keys = frames[0].keys()
    for k in keys:
        if k in ("meta", "gt_boxes_raw"):
            out[k] = [f[k] for f in frames]
        elif k == "mats":
            out[k] = {
                mk: np.stack([f[k][mk] for f in frames])
                for mk in frames[0][k]
            }
        else:
            out[k] = np.stack([f[k] for f in frames])
    return out


class BatchOrder(torch.utils.data.Sampler):
    """The JAX loader's batches of dataset indices."""

    def __init__(self, n: int, batch_size: int, shuffle: bool, drop_last: bool, seed: int):
        self.n, self.batch_size = n, batch_size
        self.shuffle, self.drop_last = shuffle, drop_last
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        if self.drop_last:
            return self.n // self.batch_size
        return (self.n + self.batch_size - 1) // self.batch_size

    def __iter__(self) -> Iterator[List[int]]:
        order = np.arange(self.n)
        if self.shuffle:
            self.rng.shuffle(order)
        for i in range(0, self.n, self.batch_size):
            b = order[i : i + self.batch_size]
            if self.drop_last and len(b) < self.batch_size:
                continue
            yield [int(j) for j in b]


def _init_worker(worker_id: int) -> None:
    torch.set_num_threads(1)
    info = torch.utils.data.get_worker_info()
    info.dataset.rng = np.random.RandomState(info.seed % 2**32)


def DataLoader(dataset, batch_size: int, shuffle: bool = False, drop_last: bool = False,
               num_workers: int = 0, seed: int = 0) -> torch.utils.data.DataLoader:
    """Batches of collated frames (numpy arrays, `meta` and `gt_boxes_raw`
    as lists), prefetched by `num_workers` processes when it is above 0."""
    workers = dict(worker_init_fn=_init_worker, multiprocessing_context="spawn",
                   persistent_workers=True) if num_workers > 0 else {}
    return torch.utils.data.DataLoader(
        dataset, batch_sampler=BatchOrder(len(dataset), batch_size, shuffle, drop_last, seed),
        collate_fn=collate, num_workers=num_workers, **workers)
