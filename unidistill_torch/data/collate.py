"""Fixed-shape batch collation and the data loader; the port's counterpart
of the JAX package's `data/collate.py`.

Frames are already fixed-shape (`data/dataset.py` pads to the config caps),
so collation is a plain stack (`collate`, the JAX function as it is).

`DataLoader(...)` is a `torch.utils.data.DataLoader` whose batch sampler
gives the JAX loader's batches: the indices in order, or shuffled by one
`RandomState(seed)` that draws a new permutation every epoch, cut into
batches, the last dropped when short under `drop_last`. With
`num_workers=0` the frames and their order equal the JAX loader's.

Over `world_size` ranks the JAX loader's batches are global ones of
`batch_size × world_size` frames, and rank r takes rows [r·b, (r+1)·b) of
each: the rows that `P("dp")` hands device r. Every rank has as many
batches, one a global batch (so `len`, the epoch's steps, is the number of
global batches, as in JAX); without `drop_last` a short last global batch
keeps every frame once, so a rank's share of it may be short or empty (an
empty batch collates to `{}`). Each rank's dataset keeps its own generator:
the augmentations of rank r > 0 are drawn from (seed, rank), in the loader
process or in each worker, so that no two ranks draw the same numbers.

Spatial sharding (`train.spatial_bev` > 1) gives the loader the dp shard
as its `rank` and the number of shards as its `world_size`: the bev peers
of a shard load the same rows and draw the same augmentations.

With workers, each worker process reseeds the dataset's generator from
`torch.initial_seed()` (the loader's base seed, drawn from a generator
seeded with `seed`, plus the worker's id) once,
when it starts; the workers persist across epochs, and their generators
run on from one epoch to the next. The JAX
loader pickles the dataset, generator included, into every task of its pool
and never advances the parent's generator, so with workers every frame of
every batch draws the same augmentation (IDA, BDA, the empty-GT resample);
the port does not copy that. Workers start by `spawn`: the loader runs in a
process that may hold a CUDA context and PyTorch's thread pools, which a
forked child must not inherit. A worker touches no CUDA and runs one
intra-op thread; its frames' host work runs in the C++ library
(`data/native.py`), which this process builds before the workers start,
so that they only load it.
"""
from __future__ import annotations

import functools
from typing import Dict, Iterator, List

import numpy as np
import torch

from unidistill_torch.data import native


def collate(frames: List[Dict]) -> Dict:
    out: Dict = {}
    if not frames:
        return out
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
    """Rank `rank`'s rows of the JAX loader's global batches of dataset
    indices (`batch_size` a rank, `batch_size × world_size` a global
    batch)."""

    def __init__(self, n: int, batch_size: int, shuffle: bool, drop_last: bool, seed: int,
                 rank: int = 0, world_size: int = 1):
        self.n, self.batch_size = n, batch_size
        self.shuffle, self.drop_last = shuffle, drop_last
        self.rank, self.world_size = rank, world_size
        self.rng = np.random.RandomState(seed)

    def __len__(self) -> int:
        g = self.batch_size * self.world_size
        if self.drop_last:
            return self.n // g
        return (self.n + g - 1) // g

    def __iter__(self) -> Iterator[List[int]]:
        order = np.arange(self.n)
        if self.shuffle:
            self.rng.shuffle(order)
        g = self.batch_size * self.world_size
        for i in range(0, self.n, g):
            b = order[i : i + g]
            if self.drop_last and len(b) < g:
                continue
            yield [int(j) for j in b[self.rank * self.batch_size : (self.rank + 1) * self.batch_size]]


def _rank_rng(seed: int, rank: int) -> np.random.RandomState:
    return np.random.RandomState(seed % 2**32 if rank == 0 else [seed % 2**32, rank])


def _init_worker(worker_id: int, rank: int = 0) -> None:
    torch.set_num_threads(1)
    info = torch.utils.data.get_worker_info()
    info.dataset.rng = _rank_rng(info.seed, rank)


def DataLoader(dataset, batch_size: int, shuffle: bool = False, drop_last: bool = False,
               num_workers: int = 0, seed: int = 0, rank: int = 0,
               world_size: int = 1) -> torch.utils.data.DataLoader:
    """Batches of collated frames (numpy arrays, `meta` and `gt_boxes_raw`
    as lists), prefetched by `num_workers` processes when it is above 0;
    rank `rank`'s `batch_size` rows of each global batch over `world_size`
    ranks."""
    if rank and num_workers == 0:
        dataset.rng = _rank_rng(seed, rank)
    if num_workers > 0:  # the workers load the host library this process builds
        native.available()
    workers = dict(worker_init_fn=functools.partial(_init_worker, rank=rank), multiprocessing_context="spawn",
                   persistent_workers=True) if num_workers > 0 else {}
    return torch.utils.data.DataLoader(
        dataset, batch_sampler=BatchOrder(len(dataset), batch_size, shuffle, drop_last, seed, rank, world_size),
        collate_fn=collate, num_workers=num_workers, generator=torch.Generator().manual_seed(seed), **workers)
