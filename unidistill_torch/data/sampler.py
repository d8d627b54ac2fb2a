"""Infinite rank-sharded shuffled index stream; the port's copy of the JAX
package's `data/sampler.py` (ref data/sampler.py:9-72 — present but unused
by the reference exps; provided for API parity and for streaming-style
training loops). Rank r of `world_size` takes every `world_size`-th index
of the one stream, from the r-th on."""
from __future__ import annotations

import itertools
from typing import Iterator

import numpy as np


class InfiniteSampler:
    def __init__(self, size: int, shuffle: bool = True, seed: int = 0, rank: int = 0, world_size: int = 1):
        assert size > 0
        self._size = size
        self._shuffle = shuffle
        self._seed = seed
        self._rank = rank
        self._world_size = world_size

    def __iter__(self) -> Iterator[int]:
        yield from itertools.islice(self._infinite_indices(), self._rank, None, self._world_size)

    def _infinite_indices(self) -> Iterator[int]:
        rng = np.random.RandomState(self._seed)
        while True:
            if self._shuffle:
                yield from rng.permutation(self._size)
            else:
                yield from np.arange(self._size)
