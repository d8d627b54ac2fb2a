"""Infinite shuffled index stream; the port's copy of the JAX package's
`data/sampler.py` (ref data/sampler.py:9-72 — present but unused by the
reference exps; provided for API parity and for streaming-style training
loops). One process: the JAX sampler's rank sharding waits for the port's
multi-process training."""
from __future__ import annotations

from typing import Iterator

import numpy as np


class InfiniteSampler:
    def __init__(self, size: int, shuffle: bool = True, seed: int = 0):
        assert size > 0
        self._size = size
        self._shuffle = shuffle
        self._seed = seed

    def __iter__(self) -> Iterator[int]:
        rng = np.random.RandomState(self._seed)
        while True:
            if self._shuffle:
                yield from rng.permutation(self._size)
            else:
                yield from np.arange(self._size)
