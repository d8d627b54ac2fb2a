"""What the drivers share: the configuration file as the port's and as the
reference's dataclasses, seeded weights, and the pool of batches."""
from __future__ import annotations

import time
from types import SimpleNamespace
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness.spec import build_dataclass
from benchmark.inputs import synthetic

# the seed's streams: each draw of a run comes from a generator of its own
STREAM_WEIGHTS, STREAM_TEACHER, STREAM_POOL, STREAM_ORDER = 1, 2, 3, 4

MODEL_KEYS = ("model", "student", "teacher")


def configs(cfg_file: Dict, module) -> SimpleNamespace:
    """The file's model configurations (`model`, or `student` and
    `teacher`), `train` and `distill` as dataclasses of `module` (the port's
    `configs.nuscenes` or the reference's `config`)."""
    out = {}
    for k in MODEL_KEYS:
        if k in cfg_file:
            out[k] = build_dataclass(module.ModelConfig, cfg_file[k])
    out["train"] = build_dataclass(module.TrainConfig, cfg_file["train"])
    if "distill" in cfg_file:
        out["distill"] = build_dataclass(module.DistillConfig, cfg_file["distill"])
    return SimpleNamespace(**out)


def weights(ref_cfg, seed: int, stream: int, device) -> Dict[str, torch.Tensor]:
    """Seeded weights of the detector `ref_cfg` describes (a reference
    configuration), on `device`."""
    from benchmark.reference.model import BEVFusionCenterHead

    with torch.device("meta"):
        shell = BEVFusionCenterHead(ref_cfg)
    return synthetic.random_state_dict(shell, synthetic.generator(seed, stream, device), device)


def order(seed: int, pool: int, n: int) -> List[int]:
    """The pool index of each of n iterations: the pool in a seeded order,
    again and again, every batch equally often."""
    g = torch.Generator().manual_seed((int(seed) * 7919 + STREAM_ORDER) % (2**63 - 1))
    out: List[int] = []
    while len(out) < n:
        out += torch.randperm(pool, generator=g).tolist()
    return out[:n]


class Reservoir:
    """A sample of k of a stream of unknown length, drawn from the seed, each
    item equally likely (Algorithm R): `slot(i)` says, before item i is made,
    which of the k slots it takes, or None."""

    def __init__(self, seed: int, k: int):
        self.k = k
        self.rng = np.random.default_rng([int(seed) % 2**64, 12])

    def slot(self, i: int):
        if i < self.k:
            return i
        j = int(self.rng.integers(0, i + 1))
        return j if j < self.k else None


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


class Clock:
    """Seconds of each set-up part, printed to stderr by the harness."""

    def __init__(self):
        self.parts: Dict[str, float] = {}
        self._t = time.perf_counter()

    def lap(self, name: str, device=None) -> None:
        if device is not None:
            sync(device)
        t = time.perf_counter()
        self.parts[name] = self.parts.get(name, 0.0) + t - self._t
        self._t = t
