"""Faults planted in the port's timed path, for the checks that `correct`
catches them: each patches the program while it is active.

  half     every call sees half of its batch, the rows of the first half
           in place of the second (a loss or an output over half the batch)
  frozen   the optimizer's step leaves the parameters as they were
  altered  one served ROI's score changed where the decode produces it
  lr       the optimizer steps at 1.5 times the configured learning rate
"""
from __future__ import annotations

import contextlib
from typing import Dict, Iterator

import torch

FAULTS = ("half", "frozen", "altered", "lr")


def _half(batch: Dict) -> Dict:
    def cut(v):
        if isinstance(v, dict):
            return {k: cut(x) for k, x in v.items()}
        if isinstance(v, torch.Tensor) and v.dim() and v.shape[0] > 1:
            h = v.shape[0] // 2
            return torch.cat([v[:h], v[:h], v[: v.shape[0] - 2 * h]])
        return v
    return cut(batch)


@contextlib.contextmanager
def plant(name: str) -> Iterator[None]:
    from unidistill_torch.serving.predictor import Detector
    from unidistill_torch.training import steps
    from unidistill_torch.training.train_state import Optimizer

    undo = []

    def patch(owner, attr, make):
        orig = getattr(owner, attr)
        setattr(owner, attr, make(orig))
        undo.append(lambda: setattr(owner, attr, orig))

    if name == "half":
        patch(steps, "train_step", lambda f: lambda state, batch, *a, **k: f(state, _half(batch), *a, **k))
        patch(steps, "distill_train_step", lambda f: lambda state, batch, *a, **k: f(state, _half(batch), *a, **k))
        patch(Detector, "predict", lambda f: lambda self, batch: f(self, _half(batch)))
    elif name == "frozen":
        def frozen(f):
            def step(self, i):
                with torch.no_grad():
                    kept = [p.detach().clone() for p in self.params]
                    norm = f(self, i)
                    for p, v in zip(self.params, kept):
                        p.copy_(v)
                return norm
            return step
        patch(Optimizer, "step", frozen)
    elif name == "altered":
        def altered(f):
            def gen(*a, **k):
                out = dict(f(*a, **k))
                scores = out["scores"].clone()
                scores[..., 0] += 0.5
                out["scores"] = scores
                return out
            return gen
        patch(steps, "generate_proposals", altered)
    elif name == "lr":
        patch(Optimizer, "lr", lambda f: lambda self, step: 1.5 * f(self, step))
    elif name != "none":
        raise ValueError(f"unknown fault {name!r}; expected one of {FAULTS}")
    try:
        yield
    finally:
        for u in reversed(undo):
            u()
