"""Spans from outside the program: CUDA events around module forwards and
around module-level functions, as the port's `serving/profile.py`
`StageTimer` records them (copied here, so that the yardstick stays fixed).
A span is only recorded while `active` is set, so hooks can stay in place
through a whole run and cost one Python call each outside the traced slice."""
from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List

import torch


class StageTimer:
    def __init__(self):
        self.events = defaultdict(list)  # stage -> [[start, end]]
        self.undo: List[Callable[[], None]] = []
        self.active = False
        self._open = defaultdict(int)  # stage -> nesting depth (a span inside itself counts once)

    def _start(self, stage: str) -> None:
        if not self.active:
            return
        self._open[stage] += 1
        if self._open[stage] > 1:
            return
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events[stage].append([e, None])

    def _end(self, stage: str) -> None:
        if not self.active or self._open[stage] == 0:
            return
        self._open[stage] -= 1
        if self._open[stage]:
            return
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events[stage][-1][1] = e

    def module(self, stage: str, mod: torch.nn.Module) -> None:
        """Time each forward of `mod`."""
        h1 = mod.register_forward_pre_hook(lambda *a: self._start(stage))
        h2 = mod.register_forward_hook(lambda *a: self._end(stage))
        self.undo += [h1.remove, h2.remove]

    def function(self, stage: str, owner, name: str) -> None:
        """Time each call of `owner.name` (a module-level function, a method
        of an object, or a class attribute)."""
        fn = getattr(owner, name)

        def wrapped(*args, **kwargs):
            self._start(stage)
            try:
                return fn(*args, **kwargs)
            finally:
                self._end(stage)
        setattr(owner, name, wrapped)
        self.undo.append(lambda: setattr(owner, name, fn))

    def remove(self) -> None:
        for u in reversed(self.undo):
            u()
        self.undo = []

    def totals_ms(self) -> Dict[str, float]:
        """Each stage's summed milliseconds over the spans recorded."""
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v if e is not None) for k, v in self.events.items()}
