"""The traced part of a `--trace 1` run: the window's first `first` requests
or steps run untraced, then two slices of `count` each:

1. spans: the benchmark's CUDA events (`StageTimer`), cheap;
2. profiled: `torch.profiler` with CPU and CUDA activity, the launch
   counters read around it. Its device times are the device's own, but its
   host runs slower by the profiler's recording of every host op (by a
   quarter a request, by half or more a step, on an H100).

So the untraced head gives the time an iteration takes, and the idle share
and the whole step's share of the peak divide the profiled slice's busy
time an iteration and the reference's FLOPs by it. (The profiler with CUDA
activity alone recorded kernels without durations, torch 2.11.) Each slice
starts and ends on a synchronised device, and the profiled slice's
annotation (`bench.slice`) holds all of its device work. The trace is
written after the window."""
from __future__ import annotations

import contextlib
import time
from pathlib import Path
from typing import Dict, List, Optional

import torch

from benchmark.harness import trace as tr
from benchmark.harness.spans import StageTimer

SLICES = ("spans", "profiled")


class Tracer:
    def __init__(self, run_dir: Path, first: int, count: int, spans: Optional[StageTimer] = None):
        self.run_dir, self.first, self.count = run_dir, first, count
        self.spans = spans
        self.phase: Optional[str] = None
        self.prof = None
        self._stopped = None  # the profiler once its slice has ended
        self.launches0: Dict[str, int] = {}
        self.launches: Dict[str, int] = {}
        self.indices: Dict[str, List[int]] = {k: [] for k in SLICES}
        self.slice_s: Dict[str, float] = {}
        self.events: Optional[list] = None
        self._t = 0.0
        self._slice = None
        self._t0 = None
        self.iteration_s = None  # the untraced head's time an iteration

    def _which(self, i: int) -> Optional[str]:
        k = (i - self.first) // self.count
        return SLICES[k] if i >= self.first and k < len(SLICES) else None

    @property
    def on(self) -> bool:
        return self.phase == "profiled"

    def before(self, i: int) -> None:
        if i == 0:
            self._t0 = time.perf_counter()  # the window starts on a synchronised device
        which = self._which(i)
        if which == self.phase:
            return
        self._end()
        if which is None:
            return
        torch.cuda.synchronize()
        if i == self.first and self.first and self._t0 is not None:
            self.iteration_s = (time.perf_counter() - self._t0) / self.first
        self.phase = which
        if which == "spans" and self.spans is not None:
            self.spans.active = True
        elif which == "profiled":
            from torch.profiler import ProfilerActivity, profile
            from unidistill_torch.kernels import build

            self.prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            self.prof.start()
            self.launches0 = dict(build.LAUNCHES)
            self._slice = torch.profiler.record_function("bench.slice")
            self._slice.__enter__()
        self._t = time.perf_counter()

    def annotate(self, name: str):
        return torch.profiler.record_function(name) if self.on else contextlib.nullcontext()

    def after(self, i: int) -> None:
        if self.phase is None:
            return
        self.indices[self.phase].append(i)
        if self._which(i + 1) != self.phase:
            self._end()

    def _end(self) -> None:
        if self.phase is None:
            return
        torch.cuda.synchronize()
        self.slice_s[self.phase] = time.perf_counter() - self._t
        if self.phase == "spans" and self.spans is not None:
            self.spans.active = False
        if self._slice is not None:
            self._slice.__exit__(None, None, None)
            self._slice = None
        if self.prof is not None:
            from unidistill_torch.kernels import build

            self.launches = {k: v - self.launches0.get(k, 0) for k, v in build.LAUNCHES.items()
                             if v - self.launches0.get(k, 0)}
            self.prof.stop()
            self._stopped, self.prof = self.prof, None
        self.phase = None

    def close(self) -> None:
        """End the window: the slices (also where it closed before their
        end), and the traces."""
        self._end()
        if self._stopped is not None:
            path = self.run_dir / "trace.json"
            self._stopped.export_chrome_trace(str(path))
            self.events, self._stopped = tr.load(path), None

    def record(self) -> Dict:
        """What the per-layer metrics read of the traced slices."""
        events = self.events
        if events is None:
            raise RuntimeError("the window ended before the profiled slice")
        ann = tr.annotations(events, "bench.slice")
        if not ann:
            raise RuntimeError("the profiled slice's trace holds no bench.slice annotation")
        return {
            "events": events, "window": ann[0], "iterations": len(self.indices["profiled"]),
            "busy_s": tr.busy_s(events, ann[:1]), "slice_s": self.slice_s["profiled"],
            "iteration_s": self.iteration_s, "span_iterations": len(self.indices["spans"]),
            "launches": self.launches,
        }
