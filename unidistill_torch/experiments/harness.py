"""Device choice and timing for the microbenchmarks.

The benchmarks run on the card unless the caller asks for the CPU; without
a card they raise. On the card a time is taken with CUDA events around
ITERS applications of the operation (the JAX harness timed a `lax.scan` of
ITERS applications, `experiments/mb_flat_subm.py::scan_op`), the median of
`reps` such runs divided by ITERS. On the CPU the host clock stands in, and
the time is the CPU's, not a device's.
"""
from __future__ import annotations

import time

import torch

ITERS = 4


def pick_device(name: str | None) -> torch.device:
    """The card ("cuda", the default) or the CPU when asked ("cpu")."""
    if name == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the CPU")
    return torch.device(name or "cuda")


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def timed_ms(fn, device: torch.device, iters: int = ITERS, reps: int = 5) -> float:
    """Milliseconds per application of fn(): median over `reps` runs of
    `iters` applications, after one warm-up application."""
    fn()
    ts = []
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        for _ in range(reps):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            torch.cuda.synchronize(device)
            ts.append(start.elapsed_time(end) / iters)
    else:
        for _ in range(reps):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            ts.append((time.perf_counter() - t0) * 1e3 / iters)
    ts.sort()
    return ts[len(ts) // 2]
