"""Device choice and timing for the microbenchmarks.

The benchmarks run on the card unless the caller asks for the CPU; without
a card they raise. On the card a time is taken with CUDA events around
ITERS applications of the operation (the JAX harness timed a `lax.scan` of
ITERS applications, `experiments/mb_flat_subm.py::scan_op`), the median of
`reps` such runs divided by ITERS. On the CPU the host clock stands in, and
the time is the CPU's, not a device's. For a kernel shorter than its
wrapper's host work, back-to-back events time the host: `kernel_ms` and
`device_ms` read the kernel's own time from torch.profiler instead.
`kernel_geometry` reads the grid, block and registers of the kernels a
call launches from a profiler trace. `poisoned_call` makes a comparison
fail a kernel that leaves outputs unwritten.
"""
from __future__ import annotations

import json
import os
import tempfile
import time
from pathlib import Path

import torch

# where a trace is written and read back: the checkout's gitignored build/
BUILD_DIR = Path(__file__).resolve().parents[2] / "build"

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


def _profiled(fn, name: str | None, iters: int) -> dict[str, tuple[float, int]]:
    """{kernel: (µs, records)}: the device time and the number of kernel
    records of each kernel whose name holds `name` (every kernel where name
    is None) in one torch.profiler profile of `iters` calls of fn; three
    tries while a profile records none."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):  # one profile in a dozen came back without the kernel's activity on the H100
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        timed = {e.key: (e.self_device_time_total, e.count) for e in prof.key_averages()
                 if (name is None or name in e.key) and getattr(e, "self_device_time_total", 0.0) > 0}
        if timed:
            return timed
    return {}


def _per_call(records: dict[str, tuple[float, int]], iters: int) -> tuple[float, int, int]:
    """(ms a call, records kept, records a complete profile holds): each
    kernel's mean over its records kept, times the launches of it a call
    makes, summed over the kernels. A process that has profiled many times
    loses some records (`device_ms` labels it), so a sum over `iters`
    would read low, and one mean over kernels of unlike length would lean
    to the kernel that kept more."""
    ms = kept = full = 0
    for us, n in records.values():
        per_call = max(1, round(n / iters))
        ms += us / n * per_call / 1e3
        kept += n
        full += per_call * iters
    return ms, kept, full


def kernel_ms(fn, name: str | None, iters: int = 50) -> float | None:
    """Device time a call of fn spends in kernels whose name holds `name`
    (every kernel it launches where name is None), from torch.profiler's
    CUDA activity, with no host gaps between launches. None if three
    profiles in a row recorded no device time."""
    records = _profiled(fn, name, iters)
    return _per_call(records, iters)[0] if records else None


def device_ms(fn, name: str | None, iters: int = 50) -> tuple[float, str, float]:
    """(ms, source, events_ms): fn's device time as `kernel_ms` takes it, or
    the mean of `iters` back-to-back calls by CUDA events where three
    profiles saw none, which `source` names: "profiler", "profiler:N/M"
    where the profile kept N of its M kernel records, or "events";
    events_ms beside."""
    events_ms = timed_ms(fn, torch.device("cuda"), iters=iters, reps=1)
    records = _profiled(fn, name, iters)
    if not records:
        return events_ms, "events", events_ms
    ms, kept, full = _per_call(records, iters)
    return ms, "profiler" if kept == full else f"profiler:{kept}/{full}", events_ms


def launch_geometry(trace_events, name: str | None) -> list[dict]:
    """The distinct kernel launches among a Chrome trace's events
    (torch.profiler's `export_chrome_trace`) whose name holds `name` (every
    kernel where name is None), in order of first appearance: name, grid,
    block, threads, registers per thread, static and dynamic shared memory
    bytes, and `launches`, how many records the trace holds of each."""
    found = {}
    for e in trace_events:
        if e.get("cat") != "kernel" or (name is not None and name not in e.get("name", "")):
            continue
        a = e.get("args", {})
        grid, block = list(a.get("grid", [0, 0, 0])), list(a.get("block", [0, 0, 0]))
        key = (e["name"], tuple(grid), tuple(block), a.get("registers per thread"), a.get("shared memory"))
        if key not in found:
            threads = 1
            for d in grid + block:
                threads *= d
            found[key] = dict(name=e["name"], grid=grid, block=block, threads=threads,
                              registers=key[3], shared_bytes=key[4], launches=0)
        found[key]["launches"] += 1
    return list(found.values())


def kernel_geometry(fn, name: str | None, iters: int = 20) -> list[dict]:
    """`launch_geometry` of `iters` calls of fn, from a torch.profiler trace
    written under the checkout's build/ and removed after reading; three
    tries while a trace records none (a process that has profiled many
    times loses kernel records, as `device_ms` notes)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        fd, path = tempfile.mkstemp(suffix=".json", dir=BUILD_DIR)
        os.close(fd)
        try:
            prof.export_chrome_trace(path)
            with open(path) as f:
                found = launch_geometry(json.load(f)["traceEvents"], name)
        finally:
            os.unlink(path)
        if found:
            return found
    return []


def poisoned_call(fn, nbytes: int) -> torch.Tensor:
    """fn(), whose output of `nbytes` is its one allocation that large, with
    that output in a block just filled with NaN: the free cached blocks are
    released, then `nbytes` of NaN allocated and freed, so the allocator's
    next block of that size is theirs. Rows a kernel leaves unwritten then
    hold NaN, not an earlier call's correct result. Raises if the output
    landed elsewhere."""
    torch.cuda.empty_cache()
    at = torch.full((nbytes // 2,), float("nan"), dtype=torch.bfloat16, device="cuda").data_ptr()
    out = fn()
    torch.cuda.synchronize()
    if out.data_ptr() != at:
        raise RuntimeError("poisoned_call: the output did not land in the NaN-filled block")
    return out
