"""The reduction from a `torch.profiler` Chrome trace to the numbers the
per-layer metrics read: the device's busy time as the union of its
activity intervals, kernels attributed to the host op that launched them,
and the breakdown of device time and idle gaps. Times in the trace are
microseconds; everything returned is in seconds."""
from __future__ import annotations

import json
from collections import defaultdict
from typing import Dict, Iterable, List, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "user_annotation")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
Interval = Tuple[float, float]
NAME_CHARS = 120  # a kernel's name in the breakdown is cut to this length


def load(path) -> List[Dict]:
    with open(path) as f:
        data = json.load(f)
    return [e for e in data.get("traceEvents", []) if e.get("ph") == "X"]


def merge(intervals: Iterable[Interval]) -> List[Interval]:
    """The union of intervals as disjoint sorted intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def covered(intervals: Iterable[Interval], window: Interval) -> float:
    """Length of the union of `intervals` inside `window`."""
    lo, hi = window
    return sum(max(0.0, min(b, hi) - max(a, lo)) for a, b in merge(intervals))


def span(e: Dict) -> Interval:
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def device_events(events: Sequence[Dict]) -> List[Dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS]


def annotations(events: Sequence[Dict], name: str) -> List[Interval]:
    return sorted(span(e) for e in events if e.get("cat") == "user_annotation" and e.get("name") == name)


def busy_s(events: Sequence[Dict], windows: Sequence[Interval]) -> float:
    """Seconds in which some device activity ran, inside any of `windows`."""
    dev = [span(e) for e in device_events(events)]
    return sum(covered(dev, w) for w in merge(windows)) / 1e6


def kernels_in(events: Sequence[Dict], window: Interval) -> List[Dict]:
    lo, hi = window
    return [e for e in events if e.get("cat") == "kernel" and lo <= float(e["ts"]) < hi]


def kernels_under(events: Sequence[Dict], op_name: str) -> List[Dict]:
    """Kernels launched while a host op named `op_name` ran on the launching
    thread (the op's own launches and those of the ops inside it), matched
    by the runtime call's correlation id."""
    ops = defaultdict(list)
    for e in events:
        if e.get("cat") == "cpu_op" and e.get("name") == op_name:
            ops[e.get("tid")].append(span(e))
    corr = set()
    for e in events:
        if e.get("cat") in LAUNCH_CATS and e.get("tid") in ops:
            t = float(e["ts"])
            if any(a <= t <= b for a, b in ops[e["tid"]]):
                corr.add(e.get("args", {}).get("correlation"))
    corr.discard(None)
    return [e for e in events if e.get("cat") == "kernel" and e.get("args", {}).get("correlation") in corr]


def seconds(events: Iterable[Dict]) -> float:
    return sum(float(e.get("dur", 0.0)) for e in events) / 1e6


def device_ops(events: Sequence[Dict], windows: Sequence[Interval], top: int = 10) -> List[list]:
    """The device operations that took the most time inside `windows`:
    [[name, seconds]], the longest first."""
    windows = merge(windows)
    inside = lambda t: any(a <= t < b for a, b in windows)
    by_name: Dict[str, float] = defaultdict(float)
    for e in device_events(events):
        if inside(float(e["ts"])):
            by_name[e.get("name", "?")] += float(e.get("dur", 0.0)) / 1e6
    return [[n[:NAME_CHARS], s] for n, s in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def idle_gaps(events: Sequence[Dict], windows: Sequence[Interval], top: int = 10) -> List[list]:
    """The longest idle gaps of the device inside `windows`, each named by
    the innermost host op or benchmark annotation running when it began:
    [[name, seconds]], the longest first."""
    busy = merge(span(e) for e in device_events(events))
    gaps = []
    for lo, hi in merge(windows):
        t = lo
        for a, b in busy:
            if b <= lo or a >= hi:
                continue
            if a > t:
                gaps.append((a - t, t))
            t = max(t, b)
        if hi > t:
            gaps.append((hi - t, t))
    gaps.sort(reverse=True)
    host = [(span(e), e.get("name", "?")) for e in events if e.get("cat") in HOST_CATS]
    idle = []
    for length, start in gaps[:top]:
        holding = [(b - a, name) for (a, b), name in host if a <= start < b]
        label = min(holding)[1] if holding else "no host op"  # the shortest: the innermost
        idle.append([label, length / 1e6])
    return idle
