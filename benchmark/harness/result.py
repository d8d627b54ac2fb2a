"""The run's last line and the checks around it."""
from __future__ import annotations

import json
import sys
from typing import Dict, List, Optional, Sequence

FORBIDDEN = ("jax", "jaxlib", "flax", "unidistill_tpu")


def forbidden_modules(names: Sequence[str] = FORBIDDEN) -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    `names`, compared whole."""
    return sorted({m for m in list(sys.modules) if m.split(".")[0] in names})


class Reading:
    """One number compared, with its limit: it passes while value <= limit."""

    def __init__(self, name: str, value: float, limit: float):
        self.name, self.value, self.limit = name, float(value), float(limit)

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit  # NaN fails

    def as_dict(self) -> Dict:
        return {"value": self.value, "limit": self.limit}


def readings(values: Dict[str, float], limits: Dict[str, float]) -> List[Reading]:
    """The numbers that have a limit, in the limits' order: a number without
    one is measured but not compared."""
    return [Reading(k, values[k], limit) for k, limit in limits.items()]


def line(correct: bool, attempted: int, failed: int, metrics: Dict[str, Dict], device: Dict,
         readings: List[Reading], breakdown: Optional[Dict] = None) -> str:
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checked"] = {r.name: r.as_dict() for r in readings}  # last: each number compared and its limit
    return json.dumps(out)


def report_readings(readings: List[Reading]) -> None:
    """Each number compared beside its limit, as the last lines on stderr."""
    for r in readings:
        print(f"check {r.name} = {r.value!r} limit {r.limit!r} {'ok' if r.ok else 'FAILED'}",
              file=sys.stderr, flush=True)
