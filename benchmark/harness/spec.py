"""Where the harness finds each piece by name: `BENCHMARK.json` at the
checkout's root, `benchmark/configs/<config>.json`,
`benchmark/traffic/<traffic>.json`, `benchmark/drivers/<entry>.py` and
`benchmark/metrics/<metric>.py`. Nothing here names a cell, a configuration
or a metric: adding one is adding its files and its entries."""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def cell(spec: Dict, name: str) -> Dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config_entry(spec: Dict, name: str) -> Dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return c
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def config_file(spec: Dict, name: str, root: Path = ROOT) -> Dict:
    return load_json(root / config_entry(spec, name)["file"])


def traffic_file(name: str, bench: Path = BENCH) -> Dict:
    return load_json(bench / "traffic" / f"{name}.json")


def load_module(path: Path, name: str) -> ModuleType:
    """A module from its file, under a name of its own (metric names hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(entry: str, bench: Path = BENCH) -> ModuleType:
    return load_module(bench / "drivers" / f"{entry}.py", f"benchmark_driver_{entry}")


def metric_reader(name: str, bench: Path = BENCH) -> ModuleType:
    return load_module(bench / "metrics" / f"{name}.py", "benchmark_metric_" + name.replace(".", "_"))


def reported(metrics: List[Dict], cell_name: str, e2e_names: List[str]) -> List[Dict]:
    """The metrics of `metrics` that a cell reports: those that list it, or,
    without a `workloads` key, those whose end-to-end metric it reports."""
    out = []
    for m in metrics:
        if "workloads" in m:
            if cell_name in m["workloads"]:
                out.append(m)
        elif m.get("moves") is None or m["moves"] in e2e_names:
            out.append(m)
    return out


def cell_metrics(spec: Dict, cell_name: str) -> Dict[str, List[Dict]]:
    """{"end_to_end": [...], "per_layer": [...]} of one cell."""
    e2e = reported(spec["end_to_end"], cell_name, [])
    per_layer = reported(spec["per_layer"], cell_name, [m["name"] for m in e2e])
    return {"end_to_end": e2e, "per_layer": per_layer}


def _deep_tuple(v: Any) -> Any:
    return tuple(_deep_tuple(x) for x in v) if isinstance(v, list) else v


def build_dataclass(cls: type, values: Dict) -> Any:
    """An instance of the frozen dataclass `cls` from a JSON dict: nested
    dataclasses by the type of the default instance's field, lists as
    tuples. Every field must be given."""
    default = cls()
    kw = {}
    for f in dataclasses.fields(cls):
        if f.name not in values:
            raise KeyError(f"{cls.__name__}.{f.name} missing from the configuration file")
        cur, v = getattr(default, f.name), values[f.name]
        kw[f.name] = build_dataclass(type(cur), v) if dataclasses.is_dataclass(cur) else _deep_tuple(v)
    extra = set(values) - set(kw)
    if extra:
        raise KeyError(f"{cls.__name__}: unknown fields {sorted(extra)}")
    return cls(**kw)
