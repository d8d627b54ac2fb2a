"""Running the harness on the CPU at `configs.nuscenes.tiny_model` sizes:
the committed cells with their configuration files swapped for tiny ones
and their traffic cut to a few requests or steps. Past the device check,
which a CPU run cannot pass, this is the same code a run on the card takes
(kernels replaced by the port's plain versions, as on any CPU tensor)."""
from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import time
import types
from pathlib import Path
from typing import Dict, Optional

import torch

from benchmark import run as run_mod
from benchmark.harness import spec as sp

SMALL_TRAFFIC = dict(trace_first=1, trace_count=1, check_requests=2, pool_serve=2,
                     warmup_steps=0, warmup_rounds=1, batch=2)


def tiny_files(compute_dtype: str = "float32") -> Dict[str, Dict]:
    """The two configuration files at tiny sizes. float32 by default, where
    the port's CPU path and the reference agree to rounding, so that a run
    is correct and a broken one is not."""
    from unidistill_torch.configs.nuscenes import camera_exp, distill_exp, tiny_model

    d = dataclasses.asdict
    cam = dataclasses.replace(tiny_model(with_lidar=False), compute_dtype=compute_dtype)
    lid = dataclasses.replace(tiny_model(with_camera=False), compute_dtype=compute_dtype)
    dx = distill_exp("lidar", "camera")
    return {"camera": {"model": d(cam), "train": d(camera_exp().train)},
            "distill-lidar-camera": {"student": d(cam), "teacher": d(lid), "train": d(dx.train),
                                     "distill": d(dx.distill)}}


def small_traffic(name: str, limits: Optional[Dict] = None, load=sp.traffic_file) -> Dict:
    t = load(name)
    pool = t["pool"]
    t.update({k: v for k, v in SMALL_TRAFFIC.items() if k != "pool_serve"})
    if t["entry"] == "predict":
        t["pool"] = min(pool, SMALL_TRAFFIC["pool_serve"])
    if limits:
        t["limits"] = dict(t["limits"], **limits)
    return t


def run_cell(cell_name: str, tmp: Path, seconds: float = 0.5, seed: int = 2**31 + 7,
             compute_dtype: str = "float32", limits: Optional[Dict] = None):
    """(exit code, stdout, stderr) of one run of a committed cell, tiny, on the CPU."""
    torch.set_num_threads(2)
    bench = sp.benchmark_spec()
    files = tiny_files(compute_dtype)
    for c in bench["configs"]:
        path = tmp / f"{c['name']}.json"
        path.write_text(json.dumps(files[c["name"]]))
        c["file"] = str(path)
    cell = sp.cell(bench, cell_name)
    args = types.SimpleNamespace(workload=cell_name, seed=seed, seconds=seconds, trace=0)
    out, err = io.StringIO(), io.StringIO()
    real = sp.traffic_file
    sp.traffic_file = lambda name, bench=sp.BENCH: small_traffic(name, limits, real)
    try:
        with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
            rc = run_mod.run(args, bench, cell, torch.device("cpu"), time.time())
    finally:
        sp.traffic_file = real
    return rc, out.getvalue(), err.getvalue()


def last_line(stdout: str) -> Dict:
    return json.loads(stdout.strip().splitlines()[-1])
