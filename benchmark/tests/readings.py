"""The readings a cell's limits are set from, on the card at the cell's own
size: for each seed, the program's numbers (set-up, a short window, the
check), the fp8 control's, or the program's with a fault planted.

    python3 -m benchmark.tests.readings --workload NAME --seeds 1 2 3
        [--control] [--fault half|frozen|altered|lr] [--seconds 2]

Prints one JSON line a seed: {"seed", "fault", "program": {name: value},
"control": {name: value}}.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

import torch

from benchmark import run as run_mod
from benchmark.harness import spec as sp
from benchmark.harness.setup import Clock
from benchmark.tests import faults


def session_readings(cell_name: str, seed: int, seconds: float, device, control: bool, fault: str = "none",
                     bench=None, traffic=None) -> dict:
    bench = bench or sp.benchmark_spec()
    cell = sp.cell(bench, cell_name)
    traffic = traffic or sp.traffic_file(cell["traffic"])
    run_dir = sp.ROOT / "build" / "bench_runs" / cell_name
    run_dir.mkdir(parents=True, exist_ok=True)
    ctx = run_mod.Context(cell=cell, traffic=traffic, config=sp.config_file(bench, cell["config"]), seed=seed,
                          seconds=seconds, trace=False, device=device, run_dir=run_dir, clock=Clock())
    with faults.plant(fault):
        session = sp.driver(traffic["entry"]).setup(ctx)
        session.window(seconds)
    session.release()
    out = {"seed": seed, "fault": fault, "program": session.numbers_of_program()}
    if control:
        out["control"] = session.control()
    del session
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", default="none", choices=("none",) + faults.FAULTS)
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 2
    run_mod.cache_dirs(sp.ROOT)
    from unidistill_torch.kernels import build

    build.build_all()
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = session_readings(args.workload, seed, args.seconds, torch.device("cuda", 0), args.control, args.fault)
        out["seconds"] = time.perf_counter() - t0
        print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    with contextlib.suppress(BrokenPipeError):
        raise SystemExit(main())
