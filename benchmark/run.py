#!/usr/bin/env python3
"""One run of one cell of the benchmark of `unidistill_torch`, the PyTorch
and CUDA port, on the CUDA devices of this machine.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

The cell (`BENCHMARK.json` `workloads`) names a configuration
(`benchmark/configs/<config>.json`) and a traffic mix
(`benchmark/traffic/<traffic>.json`), which names the entry driver
(`benchmark/drivers/<entry>.py`). Set-up builds the program's kernels,
makes the weights and inputs on the device from the seed and warms up every
shape the traffic uses; then the window runs for S seconds. With `--trace
0` the last line reports the cell's end-to-end metrics, with `--trace 1`
its per-layer metrics, each read by `benchmark/metrics/<metric>.py` from a
profiled slice of the window. After the window the plain reference
(`benchmark/reference/`) decides `correct`; each number compared is printed
beside its limit as the last lines on stderr and under `checked` in the last
line. Without enough CUDA devices the run exits 2 and prints no result.

Caches: the port builds its kernels under the checkout's `build/`; torch's
extension, Triton and CUDA's JIT caches are pointed at fixed directories
there too.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import resource
import sys
import time
from dataclasses import dataclass
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def process_start() -> float:
    """When this process started, in `time.time()` seconds (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


@dataclass
class Context:
    cell: dict
    traffic: dict
    config: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    run_dir: Path
    clock: object


def cache_dirs(root: Path) -> None:
    """Fixed cache directories inside the checkout."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "bench_cache" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(root / "build" / "bench_cache" / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(root / "build" / "bench_cache" / "nv")


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    started = process_start()
    args = parse(argv)
    cache_dirs(ROOT)
    from benchmark.harness import spec as sp

    bench = sp.benchmark_spec(ROOT)
    cell = sp.cell(bench, args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"run: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available", file=sys.stderr)
        return 2
    from unidistill_torch.kernels import build

    return run(args, bench, cell, torch.device("cuda", 0), started, build_kernels=build.build_all)


def run(args, bench, cell, device, started: float, build_kernels=None) -> int:
    """The run after the device check (the CPU tests call it with a CPU
    device and a small configuration)."""
    import torch

    from benchmark.harness import result as res
    from benchmark.harness import spec as sp
    from benchmark.harness import trace as tr
    from benchmark.harness.setup import Clock, sync
    from benchmark.harness.spans import StageTimer
    from benchmark.harness.tracer import Tracer

    clock = Clock()
    clock.parts["start"] = time.time() - started  # the interpreter, torch and the harness
    if build_kernels is not None:
        build_kernels()
        clock.lap("build")
    traffic = sp.traffic_file(cell["traffic"])
    if "threads" in traffic:  # the host's intra-op threads, fixed by the cell
        torch.set_num_threads(int(traffic["threads"]))
    run_dir = ROOT / "build" / "bench_runs" / cell["name"]
    run_dir.mkdir(parents=True, exist_ok=True)
    ctx = Context(cell=cell, traffic=traffic, config=sp.config_file(bench, cell["config"], ROOT), seed=args.seed,
                  seconds=args.seconds, trace=bool(args.trace), device=device, run_dir=run_dir, clock=clock)
    session = sp.driver(traffic["entry"]).setup(ctx)
    cuda = device.type == "cuda"
    tracer = timer = None
    if args.trace:
        timer = StageTimer()
        session.spans(timer)
        tracer = Tracer(run_dir, first=int(traffic["trace_first"]), count=int(traffic["trace_count"]), spans=timer)
    sync(device)
    gc.collect()
    gc.freeze()  # what set-up made is never collected: the window's collections skip it
    setup_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.time() - started
    print("setup " + " ".join(f"{k}={v:.3f}s" for k, v in clock.parts.items()) + f" total={setup_s:.3f}s",
          file=sys.stderr, flush=True)
    use0, t_win = resource.getrusage(resource.RUSAGE_SELF), time.perf_counter()
    window = session.window(args.seconds, tracer)
    use1, t_win = resource.getrusage(resource.RUSAGE_SELF), time.perf_counter() - t_win
    print(f"window {t_win:.3f}s: host cpu user {use1.ru_utime - use0.ru_utime:.3f}s "
          f"sys {use1.ru_stime - use0.ru_stime:.3f}s, context switches involuntary "
          f"{use1.ru_nivcsw - use0.ru_nivcsw} voluntary {use1.ru_nvcsw - use0.ru_nvcsw}", file=sys.stderr)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    spans_ms = timer.totals_ms() if timer is not None else {}
    if timer is not None:
        timer.remove()
    session.release()
    t_check = time.perf_counter()
    readings = session.check(counting=bool(args.trace))
    print(f"check took {time.perf_counter() - t_check:.3f}s", file=sys.stderr, flush=True)
    device_info = {"platform": "gpu" if cuda else device.type,
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                   "count": int(cell["chips"]), "memory_peak_bytes": int(max(setup_peak, window_peak))}
    cm = sp.cell_metrics(bench, cell["name"])
    breakdown = None
    if args.trace:
        record = dict(tracer.record(), spans_ms=spans_ms, work=session.work(), peak_bytes=window_peak,
                      frames_per_iteration=window["frames_per_iteration"])
        device_info.update(busy_s=record["busy_s"], window_s=record["slice_s"])
        per = lambda s, k: 1e3 * s / max(len(tracer.indices[k]), 1)
        print(f"ms an iteration: untraced {1e3 * (record['iteration_s'] or 0):.3f}, "
              + ", ".join(f"{k} slice {per(s, k):.3f}" for k, s in tracer.slice_s.items()), file=sys.stderr)
        metrics = {}
        for m in cm["per_layer"]:
            v = sp.metric_reader(m["name"]).read(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        breakdown = {"device_ops": tr.device_ops(record["events"], [record["window"]]),
                     "idle_gaps": tr.idle_gaps(record["events"], [record["window"]])}
        print("launches " + json.dumps(record["launches"]), file=sys.stderr)
    else:
        values = dict(window["end_to_end"], setup_s=setup_s)
        metrics = {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
                   for m in cm["end_to_end"]}
    bad = res.forbidden_modules()
    if bad:
        print(f"run: modules of the JAX package or JAX were loaded: {bad}", file=sys.stderr)
        return 3
    correct = all(r.ok for r in readings)
    out = res.line(correct, window["attempted"], window["failed"], metrics, device_info, readings, breakdown)
    sys.stdout.flush()
    print(out, flush=True)
    res.report_readings(readings)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
