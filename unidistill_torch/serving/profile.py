"""Where the time of one full-width camera `Detector.predict` goes, on the card.

    python -m unidistill_torch.serving.profile [--batch 4] [--requests 5] [--out DIR]

Serves `camera_exp().model` (bf16, seeded random weights with BatchNorm
statistics calibrated on the batch, nuScenes-like camera matrices) and
reports:
  * per-stage device time by CUDA events around each stage (forward hooks
    on the modules, wrappers around the functions), mean over the requests;
  * request latency (host clock around work ending in a synchronise);
  * from `torch.profiler` over the same number of requests: the summed
    device time of all kernels, the device's busy share of the wall time,
    and the kernels that take the most device time.
Writes `stages.json`, `kernels.txt` and a Chrome trace under --out, and
prints one JSON summary line. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict
from pathlib import Path

import torch

STAGE_MODULES = {
    "image backbone": "camera_encoder.img_backbone",
    "neck": "camera_encoder.img_neck",
    "depth net": "camera_encoder.depth_net",
    "bev backbone": "bev_encoder",
    "head": "det_head",
}


class StageTimer:
    """CUDA events around module forwards and module-level functions."""

    def __init__(self):
        self.events = defaultdict(list)  # stage -> [(start, end)]
        self.undo = []

    def _start(self, stage):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events[stage].append([e, None])

    def _end(self, stage):
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        self.events[stage][-1][1] = e

    def module(self, stage, mod):
        h1 = mod.register_forward_pre_hook(lambda *a: self._start(stage))
        h2 = mod.register_forward_hook(lambda *a: self._end(stage))
        self.undo += [h1.remove, h2.remove]

    def function(self, stage, owner, name):
        fn = getattr(owner, name)

        def wrapped(*args, **kwargs):
            self._start(stage)
            out = fn(*args, **kwargs)
            self._end(stage)
            return out
        setattr(owner, name, wrapped)
        self.undo.append(lambda: setattr(owner, name, fn))

    def remove(self):
        for u in reversed(self.undo):
            u()

    def mean_ms(self, n_requests):
        torch.cuda.synchronize()
        return {k: sum(s.elapsed_time(e) for s, e in v) / n_requests for k, v in self.events.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")

    from unidistill_torch.configs.nuscenes import camera_exp
    from unidistill_torch.decode import proposals
    from unidistill_torch.layers import lss
    from unidistill_torch.serving.predictor import Detector
    from unidistill_torch.serving.synthetic import calibrate_batchnorm, nuscenes_batch, random_state_dict
    from unidistill_torch.training import steps

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    cfg = camera_exp().model
    det = Detector(cfg, random_state_dict(cfg, seed=0), device="cuda")
    batch = nuscenes_batch(cfg, args.batch, seed=1)
    batch = {"imgs": torch.from_numpy(batch["imgs"]).cuda(),
             "mats": {k: torch.from_numpy(v).cuda() for k, v in batch["mats"].items()}}
    calibrate_batchnorm(det.model, steps.model_inputs(batch, cfg, "cuda"))
    for _ in range(2):
        det.predict(batch)
    torch.cuda.synchronize()

    timer = StageTimer()
    mods = dict(det.model.named_modules())
    for stage, name in STAGE_MODULES.items():
        timer.module(stage, mods[name])
    timer.function("geometry", lss, "get_geometry")
    timer.function("bev pool", lss, "bev_pool_outer")
    timer.function("decode + nms", steps, "generate_proposals")
    timer.function("nms", proposals, "nms_bev_batched")
    timer.function("request", det, "predict")
    lat = []
    for _ in range(args.requests):
        t0 = time.perf_counter()
        det.predict(batch)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    stages = timer.mean_ms(args.requests)
    timer.remove()

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            det.predict(batch)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    prof.export_chrome_trace(str(out_dir / "trace.json"))
    kernels = [e for e in prof.key_averages() if e.device_type == torch.autograd.DeviceType.CUDA]
    kernels.sort(key=lambda e: e.self_device_time_total, reverse=True)
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    with open(out_dir / "kernels.txt", "w") as f:
        f.write(f"{smi}\n{args.requests} requests, batch {args.batch}, wall {wall_ms:.3f} ms\n")
        for e in kernels:
            f.write(f"{e.self_device_time_total / 1e3 / args.requests:10.4f} ms/request "
                    f"{e.count // args.requests:5d} launches/request  {e.key[:140]}\n")
    summary = dict(
        device=smi, batch=args.batch, requests=args.requests,
        latency_ms=[round(x * 1e3, 3) for x in lat],
        frames_per_s=args.batch * len(lat) / sum(lat),
        stage_ms={k: round(v, 4) for k, v in sorted(stages.items(), key=lambda kv: -kv[1])},
        profiled_wall_ms_per_request=wall_ms / args.requests,
        kernel_ms_per_request=device_ms / args.requests,
        device_busy_share=device_ms / wall_ms if device_ms else None,
        top_kernels=[(e.key[:80], round(e.self_device_time_total / 1e3 / args.requests, 4))
                     for e in kernels[:12]],
    )
    (out_dir / "stages.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
