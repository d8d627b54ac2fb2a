"""Where the time of one full-width `Detector.predict`, or of one train
step, goes on the card.

    python -m unidistill_torch.serving.profile
        [--modality camera|lidar|distill|lidar-train|fusion]
        [--batch 4] [--requests 5] [--out DIR]

Serves `camera_exp().model` (nuScenes-like camera matrices) or
`lidar_exp().model` (nuScenes-like 10-sweep point clouds), in bf16 with
seeded random weights and BatchNorm statistics calibrated on the batch; or
runs one train step per request on `train_batch`:
  distill      the camera student from the frozen LiDAR teacher
               (`distill_train_step`; teacher forward, student forward,
               assigner, detection loss, distill losses, backward with K5
               inside, optimizer);
  lidar-train  the LiDAR detector's `train_step` (voxelise, rulebooks and
               their transposes, forward, assigner, detection loss, backward
               with K4 as the input gradient and K6 inside, optimizer);
  fusion       the fusion detector's `train_step` (both encoders; K4 dgrad,
               K6 and K5 inside the backward).
It reports:
  * per-stage device time by CUDA events around each stage (forward hooks
    on the modules, wrappers around the functions), mean over the requests;
    for the LiDAR detector: voxelise, rulebooks, each encoder stage (its
    strided conv and residual blocks), height compression, BEV backbone,
    head, decode + NMS; and its sites per stage;
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

STAGE_MODULES = {"bev backbone": "bev_encoder", "head": "det_head"}
CAMERA_MODULES = {
    "image backbone": "camera_encoder.img_backbone",
    "neck": "camera_encoder.img_neck",
    "depth net": "camera_encoder.depth_net",
}
ENC = "lidar_encoder.backbone_3d"
# encoder stage -> (first module, last module) of its span
LIDAR_SPANS = {
    "encoder s0 (conv_input, res1)": (f"{ENC}.conv_input", f"{ENC}.res1b"),
    "encoder s2 (down2, res2)": (f"{ENC}.down2", f"{ENC}.res2b"),
    "encoder s3 (down3, res3)": (f"{ENC}.down3", f"{ENC}.res3b"),
    "encoder s4 (down4, res4)": (f"{ENC}.down4", f"{ENC}.res4b"),
    "encoder s5 (conv_out)": (f"{ENC}.conv_out", f"{ENC}.bn_out"),
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

    def module(self, stage, mod, last=None):
        """Time from the start of `mod` to the end of `last` (default: mod)."""
        h1 = mod.register_forward_pre_hook(lambda *a: self._start(stage))
        h2 = (last or mod).register_forward_hook(lambda *a: self._end(stage))
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


def camera_setup(batch_size):
    from unidistill_torch.configs.nuscenes import camera_exp
    from unidistill_torch.serving.synthetic import nuscenes_batch
    cfg = camera_exp().model
    batch = nuscenes_batch(cfg, batch_size, seed=1)
    batch = {"imgs": torch.from_numpy(batch["imgs"]).cuda(),
             "mats": {k: torch.from_numpy(v).cuda() for k, v in batch["mats"].items()}}
    return cfg, batch


def lidar_setup(batch_size):
    from unidistill_torch.configs.nuscenes import lidar_exp
    from unidistill_torch.serving.synthetic import lidar_batch
    cfg = lidar_exp().model
    batch = lidar_batch(cfg, batch_size, seed=11)
    return cfg, {k: torch.from_numpy(v).cuda() for k, v in batch.items()}


def distill_setup(batch_size):
    """The distill step at full width, as `chip_smoke.py` [distill train]
    runs it: (cfg, step function, a function to time inside the step)."""
    from unidistill_torch.configs.nuscenes import DISTILL_VARIANTS, camera_exp, distill_exp, lidar_exp
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.serving.synthetic import calibrate_batchnorm, random_state_dict, train_batch
    from unidistill_torch.training import steps
    from unidistill_torch.training.train_state import TrainState, make_optimizer
    s_cfg, t_cfg = camera_exp().model, lidar_exp().model
    batch = train_batch(s_cfg, t_cfg, batch_size, seed=21)
    batch = {k: ({m: torch.from_numpy(a).cuda() for m, a in v.items()} if isinstance(v, dict)
                 else torch.from_numpy(v).cuda()) for k, v in batch.items()}
    teacher = BEVFusionCenterHead(t_cfg)
    teacher.load_state_dict(random_state_dict(t_cfg, seed=10))
    teacher.cuda().requires_grad_(False)
    calibrate_batchnorm(teacher, steps.model_inputs(batch, t_cfg, "cuda", training=False))
    student = BEVFusionCenterHead(s_cfg)
    student.load_state_dict(random_state_dict(s_cfg, seed=0))
    student.cuda()
    opt = make_optimizer(student, distill_exp("lidar", "camera").train)
    state = TrainState()

    def step():
        return steps.metrics_to_host(steps.distill_train_step(
            state, batch, student, teacher, opt, s_cfg, t_cfg, DISTILL_VARIANTS[("lidar", "camera")]))
    return s_cfg, step, teacher, student, opt


def train_setup(kind, batch_size):
    """A detector's train step at full width (`lidar-train`: `lidar_exp()`,
    `fusion`: `fusion_exp()`), as `chip_smoke.py` runs it: (cfg, step
    function, model, optimizer)."""
    from unidistill_torch.configs.nuscenes import fusion_exp, lidar_exp
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.serving.synthetic import random_state_dict, train_batch
    from unidistill_torch.training import steps
    from unidistill_torch.training.train_state import TrainState, make_optimizer
    exp = lidar_exp() if kind == "lidar-train" else fusion_exp()
    cfg = exp.model
    batch = train_batch(cfg, cfg, batch_size, seed=21)
    batch = {k: ({m: torch.from_numpy(a).cuda() for m, a in v.items()} if isinstance(v, dict)
                 else torch.from_numpy(v).cuda()) for k, v in batch.items()}
    model = BEVFusionCenterHead(cfg)
    model.load_state_dict(random_state_dict(cfg, seed=30))
    model.cuda()
    opt = make_optimizer(model, exp.train)
    state = TrainState()

    def step():
        return steps.metrics_to_host(steps.train_step(state, batch, model, opt, cfg))
    return cfg, step, model, opt


def time_train(timer, kind, models, opt):
    """Stages of a train step: the forwards (`models`: name -> module), the
    LiDAR maps, assigner, losses, backward with the kernels inside it,
    optimizer, the whole step."""
    from unidistill_torch.layers import lidar_encoder
    from unidistill_torch.ops import bev_pool, sparse_conv
    from unidistill_torch.training import steps
    for name, mod in models.items():
        timer.module(name, mod)
    if kind != "distill":
        timer.function("voxelise", steps, "voxelize_batch")
        timer.function("rulebooks (with transposes)", lidar_encoder, "build_rulebooks")
        timer.function("transposed maps", lidar_encoder, "transpose_rules")
    timer.function("assigner", steps, "assign_targets")
    timer.function("detection loss", steps, "center_head_loss")
    if kind == "distill":
        for name in ("feature_distill_loss", "bev_distill_loss", "response_distill_loss"):
            timer.function("distill losses", steps, name)
    timer.function("backward", torch.Tensor, "backward")
    timer.function("K5 (in backward)", bev_pool, "bev_pool_bwd_cuda")
    timer.function("K4 dgrad (in backward)", sparse_conv, "sparse_conv_dgrad_cuda")
    timer.function("K6 (in backward)", sparse_conv, "sparse_conv_wgrad_cuda")
    timer.function("optimizer", opt, "step")
    timer.function("step", steps, "distill_train_step" if kind == "distill" else "train_step")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--modality", choices=("camera", "lidar", "distill", "lidar-train", "fusion"),
                    default="camera")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--requests", type=int, default=5)
    ap.add_argument("--out", default="build/profile")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile: needs a CUDA device")

    from unidistill_torch.decode import proposals
    from unidistill_torch.layers import lidar_encoder, lss
    from unidistill_torch.serving.predictor import Detector
    from unidistill_torch.serving.synthetic import calibrate_batchnorm, random_state_dict
    from unidistill_torch.training import steps

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    lidar = args.modality == "lidar"
    sites = None
    timer = StageTimer()
    if args.modality == "distill":
        cfg, run, teacher, student, opt = distill_setup(args.batch)
        run()  # warm-up
        torch.cuda.reset_peak_memory_stats()
        time_train(timer, "distill", {"teacher forward": teacher, "student forward": student}, opt)
    elif args.modality in ("lidar-train", "fusion"):
        cfg, run, model, opt = train_setup(args.modality, args.batch)
        run()  # warm-up
        torch.cuda.reset_peak_memory_stats()
        mods = dict(model.named_modules())
        forwards = {"forward": model}
        for stage, name in (("LiDAR encoder", "lidar_encoder"), ("camera encoder", "camera_encoder"),
                            ("fusion encoder", "fusion_encoder")):
            if name in mods:
                forwards[stage] = mods[name]
        time_train(timer, args.modality, forwards, opt)
    else:
        cfg, batch = (lidar_setup if lidar else camera_setup)(args.batch)
        det = Detector(cfg, random_state_dict(cfg, seed=10 if lidar else 0), device="cuda")
        calibrate_batchnorm(det.model, steps.model_inputs(batch, cfg, "cuda", training=False))
        run = lambda: det.predict(batch)
        if lidar:  # the sites per stage of this batch, per sample
            rb = lidar_encoder.build_rulebooks(**steps.model_inputs(batch, cfg, "cuda", training=False),
                                               shapes=lidar_encoder.stage_shapes(cfg.grid_size))
            sites = [torch.bincount(st.coords[:, 0], minlength=args.batch).tolist() for st in rb.sites]
            del rb
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        mods = dict(det.model.named_modules())
        for stage, name in STAGE_MODULES.items():
            timer.module(stage, mods[name])
        if lidar:
            timer.function("voxelise", steps, "voxelize_batch")
            timer.function("rulebooks", lidar_encoder, "build_rulebooks")
            for stage, (first, last) in LIDAR_SPANS.items():
                timer.module(stage, mods[first], mods[last])
            timer.function("height compression", lidar_encoder, "to_dense_bev")
        else:
            for stage, name in CAMERA_MODULES.items():
                timer.module(stage, mods[name])
            timer.function("geometry", lss, "get_geometry")
            timer.function("bev pool", lss, "bev_pool_outer")
        timer.function("decode + nms", steps, "generate_proposals")
        timer.function("nms", proposals, "nms_bev_batched")
        timer.function("request", det, "predict")
    lat = []
    for _ in range(args.requests):
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    stages = timer.mean_ms(args.requests)
    timer.remove()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.requests):
            run()
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
        device=smi, modality=args.modality, batch=args.batch, requests=args.requests,
        latency_ms=[round(x * 1e3, 3) for x in lat], peak_mem_gib=peak_gib,
        frames_per_s=args.batch * len(lat) / sum(lat),
        stage_ms={k: round(v, 4) for k, v in sorted(stages.items(), key=lambda kv: -kv[1])},
        profiled_wall_ms_per_request=wall_ms / args.requests,
        kernel_ms_per_request=device_ms / args.requests,
        device_busy_share=device_ms / wall_ms if device_ms else None,
        top_kernels=[(e.key[:80], round(e.self_device_time_total / 1e3 / args.requests, 4))
                     for e in kernels[:12]],
        sites_per_stage=sites,
    )
    (out_dir / "stages.json").write_text(json.dumps(summary, indent=1))
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
