"""Device time of ops of a source tree on the card, to compare two commits
in one call: run `k5`, `voxelize`, `nms`, `band`, `k10`, `k8` and `k7`
once for each tree, in the order parent, change, change, parent.

    python tools/op_times.py cells OUT.pt
    python tools/op_times.py k5 TREE CELLS.pt
    python tools/op_times.py voxelize TREE
    python tools/op_times.py predict TREE camera|lidar|fusion|swin|sweeps2
    python tools/op_times.py step TREE distill|lidar|camera|swin|sweeps2
    python tools/op_times.py bn TREE camera|lidar|fusion [ROUNDS]
    python tools/op_times.py sweeps TREE [ROUNDS]
    python tools/op_times.py nms_cells OUT.pt
    python tools/op_times.py nms TREE NMS_CELLS.pt
    python tools/op_times.py band_cells OUT.pt
    python tools/op_times.py band TREE BAND_CELLS.pt
    python tools/op_times.py k10 TREE BAND_CELLS.pt
    python tools/op_times.py k8 TREE
    python tools/op_times.py k7 TREE

`cells` writes, with this tree's `serving.synthetic.nuscenes_cells`, the
flat BEV cells of the full-width camera model (B 4, six cameras, D 112,
fH 16, fW 44, a 180 x 180 grid) under five camera geometries, and the g
rows K5 reads on each before and after its redesign (`bev_pool_bwd_reads`,
modelled from the schedule):
  level             the level eval cameras of `nuscenes_batch`;
  train_ida         the training image augmentation of `DataConfig`
                    (resize 0.386-0.55, crop, flip, rotation within 5.4 deg);
  pitch2            the eval cameras tilted 2 degrees down;
  train_ida_pitch2  both;
  rot5.4            the eval image rotated by the augmentation's limit.
`k5` times TREE's `bev_pool_bwd_cuda` on each (seeded depth, context and g
on the card, the mean of 50 launches by CUDA events), holds it against
TREE's plain version at rtol/atol 1e-5 of max |ref| and two runs
bit-identical. `voxelize` times TREE's voxeliser on four full-size
10-sweep clouds at the eval cap: device ms by CUDA events and wall ms by
the host clock, the mean of 20 calls. `predict` serves TREE's camera, LiDAR or
fusion detector (`camera_exp()` / `lidar_exp()` / `fusion_exp()`, full width, seeded random
weights, BatchNorm calibrated on the batch) on `train_batch(cfg, cfg, 4,
seed=21)`: two warm-up requests, then 20 timed by the host clock around
work that ends in a synchronise, as `chip_smoke.py` times a request;
`swin` is the camera detector with the Swin-T backbone
(`configs.nuscenes.SWIN_CAMERA_OVERRIDES`), `sweeps2` the camera detector
on two sweeps (`nuscenes_batch(..., sweeps=2)`, weights of a 2-sweep
model); each prints its peak memory too, and the device ms of a request
(all its kernels, torch.profiler over 3 requests after the timed ones).
`step` trains with TREE's camera<-LiDAR `distill_train_step` (`distill`:
the camera student, seed 0, from the LiDAR teacher, seed 10, BatchNorm
calibrated) or the LiDAR detector's `train_step` (`lidar`, seed 30) on
`train_batch(camera, lidar, 4, seed=21)`, as `chip_smoke.py` [distill
train] and [lidar train] do: two warm-up steps, then 10 timed by the host
clock around a step and its one metrics read-back. `bn` serves TREE's
detector as `predict` does, in one process, with its eval BatchNorm in two
forms by turns (ROUNDS rounds, default 8, in the order A B B A ...):
"shipped", TREE's own `layers/common.BatchNorm`, and "cudnn",
`F.batch_norm` with cuDNN on; each round is 20 requests timed as
`predict` times them. It prints each round's median, the median of each
form's round medians, the device ms a request of each form's BatchNorm
kernels and of all its kernels (torch.profiler, 3 requests), and the max
|difference| of the two forms' boxes and scores. `sweeps` serves TREE's
camera detector, one sweep and two, in one process with two setups each:
"op_times", `predict`'s (weights of seed 40, `_frames`), and "smoke",
`chip_smoke.py` [predict] / [multisweep predict]'s (weights of seed 0,
`nuscenes_batch(cfg, 4, seed=1)`), BatchNorm calibrated on each one's
frames; ROUNDS rounds (default 2) of the four in order and then in
reverse, each 20 requests timed as `predict` times them; then each one's
round medians, its device ms a request (all kernels and K1's,
torch.profiler, 3 requests), the boxes it keeps and its peak memory; then
a 2-sweep train step of each setup (the smoke's: seed 0, untamed, frames
`nuscenes_batch(cfg, 4, seed=21, sweeps=2)`, as [multisweep train]), each
of 8 steps' ms in run order. Each prints one JSON line per measurement,
after the card's name and power limit.

`nms_cells` writes, with this tree, four sets of NMS lanes (24 lanes x 512
rows, threshold 0.1, post 100): the lanes that `Detector.predict` hands to
`nms_bev_batched` for the full-width camera and LiDAR detectors (seeded
random weights and batches, BatchNorm calibrated, as `chip_smoke.py` makes
them), and `synthetic.nms_lanes` "clustered" and "coincident" (seed 0).
`nms` times TREE's K2 (`rotated_iou_mask_cuda`) and K3
(`nms_greedy_select_cuda`) on each, the mean of 50 launches by CUDA events
(`k2_ms`, `k3_ms`: the wrapper's host work shows where a kernel is shorter)
and the kernel's own device time from torch.profiler (`*_kernel_ms`, null
if three profiles in a row recorded none), after
holding K2's words to TREE's plain mask outside a 1e-5 band of the
threshold and K3's keep sets to TREE's plain greedy.

`band_cells` writes, with this tree's `mb_gather_pallas.band_layout`, the
band gather's layouts at the published size (S 65536, W 640, R 2048, band
4096): published, one_position, edges, uniform (R 128) and ragged (S
64531, W 632), with the products K11 runs on each (`onehot_slabs_plain`).
`band` times TREE's K11 (`band_gather_onehot`) on each, after holding it to
TREE's plain gather bit for bit (its output in a block just filled with NaN,
`harness.poisoned_call`): `ms`, the kernel's device time from
torch.profiler, or by CUDA events where three profiles saw none
(`ms_source`, as `harness.device_ms`), and `events_ms`, the mean of 50
back-to-back launches by CUDA events.

`k10` times TREE's K10 (`band_gather_take`), K9 (`band_gather_fori`,
unroll 1) and `index_select` on the clipped rows on each of those layouts,
in turns, two rounds, each as `band` times K11, after holding K10 and K9
to TREE's plain gather bit for bit in a NaN-filled block; it first prints
the SASS instruction count of TREE's K10 kernel (`cuobjdump -sass` on
TREE's built library).

`k8` times TREE's K8 (`axpy2_cuda`, 2x + y in bf16 at [256, 256], as
`chip_smoke.py` [K8 smoke]) and `torch.add(y, x, alpha=2)` in turns, eight
rounds, the one timed first alternating: each one's `ms` as `band`'s and
`events_ms`, then each one's median, least and largest `ms`, after
holding K8 to 2x + y rounded once in a NaN-filled block. It first
prints each one's kernel as a torch.profiler trace records it (name,
grid, block, threads, registers, values a thread;
`harness.kernel_geometry`) and the SASS instruction count of TREE's K8
kernel.

`k7` times TREE's K7 (`fused_offsets_cuda`) on the three stages'
realistic inputs (four frames from `experiments/realistic.realistic_inputs`,
seeded and built as `chip_smoke.py` [K7] builds them), after holding it to
TREE's plain version within 1e-4 of max |ref| in a NaN-filled block and
two runs bit-identical: its launches (grid, block, registers, shared
bytes; `harness.kernel_geometry`), then four rounds of `ms` as `band`'s and
`events_ms` a stage, then each stage's median, least and largest `ms`.

The timing helpers are this checkout's
(`unidistill_torch/experiments/harness.py`), whatever TREE is.
"""
import dataclasses
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

# the timing helpers of this checkout, loaded by path: importing the package
# here would keep TREE's from being imported
_spec = importlib.util.spec_from_file_location(
    "_timing", Path(__file__).resolve().parents[1] / "unidistill_torch" / "experiments" / "harness.py")
_timing = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_timing)
kernel_ms, device_ms, poisoned_call = _timing.kernel_ms, _timing.device_ms, _timing.poisoned_call
kernel_geometry = _timing.kernel_geometry
sys.path.insert(0, str(Path(__file__).resolve().parent))
from variant_build import sass_counts  # noqa: E402  (imports no package)

GEOMETRIES = ("level", "train_ida", "pitch2", "train_ida_pitch2", "rot5.4")
B, SEED = 4, 21


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def cuda_ms(fn, iters):
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters, (time.perf_counter() - t0) / iters * 1e3


def cells(out):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from unidistill_torch.configs.nuscenes import DataConfig, camera_exp
    from unidistill_torch.ops.bev_pool import bev_pool_bwd_reads
    from unidistill_torch.serving.synthetic import nuscenes_cells
    cfg = camera_exp().model
    rot = dataclasses.replace(DataConfig(), ida_resize_lim=(0.44, 0.44), ida_rot_lim=(5.4, 5.4),
                              ida_rand_flip=False)  # the eval resize and crop, rotated
    kw = {"level": {}, "train_ida": dict(data=DataConfig()), "pitch2": dict(pitch_deg=2.0),
          "train_ida_pitch2": dict(data=DataConfig(), pitch_deg=2.0), "rot5.4": dict(data=rot)}
    saved = {}
    for name in GEOMETRIES:
        cell = nuscenes_cells(cfg, B, SEED, **kw[name]).contiguous()
        ray_runs, column_reads = bev_pool_bwd_reads(cell, 180 * 180)
        saved[name] = cell
        print(json.dumps(dict(geometry=name, points_in_grid=int(((cell >= 0) & (cell < 180 * 180)).sum()),
                              ray_runs=ray_runs, modelled_column_reads=column_reads)), flush=True)
    torch.save(saved, out)


def k5(tree, cells_file):
    sys.path.insert(0, tree)
    from unidistill_torch.ops import bev_pool
    saved = torch.load(cells_file)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = saved["level"].shape  # [B, NC, D, fH, fW]
    depth = torch.softmax(torch.randn(shape, generator=gen, device="cuda"), 2)
    ctx = torch.randn(*shape[:2], *shape[3:], 256, generator=gen, device="cuda")
    g = torch.randn(shape[0], 180 * 180, 256, generator=gen, device="cuda")
    for name in GEOMETRIES:
        cell = saved[name].cuda()
        fn = lambda: bev_pool.bev_pool_bwd_cuda(cell, depth, ctx, g, 180 * 180)
        a, b = fn(), fn()
        same = torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])
        ref = bev_pool.bev_pool_outer_bwd_plain(cell, depth, ctx, g, 180 * 180)
        err = 0.0
        for got, want in zip(a, ref):
            scale = want.abs().max().clamp_min(1e-30)
            torch.testing.assert_close(got / scale, want / scale, rtol=1e-5, atol=1e-5)
            err = max(err, (got - want).abs().max().item())
        del a, b, ref
        ms, _ = cuda_ms(fn, 50)
        print(json.dumps(dict(tree=tree, op="K5", geometry=name, ms=round(ms, 4), bit_identical=same,
                              max_abs_err=float(f"{err:.3e}"))), flush=True)
        if not same:
            raise RuntimeError(f"K5 on {name}: two runs differ")


def voxelize(tree):
    sys.path.insert(0, tree)
    from unidistill_torch.configs.nuscenes import lidar_exp
    from unidistill_torch.ops.voxelize import voxelize as vox
    from unidistill_torch.serving.synthetic import lidar_batch
    cfg = lidar_exp().model
    batch = lidar_batch(cfg, B, seed=11)
    pts, mask = torch.from_numpy(batch["points"]).cuda(), torch.from_numpy(batch["points_mask"]).cuda()
    args = (cfg.point_cloud_range, cfg.voxel_size, cfg.grid_size, cfg.caps.max_voxels_eval,
            cfg.caps.max_points_per_voxel)
    ms, wall_ms = cuda_ms(lambda: vox(pts, mask, *args), 20)
    print(json.dumps(dict(tree=tree, op="voxelize", points=int(mask.sum()), ms=round(ms, 4),
                          wall_ms=round(wall_ms, 4))), flush=True)


def _exp(modality):
    """The experiment of a `predict` / `step` modality and its camera
    sweeps."""
    from unidistill_torch.configs import nuscenes as c
    if modality == "swin":
        return c.apply_overrides(c.camera_exp(), c.SWIN_CAMERA_OVERRIDES), 1
    exps = {"camera": c.camera_exp, "sweeps2": c.camera_exp, "lidar": c.lidar_exp, "fusion": c.fusion_exp}
    return exps[modality](), 2 if modality == "sweeps2" else 1


def _frames(cfg, sweeps, dev):
    """`train_batch(cfg, cfg, B, SEED)` on the card, with S-sweep camera
    frames (`nuscenes_batch`) where sweeps > 1."""
    from unidistill_torch.serving.synthetic import nuscenes_batch, train_batch
    batch = train_batch(cfg, cfg, B, seed=SEED)
    if sweeps > 1:
        batch.update(nuscenes_batch(cfg, B, seed=SEED, sweeps=sweeps))

    def to_device(b):
        return {k: to_device(v) if isinstance(v, dict) else torch.from_numpy(v).to(dev) for k, v in b.items()}
    return to_device(batch)


def predict(tree, modality):
    sys.path.insert(0, tree)
    from unidistill_torch.serving.predictor import Detector
    from unidistill_torch.serving.synthetic import calibrate_batchnorm, random_state_dict
    from unidistill_torch.training.steps import model_inputs
    exp, sweeps = _exp(modality)
    cfg = exp.model
    dev = torch.device("cuda")
    batch = _frames(cfg, sweeps, dev)
    kw = {"sweeps": sweeps} if sweeps > 1 else {}  # a tree before multi-sweep input has no such argument
    det = Detector(cfg, random_state_dict(cfg, seed=40, **kw), device="cuda")
    calibrate_batchnorm(det.model, model_inputs(batch, cfg, dev, training=False))
    keys = (("points", "points_mask") if cfg.with_lidar else ()) + (("imgs", "mats") if cfg.with_camera else ())
    request = {k: batch[k] for k in keys}
    torch.cuda.reset_peak_memory_stats()
    lat = []
    for i in range(22):
        t0 = time.perf_counter()
        det.predict(request)
        torch.cuda.synchronize()
        if i >= 2:
            lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    peak = torch.cuda.max_memory_allocated() / 2**30
    device = _timing._per_call(_timing._profiled(lambda: det.predict(request), None, 3), 3)[0]
    print(json.dumps(dict(tree=tree, op=f"{modality} predict", requests=len(lat),
                          mean_ms=round(sum(lat) / len(lat), 3), median_ms=round(lat[len(lat) // 2], 3),
                          min_ms=round(lat[0], 3), max_ms=round(lat[-1], 3), device_ms=round(device, 4),
                          peak_mem_gib=round(peak, 3), card=_card())),
          flush=True)


def _bn_kernel(name):
    n = name.lower()
    return "batch_norm" in n or "bn_fw" in n


def bn(tree, modality, rounds="8"):
    sys.path.insert(0, tree)
    import torch.nn.functional as F
    from unidistill_torch.configs.nuscenes import camera_exp, fusion_exp, lidar_exp
    from unidistill_torch.layers.common import BatchNorm
    from unidistill_torch.serving.predictor import Detector
    from unidistill_torch.serving.synthetic import calibrate_batchnorm, random_state_dict, train_batch
    from unidistill_torch.training.steps import model_inputs
    cfg = {"camera": camera_exp, "lidar": lidar_exp, "fusion": fusion_exp}[modality]().model
    dev = torch.device("cuda")
    assert torch.backends.cudnn.enabled

    def to_device(batch):
        return {k: to_device(v) if isinstance(v, dict) else torch.from_numpy(v).to(dev) for k, v in batch.items()}
    batch = to_device(train_batch(cfg, cfg, B, seed=SEED))
    det = Detector(cfg, random_state_dict(cfg, seed=40), device="cuda")
    calibrate_batchnorm(det.model, model_inputs(batch, cfg, dev, training=False))
    keys = (("points", "points_mask") if cfg.with_lidar else ()) + (("imgs", "mats") if cfg.with_camera else ())
    request = {k: batch[k] for k in keys}
    shipped = BatchNorm.forward

    def cudnn_forward(self, x):
        if self.training:
            return shipped(self, x)
        return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0, self.eps)
    forms = {"shipped": shipped, "cudnn": cudnn_forward}

    def timed():
        lat = []
        for i in range(22):
            t0 = time.perf_counter()
            det.predict(request)
            torch.cuda.synchronize()
            if i >= 2:
                lat.append((time.perf_counter() - t0) * 1e3)
        lat.sort()
        return lat[len(lat) // 2]
    outs, device, medians = {}, {}, {f: [] for f in forms}
    for form, fwd in forms.items():
        BatchNorm.forward = fwd
        outs[form] = det.predict(request)
        records = _timing._profiled(lambda: det.predict(request), None, 3)
        bn_records = {k: v for k, v in records.items() if _bn_kernel(k)}
        device[form] = dict(bn_device_ms=round(_timing._per_call(bn_records, 3)[0], 4),
                            all_device_ms=round(_timing._per_call(records, 3)[0], 4),
                            bn_kernels=sorted(bn_records))
    order = ["shipped", "cudnn", "cudnn", "shipped"]
    for r in range(int(rounds)):
        form = order[r % 4]
        BatchNorm.forward = forms[form]
        medians[form].append(timed())
        print(json.dumps(dict(tree=tree, op=f"{modality} bn round", round=r, form=form,
                              median_ms=round(medians[form][-1], 3))), flush=True)
    BatchNorm.forward = shipped
    diff = max(float((torch.as_tensor(outs["shipped"][k]).float() - torch.as_tensor(outs["cudnn"][k]).float())
                     .abs().max()) for k in ("boxes", "scores"))
    for form in forms:
        m = sorted(medians[form])
        print(json.dumps(dict(tree=tree, op=f"{modality} bn", form=form, rounds=len(m),
                              median_of_rounds_ms=round((m[(len(m) - 1) // 2] + m[len(m) // 2]) / 2, 3),
                              **device[form])), flush=True)
    print(json.dumps(dict(tree=tree, op=f"{modality} bn", max_abs_diff_boxes_scores=diff)), flush=True)


def step(tree, which):
    sys.path.insert(0, tree)
    from unidistill_torch.configs.nuscenes import DISTILL_VARIANTS, camera_exp, distill_exp, lidar_exp
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.serving.synthetic import calibrate_batchnorm, random_state_dict, train_batch
    from unidistill_torch.training import steps
    from unidistill_torch.training.train_state import TrainState, make_optimizer
    s_cfg, t_cfg = camera_exp().model, lidar_exp().model
    dev = torch.device("cuda")

    def to_device(batch):
        return {k: to_device(v) if isinstance(v, dict) else torch.from_numpy(v).to(dev) for k, v in batch.items()}

    def model(cfg, seed):
        m = BEVFusionCenterHead(cfg)
        m.load_state_dict(random_state_dict(cfg, seed=seed))
        return m.to(dev)
    batch = to_device(train_batch(s_cfg, t_cfg, B, seed=21))
    state = TrainState()
    if which == "distill":
        teacher = model(t_cfg, 10).requires_grad_(False)
        calibrate_batchnorm(teacher, steps.model_inputs(batch, t_cfg, dev, training=False))
        student = model(s_cfg, 0)
        opt = make_optimizer(student, distill_exp("lidar", "camera").train)
        fn = lambda: steps.distill_train_step(state, batch, student, teacher, opt, s_cfg, t_cfg,
                                              DISTILL_VARIANTS[("lidar", "camera")])
    elif which == "lidar":
        student = model(t_cfg, 30)
        opt = make_optimizer(student, lidar_exp().train)
        fn = lambda: steps.train_step(state, batch, student, opt, t_cfg)
    else:  # a camera detector's own step, its BatchNorms tamed by TREE's chip_smoke.py
        from chip_smoke import tame
        exp, sweeps = _exp(which)
        cfg = exp.model
        frames = _frames(cfg, sweeps, dev)
        kw = {"sweeps": sweeps} if sweeps > 1 else {}  # a tree before multi-sweep input has no such argument
        student = BEVFusionCenterHead(cfg, **kw)
        student.load_state_dict(random_state_dict(cfg, seed=0, **kw))
        tame(student)
        student.to(dev)
        opt = make_optimizer(student, exp.train)
        fn = lambda: steps.train_step(state, frames, student, opt, cfg)
    torch.cuda.reset_peak_memory_stats()
    run = []
    for i in range(12):
        t0 = time.perf_counter()
        steps.metrics_to_host(fn())
        run.append((time.perf_counter() - t0) * 1e3)
    ts = sorted(run[2:])
    print(json.dumps(dict(tree=tree, op=f"{which} step", steps=len(ts), median_ms=round((ts[4] + ts[5]) / 2, 3),
                          min_ms=round(ts[0], 3), max_ms=round(ts[-1], 3), run_ms=[round(t, 3) for t in run],
                          peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3), card=_card())),
          flush=True)



def sweeps_compare(tree, rounds="2"):
    sys.path.insert(0, tree)
    from chip_smoke import to_device
    from unidistill_torch.configs.nuscenes import camera_exp
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.serving.predictor import Detector
    from unidistill_torch.serving.synthetic import (
        calibrate_batchnorm, nuscenes_batch, random_state_dict, train_batch)
    from unidistill_torch.training import steps
    from unidistill_torch.training.train_state import TrainState, make_optimizer
    exp = camera_exp()
    cfg = exp.model
    dev = torch.device("cuda")

    def served(s, seed, frames):
        det = Detector(cfg, random_state_dict(cfg, seed=seed, sweeps=s), device="cuda")
        calibrate_batchnorm(det.model, steps.model_inputs(frames, cfg, dev, training=False))
        return det, {k: frames[k] for k in ("imgs", "mats")}
    forms = {}
    for s in (1, 2):
        forms[f"op_times {s}"] = served(s, 40, _frames(cfg, s, dev))
        forms[f"smoke {s}"] = served(s, 0, to_device(nuscenes_batch(cfg, B, seed=1, sweeps=s), dev))

    def timed(det, request):
        lat = []
        for i in range(22):
            t0 = time.perf_counter()
            det.predict(request)
            torch.cuda.synchronize()
            if i >= 2:
                lat.append((time.perf_counter() - t0) * 1e3)
        lat.sort()
        return lat[len(lat) // 2]
    medians = {f: [] for f in forms}
    for r in range(int(rounds)):
        for form in list(forms)[::1 if r % 2 == 0 else -1] + list(forms)[::-1 if r % 2 == 0 else 1]:
            medians[form].append(timed(*forms[form]))
            print(json.dumps(dict(tree=tree, op="sweeps round", round=r, form=form,
                                  median_ms=round(medians[form][-1], 3))), flush=True)
    for form, (det, request) in forms.items():
        torch.cuda.reset_peak_memory_stats()
        kept = det.predict(request)["mask"].sum(1).tolist()
        records = _timing._profiled(lambda: det.predict(request), None, 3)
        k1 = {k: v for k, v in records.items() if "bev_pool" in k}
        m = sorted(medians[form])
        print(json.dumps(dict(tree=tree, op="sweeps predict", form=form, round_medians_ms=[round(x, 3) for x in m],
                              median_of_rounds_ms=round((m[(len(m) - 1) // 2] + m[len(m) // 2]) / 2, 3),
                              all_device_ms=round(_timing._per_call(records, 3)[0], 4),
                              k1_device_ms=round(_timing._per_call(k1, 3)[0], 4), kept_boxes=kept,
                              peak_mem_gib=round(torch.cuda.max_memory_allocated() / 2**30, 3), card=_card())),
              flush=True)
    del forms
    torch.cuda.empty_cache()
    gt = train_batch(cfg, cfg, B, seed=SEED)["gt_boxes"]
    for form in ("op_times", "smoke"):
        if form == "op_times":
            frames, seed = _frames(cfg, 2, dev), 40
        else:
            frames = to_device(dict(nuscenes_batch(cfg, B, seed=SEED, sweeps=2), gt_boxes=gt), dev)
            seed = 0
        model = BEVFusionCenterHead(cfg, 2)
        model.load_state_dict(random_state_dict(cfg, seed=seed, sweeps=2))
        model.to(dev)
        opt = make_optimizer(model, exp.train)
        state = TrainState()
        run = []
        for _ in range(8):
            t0 = time.perf_counter()
            steps.metrics_to_host(steps.train_step(state, frames, model, opt, cfg))
            run.append((time.perf_counter() - t0) * 1e3)
        print(json.dumps(dict(tree=tree, op="sweeps step", form=form, run_ms=[round(t, 3) for t in run],
                              card=_card())), flush=True)
        del model, opt, state, frames
        torch.cuda.empty_cache()


def nms_cells(out):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from unidistill_torch.configs.nuscenes import camera_exp, lidar_exp
    from unidistill_torch.decode import proposals
    from unidistill_torch.ops import nms
    from unidistill_torch.serving.predictor import Detector
    from unidistill_torch.serving.synthetic import (
        calibrate_batchnorm, lidar_batch, nms_lanes, nuscenes_batch, random_state_dict)
    from unidistill_torch.training.steps import model_inputs
    dev = torch.device("cuda")
    saved = {}
    for name, exp, seeds in (("camera", camera_exp, (0, 1)), ("lidar", lidar_exp, (10, 11))):
        cfg = exp().model
        det = Detector(cfg, random_state_dict(cfg, seed=seeds[0]), device="cuda")
        if name == "camera":
            batch = nuscenes_batch(cfg, B, seed=seeds[1])
            request = {"imgs": torch.from_numpy(batch["imgs"]).to(dev),
                       "mats": {k: torch.from_numpy(v).to(dev) for k, v in batch["mats"].items()}}
        else:
            request = {k: torch.from_numpy(v).to(dev) for k, v in lidar_batch(cfg, B, seed=seeds[1]).items()}
        calibrate_batchnorm(det.model, model_inputs(request, cfg, dev, training=False))
        calls, real = [], proposals.nms_bev_batched
        proposals.nms_bev_batched = lambda *a, **kw: calls.append((a, kw)) or real(*a, **kw)
        det.predict(request)
        proposals.nms_bev_batched = real
        (boxes, valid, thr, post), kw = calls[0]
        bev, v = nms._candidate_lanes(boxes, valid, post, kw.get("cap", 512))
        saved[name] = (bev.cpu(), v.cpu(), float(thr), int(post))
        del det
        torch.cuda.empty_cache()
    for kind in ("clustered", "coincident"):
        bev, v = nms_lanes(kind, seed=0)
        saved[kind] = (torch.from_numpy(bev), torch.from_numpy(v), 0.1, 100)
    for name, (bev, v, thr, post) in saved.items():
        print(json.dumps(dict(layout=name, lanes=v.shape[0], C=v.shape[1], valid_rows=int(v.sum()),
                              thr=thr, post=post)), flush=True)
    torch.save(saved, out)


def nms(tree, cells_file):
    sys.path.insert(0, tree)
    from unidistill_torch.ops import nms as ops
    for name, (bev, v, thr, post) in torch.load(cells_file).items():
        bev, v = bev.cuda(), v.cuda()
        words = ops.rotated_iou_mask_cuda(bev, v, thr)
        diff = ops.unpack_mask_bits(words) ^ ops.iou_over_plain(bev, v, thr)
        if not ((ops.rotated_iou_bev_plain(bev, bev) - thr).abs()[diff] < 1e-5).all():
            raise RuntimeError(f"K2 on {name}: mask differs off the threshold band")
        keep = ops.nms_greedy_select_cuda(words, v, post)
        ref = ops.greedy_select_plain(ops.unpack_mask_bits(words), v, post)
        if not (torch.equal(keep[0], ref[0]) and torch.equal(keep[1], ref[1])):
            raise RuntimeError(f"K3 on {name}: keep sets differ from the plain greedy")
        k2 = lambda: ops.rotated_iou_mask_cuda(bev, v, thr)
        k3 = lambda: ops.nms_greedy_select_cuda(words, v, post)
        k2_ms, _ = cuda_ms(k2, 50)
        k3_ms, _ = cuda_ms(k3, 50)
        k2_kernel_ms, k3_kernel_ms = kernel_ms(k2, "iou_mask_kernel"), kernel_ms(k3, "greedy_kernel")
        print(json.dumps(dict(tree=tree, layout=name, k2_ms=round(k2_ms, 5), k3_ms=round(k3_ms, 5),
                              k2_kernel_ms=None if k2_kernel_ms is None else round(k2_kernel_ms, 5),
                              k3_kernel_ms=None if k3_kernel_ms is None else round(k3_kernel_ms, 5),
                              differing_bits=int(diff.sum()), kept=int(keep[1].sum()))), flush=True)


BAND_LAYOUTS = {"published": (65536, 640, 2048, 4096), "one_position": (65536, 640, 2048, 4096),
                "edges": (65536, 640, 2048, 4096), "uniform": (65536, 640, 128, 4096),
                "ragged": (64531, 632, 2048, 4096)}


def band_cells(out):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from unidistill_torch.experiments.mb_gather_pallas import band_layout
    from unidistill_torch.ops.band_gather import onehot_slabs_plain
    saved = {}
    for kind, (S, W, R, band) in BAND_LAYOUTS.items():
        tab, idx, w = band_layout(kind, S, W, R, band, seed=0)
        pairs = int(onehot_slabs_plain(idx, w, R, band)[1].numel())
        saved[kind] = (tab, idx, w, R, band)
        print(json.dumps(dict(layout=kind, S=S, W=W, R=R, band=band, products_per_n8_tile=pairs,
                              dense_products_per_n8_tile=-(-S // 16) * (band // 16))), flush=True)
    torch.save(saved, out)


def _band_times(tree, cells_file, ops, rounds):
    """Device time of TREE's band gathers `ops` (K11, K10, K9; index_select
    on the clipped rows, the yardstick) on each layout, in turns, after
    holding each kernel to TREE's plain gather bit for bit in a NaN-filled
    block."""
    sys.path.insert(0, tree)
    from unidistill_torch.ops import band_gather as bg
    for kind, (tab, idx, w, R, nb) in torch.load(cells_file).items():
        tab, idx, w = tab.cuda(), idx.cuda(), w.cuda()
        src = bg.band_source_rows(idx, w, R, nb).long()
        calls = {"K11": (lambda: bg.band_gather_onehot(tab, idx, w, R, nb), "band_gather_onehot_kernel"),
                 "K10": (lambda: bg.band_gather_take(tab, idx, w, R, nb), "band_gather_take_kernel"),
                 "K9": (lambda: bg.band_gather_fori(tab, idx, w, R, nb), "band_gather_fori_kernel"),
                 "index_select": (lambda: tab.index_select(0, src), None)}
        ref = bg.band_gather_plain(tab, idx, w, R, nb)
        for op in ops:
            if op != "index_select":
                got = poisoned_call(calls[op][0], ref.numel() * ref.element_size())
                if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
                    raise RuntimeError(f"{op} on {kind}: differs from the plain gather")
                del got
        del ref
        for rnd in range(rounds):
            for op in ops:
                ms, source, events_ms = device_ms(*calls[op])
                print(json.dumps(dict(tree=tree, layout=kind, op=op, round=rnd, ms=round(ms, 5), ms_source=source,
                                      events_ms=round(events_ms, 5))), flush=True)
        del tab, idx, w, src
        torch.cuda.empty_cache()


def band(tree, cells_file):
    _band_times(tree, cells_file, ("K11",), 1)


def k10(tree, cells_file):
    sys.path.insert(0, tree)
    from unidistill_torch.kernels import build
    build.library("band_gather")
    counts = sass_counts(build._lib_path("band_gather"), "band_gather_take_kernel")
    print(json.dumps(dict(tree=tree, sass={k: dict(c) for k, c in counts.items()})), flush=True)
    _band_times(tree, cells_file, ("K10", "K9", "index_select"), 2)


def k8(tree):
    sys.path.insert(0, tree)
    from unidistill_torch.kernels import build
    from unidistill_torch.ops import fused_offsets as fo
    gen = torch.Generator().manual_seed(31)
    x = torch.randn(256, 256, generator=gen).mul(4).to(torch.bfloat16).cuda()
    y = torch.randn(256, 256, generator=gen).to(torch.bfloat16).cuda()
    got = poisoned_call(lambda: fo.axpy2_cuda(x, y), x.numel() * 2)
    if not torch.equal(got.view(torch.int16), fo.smoke_plain(x, y).view(torch.int16)):
        raise RuntimeError("K8 differs from 2x + y rounded once")
    calls = {"K8": (lambda: fo.axpy2_cuda(x, y), "axpy2_kernel"), "torch.add": (lambda: torch.add(y, x, alpha=2), None)}
    for op, (fn, name) in calls.items():
        for g in kernel_geometry(fn, name):
            print(json.dumps(dict(tree=tree, op=op, values_per_thread=x.numel() // g["threads"], **g)), flush=True)
    counts = sass_counts(build._lib_path("fused_offsets"), "axpy2")
    print(json.dumps(dict(tree=tree, sass={k: dict(c) for k, c in counts.items()})), flush=True)
    times = {op: [] for op in calls}
    for rnd in range(8):
        for op in list(calls)[::1 if rnd % 2 == 0 else -1]:  # who goes first alternates
            fn, name = calls[op]
            ms, source, events_ms = device_ms(fn, name)
            times[op].append(ms)
            print(json.dumps(dict(tree=tree, op=op, round=rnd, ms=round(ms, 7), ms_source=source,
                                  events_ms=round(events_ms, 5))), flush=True)
    for op, ts in times.items():
        ts.sort()
        print(json.dumps(dict(tree=tree, op=op, rounds=len(ts), median_ms=round((ts[3] + ts[4]) / 2, 7),
                              min_ms=round(ts[0], 7), max_ms=round(ts[-1], 7))), flush=True)


K7_STAGES = ("s2", "s0", "s3")


def k7(tree):
    sys.path.insert(0, tree)
    from unidistill_torch.configs.nuscenes import lidar_exp
    from unidistill_torch.experiments.realistic import realistic_inputs
    from unidistill_torch.ops import fused_offsets as fo
    from unidistill_torch.ops.sparse_conv_chunked import _OFFS8, _band_weight, _w_zyx, _window_table
    inputs, _ = realistic_inputs(lidar_exp().model, K7_STAGES, device=torch.device("cuda"))
    for st in K7_STAGES:
        xs = inputs[st]
        tab = _window_table(xs.feats, xs.occ_bits, xs.colkey, xs.chunk, xs.valid, torch.bfloat16)
        W6 = _band_weight(_w_zyx(xs.weight), xs.C, xs.C, 6, 1, torch.bfloat16)
        g, oh = fo.offset_operands(tab, xs.tables, xs.S, xs.C, torch.bfloat16)
        W8 = W6[list(_OFFS8)].contiguous()
        del tab, W6
        fn = lambda: fo.fused_offsets_cuda(g, oh, W8)  # noqa: E731
        nbytes = g.shape[0] * xs.S * W8.shape[2] * 4
        got = poisoned_call(fn, nbytes)
        ref = fo.fused_offsets_plain(g, oh, W8)
        err, scale = (got - ref).abs().max().item(), ref.abs().max().item()
        if not err <= 1e-4 * scale:
            raise RuntimeError(f"K7 at {st}: max |diff| {err:.3e} > 1e-4 x max |ref| {scale:.3e}")
        if not torch.equal(poisoned_call(fn, nbytes), got):
            raise RuntimeError(f"K7 at {st}: two runs on the same inputs are not bit-identical")
        del got, ref
        for geo in kernel_geometry(fn, "fused_offsets_kernel"):
            print(json.dumps(dict(tree=tree, op="K7", stage=st, max_abs_err=err, max_abs_ref=scale,
                                  **{k: geo[k] for k in ("grid", "block", "registers", "shared_bytes")})), flush=True)
        ts = []
        for rnd in range(4):
            ms, source, events_ms = device_ms(fn, "fused_offsets_kernel")
            ts.append(ms)
            print(json.dumps(dict(tree=tree, op="K7", stage=st, round=rnd, ms=round(ms, 5), ms_source=source,
                                  events_ms=round(events_ms, 5))), flush=True)
        ts.sort()
        print(json.dumps(dict(tree=tree, op="K7", stage=st, rounds=len(ts), median_ms=round((ts[1] + ts[2]) / 2, 5),
                              min_ms=round(ts[0], 5), max_ms=round(ts[-1], 5))), flush=True)
        del g, oh, W8
        torch.cuda.empty_cache()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("op_times: needs a CUDA device")
    print(_card(), flush=True)
    {"cells": cells, "k5": k5, "voxelize": voxelize, "predict": predict, "step": step, "bn": bn, "sweeps": sweeps_compare, "nms_cells": nms_cells,
     "nms": nms, "band_cells": band_cells, "band": band, "k10": k10, "k8": k8, "k7": k7}[sys.argv[1]](*sys.argv[2:])
