"""Device time of two ops of a source tree on the card, to compare two
commits in one call: run `k5` and `voxelize` once for each tree, in the
order parent, change, change, parent.

    python tools/op_times.py cells OUT.pt
    python tools/op_times.py k5 TREE CELLS.pt
    python tools/op_times.py voxelize TREE
    python tools/op_times.py predict TREE lidar|fusion

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
the host clock, the mean of 20 calls. `predict` serves TREE's LiDAR or
fusion detector (`lidar_exp()` / `fusion_exp()`, full width, seeded random
weights, BatchNorm calibrated on the batch) on `train_batch(cfg, cfg, 4,
seed=21)`: two warm-up requests, then 20 timed by the host clock around
work that ends in a synchronise, as `chip_smoke.py` times a request. Each
prints one JSON line per measurement, after the card's name and power
limit.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

GEOMETRIES = ("level", "train_ida", "pitch2", "train_ida_pitch2", "rot5.4")
B, SEED = 4, 21


def _card():
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()


def _cuda_ms(fn, iters):
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
        ms, _ = _cuda_ms(fn, 50)
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
    ms, wall_ms = _cuda_ms(lambda: vox(pts, mask, *args), 20)
    print(json.dumps(dict(tree=tree, op="voxelize", points=int(mask.sum()), ms=round(ms, 4),
                          wall_ms=round(wall_ms, 4))), flush=True)


def predict(tree, modality):
    sys.path.insert(0, tree)
    from unidistill_torch.configs.nuscenes import fusion_exp, lidar_exp
    from unidistill_torch.serving.predictor import Detector
    from unidistill_torch.serving.synthetic import calibrate_batchnorm, random_state_dict, train_batch
    from unidistill_torch.training.steps import model_inputs
    cfg = {"lidar": lidar_exp, "fusion": fusion_exp}[modality]().model
    dev = torch.device("cuda")

    def to_device(batch):
        return {k: to_device(v) if isinstance(v, dict) else torch.from_numpy(v).to(dev) for k, v in batch.items()}
    batch = to_device(train_batch(cfg, cfg, B, seed=SEED))
    det = Detector(cfg, random_state_dict(cfg, seed=40), device="cuda")
    calibrate_batchnorm(det.model, model_inputs(batch, cfg, dev, training=False))
    keys = ("points", "points_mask", "imgs", "mats") if modality == "fusion" else ("points", "points_mask")
    request = {k: batch[k] for k in keys}
    lat = []
    for i in range(22):
        t0 = time.perf_counter()
        det.predict(request)
        torch.cuda.synchronize()
        if i >= 2:
            lat.append((time.perf_counter() - t0) * 1e3)
    lat.sort()
    print(json.dumps(dict(tree=tree, op=f"{modality} predict", requests=len(lat),
                          mean_ms=round(sum(lat) / len(lat), 3), median_ms=round(lat[len(lat) // 2], 3),
                          min_ms=round(lat[0], 3), max_ms=round(lat[-1], 3))), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("op_times: needs a CUDA device")
    print(_card(), flush=True)
    {"cells": cells, "k5": k5, "voxelize": voxelize, "predict": predict}[sys.argv[1]](*sys.argv[2:])
