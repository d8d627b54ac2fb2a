#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from `unidistill_torch/csrc`, serves the
full-width camera detector (`camera_exp().model`, bf16, seeded random
weights, BatchNorm statistics calibrated on the batch) through `Detector.predict` at batch 4, and holds every kernel of
that path against its plain PyTorch version on the inputs the path gave it.
Phases, each printed on its own line:

  device   card name and power limit (nvidia-smi), torch and CUDA versions
  build    one nvcc per source, all started together; build time
  predict  warm-up request, then timed requests with every launch count set
           to 0 just before and read just after; latency, frames/s, peak
           memory, kept boxes, launches (each kernel must launch)
  K1/K2/K3 kernel vs plain version on the recorded main-path inputs: max
           error against the stated tolerance, kernel / plain / library ms
  heads    one request's head tensors, kernels vs plain versions, in bf16
           and in f32; rois: the ROIs from the same heads, K2/K3 vs plain
  tiny     a small float32 detector on the card vs the same on the CPU

Any failed phase raises, so the script exits non-zero. The last two lines
are the kernel table (JSON) and {"ok": true, "device": {...}}.
nvcc's register report goes to build/unidistill_torch/nvcc.log.
"""
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
BATCH = 4
TIMED_REQUESTS = 3
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
# float operations per rotated-IoU pair, counted from csrc/nms.cu: 8 edge
# clips x (4 planes x 14 + 13 tail) + 6 for the IoU
IOU_OPS_PER_PAIR = 8 * (4 * 14 + 13) + 6
# tolerances, with their reasons
K1_TOL = dict(rtol=1e-4, atol=1e-4)  # f32 atomics sum in another order
K2_TOL = dict(rtol=1e-4, atol=1e-5)  # same float math; libm cos/sin may differ by an ulp
K2_THR_BAND = 1e-5                   # mask bits may differ only where |iou - thr| < band
# heads, kernels vs plain, as max |diff| over max |ref|: in f32 the pool's
# summation order only; in bf16 that round-off flips bf16 roundings (2^-8)
# which spread through the convolutions after the pool (3e-2 seen on the H100)
HEAD_REL_TOL_F32 = 1e-3
HEAD_REL_TOL_BF16 = 1e-1
# card vs CPU in f32 with TF32 off, as max |diff| over max |ref|: cuDNN's
# f32 convolution algorithms round otherwise than the CPU's direct sums, over
# ~80 convolutions (7.9e-4 seen on the H100; the kernels add ~1e-5)
TINY_REL_TOL = 5e-3


def log(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters=10, warmup=2):
    """Mean device time of fn() over `iters` launches, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


class Recorder:
    """Wraps a module-level function and keeps the arguments of its calls."""

    def __init__(self, module, name):
        self.module, self.name, self.fn = module, name, getattr(module, name)
        self.calls = []

    def __enter__(self):
        def wrapped(*args, **kwargs):
            self.calls.append((args, kwargs))
            return self.fn(*args, **kwargs)
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class PlainVersions:
    """Routes the main path through the kernels' plain PyTorch versions (on
    the card) while active; used only to build the comparison reference."""

    def __enter__(self):
        from unidistill_torch.decode import proposals
        from unidistill_torch.layers import lss
        from unidistill_torch.ops import bev_pool, nms
        self.saved = [(lss, "bev_pool_outer", lss.bev_pool_outer),
                      (proposals, "nms_bev_batched", proposals.nms_bev_batched)]
        lss.bev_pool_outer = bev_pool.bev_pool_outer_plain
        proposals.nms_bev_batched = nms.nms_bev_batched_plain
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def max_err(got, ref):
    d = (got.float() - ref.float()).abs()
    return d.max().item(), (d / ref.float().abs().clamp_min(1e-6)).max().item()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "unidistill_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository (unidistill_torch/ is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from unidistill_torch.configs.nuscenes import camera_exp, tiny_model
    from unidistill_torch.decode import proposals
    from unidistill_torch.kernels import build
    from unidistill_torch.layers import lss
    from unidistill_torch.ops import bev_pool, nms
    from unidistill_torch.serving.predictor import Detector
    from unidistill_torch.serving.synthetic import (
        calibrate_batchnorm, nuscenes_batch, random_state_dict, small_batch)
    from unidistill_torch.training.steps import model_inputs

    t_start = time.time()
    # stated: f32 convolutions and matmuls run in full f32 (no TF32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    smi = nvidia_smi_line()
    log("device", smi=repr(smi), torch=torch.__version__, cuda=torch.version.cuda,
        count=torch.cuda.device_count(), cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
        matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    # ---- build -----------------------------------------------------------
    t0 = time.time()
    logs = build.build_all()
    build_s = time.time() - t0
    (build.BUILD_DIR / "nvcc.log").write_text("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    for name in build.SOURCES:
        build.library(name)
    log("build", seconds=f"{build_s:.2f}", built=",".join(sorted(logs)) or "cached")

    # ---- full-width predict ------------------------------------------------
    cfg = camera_exp().model
    sd = random_state_dict(cfg, seed=0)
    det = Detector(cfg, sd, device="cuda")
    batch = nuscenes_batch(cfg, BATCH, seed=1)
    batch_dev = {"imgs": torch.from_numpy(batch["imgs"]).to(dev),
                 "mats": {k: torch.from_numpy(v).to(dev) for k, v in batch["mats"].items()}}
    calibrate_batchnorm(det.model, model_inputs(batch_dev, cfg, dev))
    with Recorder(lss, "bev_pool_outer") as pool_rec, \
            Recorder(proposals, "nms_bev_batched") as nms_rec:
        warm = det.predict(batch_dev)
        torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    lat = []
    for _ in range(TIMED_REQUESTS):
        t0 = time.perf_counter()
        rois = det.predict(batch_dev)
        torch.cuda.synchronize()
        lat.append(time.perf_counter() - t0)
    launches = dict(build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    kept = rois["mask"].sum(1).tolist()
    log("predict", batch=BATCH, requests=TIMED_REQUESTS,
        latency_ms=[round(x * 1e3, 3) for x in lat],
        frames_per_s=f"{BATCH * len(lat) / sum(lat):.3f}", peak_mem_gib=f"{peak_gib:.3f}",
        kept_boxes=kept, launches=json.dumps(launches, sort_keys=True))
    main_path = ("bev_pool_fwd", "rotated_iou_mask", "nms_greedy_select")
    for k in main_path:
        if launches.get(k, 0) < TIMED_REQUESTS:
            raise RuntimeError(f"kernel {k} launched {launches.get(k, 0)} times in "
                               f"{TIMED_REQUESTS} requests")
    R = len(cfg.tasks) * cfg.proposal.nms_post_max_size_test
    for k, v in rois.items():
        if tuple(v.shape[:2]) != (BATCH, R):
            raise RuntimeError(f"rois[{k}] has shape {tuple(v.shape)}")
    if not torch.isfinite(rois["boxes"]).all() or not torch.isfinite(rois["scores"]).all():
        raise RuntimeError("non-finite ROI values")
    if not all(k > 0 for k in kept):
        raise RuntimeError(f"a sample kept no boxes: {kept}")
    if not torch.equal(warm["mask"], rois["mask"]):
        print("[predict] note: kept masks differ between requests (atomic sum order)")

    table = []

    # ---- K1 ------------------------------------------------------------------
    (geom_idx, depth, context, voxel_num), _ = pool_rec.calls[0]
    nx, ny, nz = voxel_num
    ncells = nx * ny
    cell = bev_pool._linear_index(geom_idx, nx, ny, nz).to(torch.int32).contiguous()
    depth, context = depth.float().contiguous(), context.float().contiguous()
    got = bev_pool.bev_pool_cells_cuda(cell, depth, context, ncells).reshape(BATCH, ny, nx, -1)
    ref = bev_pool.bev_pool_outer_plain(geom_idx, depth, context, voxel_num)
    torch.cuda.synchronize()
    abs_e, rel_e = max_err(got, ref)
    torch.testing.assert_close(got, ref, **K1_TOL)
    ms = cuda_ms(lambda: bev_pool.bev_pool_cells_cuda(cell, depth, context, ncells))
    plain_ms = cuda_ms(lambda: bev_pool.bev_pool_outer_plain(geom_idx, depth, context, voxel_num), iters=3)
    C = context.shape[-1]
    rows = (cell.long().clamp(max=ncells) + torch.arange(BATCH, device=dev).view(-1, 1, 1, 1, 1) * (ncells + 1)).reshape(-1)
    prod = (depth[..., None] * context[:, :, None]).reshape(-1, C)
    lib_out = torch.zeros(BATCH * (ncells + 1), C, device=dev)
    library_ms = cuda_ms(lambda: lib_out.index_add_(0, rows, prod), iters=3)
    del prod, lib_out
    n_valid = int((cell < ncells).sum().item())
    k1_bytes = cell.numel() * 4 + depth.numel() * 4 + context.numel() * 4 + BATCH * ncells * C * 4
    k1_ops = 2 * n_valid * C
    bound = max(k1_bytes / HBM_BYTES_PER_S, k1_ops / F32_OPS_PER_S) * 1e3
    log("K1 bev_pool_fwd", points=cell.numel(), valid_points=n_valid, max_abs_err=f"{abs_e:.3e}",
        max_rel_err=f"{rel_e:.3e}",
        tol=K1_TOL, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
        bound_ms=f"{bound:.4f}")
    table.append(dict(name="bev_pool_fwd", route="cuda", source="unidistill_torch/csrc/bev_pool.cu",
                      replaces="unidistill_tpu/ops/bev_pool.py:158", launches=launches["bev_pool_fwd"],
                      max_abs_err=abs_e, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                      bound_by="bytes" if k1_bytes / HBM_BYTES_PER_S >= k1_ops / F32_OPS_PER_S else "operations",
                      library_ms=library_ms))

    # ---- K2 / K3 -------------------------------------------------------------
    (boxes, valid, thr, post), kw = nms_rec.calls[0]
    cap = kw.get("cap", 512)
    bev, v = nms._candidate_lanes(boxes, valid, post, cap)
    L, Cn = v.shape
    iou_k = nms.rotated_iou_cuda(bev, bev)
    iou_p = nms.rotated_iou_bev_plain(bev, bev)
    iou_abs, iou_rel = max_err(iou_k, iou_p)
    torch.testing.assert_close(iou_k, iou_p, **K2_TOL)
    log("K2 rotated_iou float mode", lanes=L, C=Cn, max_abs_err=f"{iou_abs:.3e}", max_rel_err=f"{iou_rel:.3e}", tol=K2_TOL,
        ms=f"{cuda_ms(lambda: nms.rotated_iou_cuda(bev, bev)):.4f}")
    words = nms.rotated_iou_mask_cuda(bev, v, thr)
    over_p = nms.iou_over_plain(bev, v, thr)
    diff = nms.unpack_mask_bits(words) ^ over_p
    n_diff = int(diff.sum().item())
    if n_diff and not ((iou_p - thr).abs()[diff] < K2_THR_BAND).all():
        raise RuntimeError(f"K2 mask differs from the plain version at {n_diff} bits off the threshold band")
    ms = cuda_ms(lambda: nms.rotated_iou_mask_cuda(bev, v, thr))
    plain_ms = cuda_ms(lambda: nms.pack_mask_bits(nms.iou_over_plain(bev, v, thr)), iters=3)
    pairs = L * Cn * (Cn - 1) // 2
    bound = max(pairs * IOU_OPS_PER_PAIR / F32_OPS_PER_S,
                (bev.numel() * 4 + v.numel() + words.numel() * 8) / HBM_BYTES_PER_S) * 1e3
    log("K2 rotated_iou_mask", lanes=L, C=Cn, valid_rows=int(v.sum().item()), bits_set=int(over_p.sum().item()),
        differing_bits=n_diff, band=K2_THR_BAND, ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound:.4f}")
    table.append(dict(name="rotated_iou_mask", route="cuda", source="unidistill_torch/csrc/nms.cu",
                      replaces="unidistill_tpu/ops/nms.py:348", launches=launches["rotated_iou_mask"],
                      max_abs_err=iou_abs, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                      bound_by="operations", library_ms=None))
    idx_k, keep_k = nms.nms_greedy_select_cuda(words, v, post)
    idx_p, keep_p = nms.greedy_select_plain(nms.unpack_mask_bits(words), v, post)
    if not (torch.equal(idx_k, idx_p) and torch.equal(keep_k, keep_p)):
        raise RuntimeError("K3 keep sets differ from the plain serial greedy")
    ms = cuda_ms(lambda: nms.nms_greedy_select_cuda(words, v, post))
    unpacked = nms.unpack_mask_bits(words)
    plain_ms = cuda_ms(lambda: nms.greedy_select_plain(unpacked, v, post), iters=3)
    bound = (words.numel() * 8 + v.numel() + idx_k.numel() * 5) / HBM_BYTES_PER_S * 1e3
    log("K3 nms_greedy_select", lanes=L, kept=keep_k.sum(1).tolist(), equal=True,
        ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.6f}")
    table.append(dict(name="nms_greedy_select", route="cuda", source="unidistill_torch/csrc/nms.cu",
                      replaces="unidistill_tpu/ops/nms.py:366", launches=launches["nms_greedy_select"],
                      max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                      bound_by="bytes", library_ms=None))

    # ---- heads and ROIs: kernels vs plain versions on the card ---------------
    # The same weights in bf16 (the served model) and in f32: in bf16 the
    # pool's f32 round-off flips bf16 roundings, and the flips spread through
    # the ~20 bf16 convolutions after it; f32 shows the kernels' own error.
    det32 = Detector(dataclasses.replace(cfg, compute_dtype="float32"), det.model.state_dict(),
                     device="cuda")
    inputs = model_inputs(batch_dev, cfg, dev)
    heads = {}
    for label, model, tol in (("bf16", det.model, HEAD_REL_TOL_BF16), ("f32", det32.model, HEAD_REL_TOL_F32)):
        with torch.no_grad():
            out_k = model(**inputs)
            with PlainVersions():
                out_p = model(**inputs)
        worst = max(
            max_err(out_k["multi_head_features"][tid][name], ref_t)[0]
            / ref_t.abs().max().clamp_min(1e-6).item()
            for tid, hs in enumerate(out_p["multi_head_features"]) for name, ref_t in hs.items())
        e_bev, _ = max_err(out_k["model_output"], out_p["model_output"])
        heads[label] = out_k["multi_head_features"]
        log(f"heads {label}", bev_max_abs_err=f"{e_bev:.3e}",
            bev_max=f"{out_p['model_output'].abs().max().item():.3e}",
            head_max_err_over_range=f"{worst:.3e}", tol=tol)
        if worst > tol:
            raise RuntimeError(f"{label} head tensors differ by {worst:.3e} of their range (> {tol})")
    args = (cfg.proposal, cfg.tasks, cfg.point_cloud_range[:2], cfg.voxel_size[:2], cfg.out_size_factor)
    for label, hs in heads.items():
        rois_k = proposals.generate_proposals(hs, *args)
        with PlainVersions():
            rois_p = proposals.generate_proposals(hs, *args)
        if not (torch.equal(rois_k["mask"], rois_p["mask"]) and torch.equal(rois_k["labels"], rois_p["labels"])
                and torch.equal(rois_k["boxes"], rois_p["boxes"])):
            raise RuntimeError(f"ROIs from the same {label} heads differ between K2/K3 and the plain NMS")
    log("rois", from_same_heads="equal", kept_f32=rois_k["mask"].sum(1).tolist())
    del det32

    # ---- small input: the card against the CPU -----------------------------
    tcfg = dataclasses.replace(tiny_model(with_lidar=False), compute_dtype="float32")
    tbatch = small_batch(tcfg, 2, seed=3)
    det_cpu = Detector(tcfg, random_state_dict(tcfg, seed=2), device="cpu")
    calibrate_batchnorm(det_cpu.model, model_inputs(tbatch, tcfg, "cpu"))
    det_gpu = Detector(tcfg, det_cpu.model.state_dict(), device="cuda")
    with Recorder(lss, "bev_pool_outer") as rec_g, torch.no_grad():
        hg = det_gpu.model(**model_inputs(tbatch, tcfg, dev))
    with Recorder(lss, "bev_pool_outer") as rec_c, torch.no_grad():
        hc = det_cpu.model(**model_inputs(tbatch, tcfg, "cpu"))
    moved = int((rec_g.calls[0][0][0].cpu() != rec_c.calls[0][0][0]).any(-1).sum().item())
    if moved:
        raise RuntimeError(f"tiny detector: {moved} frustum points fall in other cells on the card")
    rel = lambda g, r: max_err(g.cpu(), r)[0] / r.abs().max().clamp_min(1e-6).item()
    bev_rel = rel(hg["model_output"], hc["model_output"])
    head_rel = max(rel(hg["multi_head_features"][tid][name], r)
                   for tid, heads in enumerate(hc["multi_head_features"]) for name, r in heads.items())
    if max(bev_rel, head_rel) > TINY_REL_TOL:
        raise RuntimeError(f"tiny detector: card vs CPU differ by {max(bev_rel, head_rel):.3e} of the range")
    # decode + NMS on the card (K2, K3) and on the CPU (plain) from the same heads
    targs = (tcfg.proposal, tcfg.tasks, tcfg.point_cloud_range[:2], tcfg.voxel_size[:2],
             tcfg.out_size_factor)
    rg = proposals.generate_proposals(hg["multi_head_features"], *targs)
    heads_cpu = [{k: t.cpu() for k, t in h.items()} for h in hg["multi_head_features"]]
    rc = proposals.generate_proposals(heads_cpu, *targs)
    if not (torch.equal(rg["mask"].cpu(), rc["mask"]) and torch.equal(rg["labels"].cpu(), rc["labels"])):
        raise RuntimeError("tiny detector: ROI mask/labels differ between the card and the CPU")
    torch.testing.assert_close(rg["boxes"].cpu(), rc["boxes"], rtol=1e-5, atol=1e-5)
    if not all(torch.isfinite(v.float()).all() for v in rg.values()):
        raise RuntimeError("tiny detector: non-finite ROIs")
    if not (rc["mask"].sum(1) > 0).all():
        raise RuntimeError("tiny detector: a sample kept no boxes")
    log("tiny", bev_err_over_range=f"{bev_rel:.3e}", head_err_over_range=f"{head_rel:.3e}",
        tol=TINY_REL_TOL, rois_from_same_heads="equal", kept=rc["mask"].sum(1).tolist())

    log("done", seconds=f"{time.time() - t_start:.1f}")
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
