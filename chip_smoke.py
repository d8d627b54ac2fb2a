#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written kernels from `unidistill_torch/csrc`, serves the
three full-width detectors through `Detector.predict` at batch 4 (bf16,
seeded random weights, BatchNorm statistics calibrated on the batch) -- the
camera detector (`camera_exp().model`), the LiDAR detector
(`lidar_exp().model`, from nuScenes-like 10-sweep point clouds) and the
fusion detector -- trains each detector and the four distillation pairs,
runs the sparse-conv microbenchmarks at their published sizes, and holds
every kernel of each path against its plain PyTorch version on the inputs
the path gave it.
Phases, each printed on its own line:

  device   card name and power limit (nvidia-smi), torch and CUDA versions
  build    one nvcc per source, all started together; build time
  predict  camera: warm-up request, then timed requests with every launch
           count set to 0 just before and read just after; latency,
           frames/s, peak memory, kept boxes, launches (each kernel must
           launch)
  K1/K2/K3 kernel vs plain version on the recorded main-path inputs: max
           error against the stated tolerance, kernel / plain / library ms;
           K1 (the plan and its reduce) must give bit-identical results on
           two runs, and prints the plan's and the reduce's ms and the
           plan's (cell, ray) runs, occupied cells and longest interval;
           K2 (mask mode) and K3 on the recorded camera lanes, then on
           `synthetic.nms_lanes` "clustered" (40 cars x 12 candidates a
           lane) and "coincident" (every pair clipped): K2's words equal the
           plain mask outside K2_THR_BAND, K3's keep sets equal, reruns
           bit-identical; valid rows, upper pairs, pairs clipped (modelled
           by the plain filter), bits set, rows walked and kept, ms, bounds
           (K2's over the clipped pairs and over every upper pair; K3's by
           bytes, with a model of its serial chain beside it); each ms is
           the kernel's device time from torch.profiler, or by CUDA events
           where the profiler saw none (`ms_source`)
  heads    one request's head tensors, kernels vs plain versions, in bf16
           and in f32; rois: the ROIs from the same heads, K2/K3 vs plain
  tiny     a small float32 camera detector on the card vs the same on the CPU
  lidar predict   as predict, for the LiDAR detector; also points, voxels
           and sites per stage beside the JAX package's fixed-shape caps;
           K4 must launch 21 times a request, K2 and K3 once; then K2 and K3
           on the recorded LiDAR lanes, as for the camera
  K4       each of the 21 recorded sparse convs of one request, K4 vs its
           plain version: max error, kernel / plain / library (one
           `torch.mm` of a prebuilt im2col) / bound ms; the bf16 kernel's
           dense-tile work (active (128-row tile, tap) pairs x 128 x Cin x
           Cout) beside the pairs' work, and its TFLOP/s over the former
  lidar heads, lidar rois, lidar tiny   as heads, rois and tiny, for LiDAR;
           the tiny model's voxel coords and features on the card equal the
           CPU's bit for bit
  distill train   the camera student (`camera_exp().model`, seeded random
           weights) learns from the frozen LiDAR teacher (`lidar_exp()
           .model`, BatchNorm calibrated) on `train_batch(..., B=4)`: one
           warm-up step, then timed steps with every launch count set to 0
           just before and read just after; s/step, frames/s, peak memory,
           the five loss terms (finite), the parameter change (nonzero);
           per step K1 and K5 must launch once and K4 21 times
  camera train    as distill train, for the camera detector's `train_step`
           alone (K1 and K5 once a step, no K4)
  K5       the BEV-pool backward on the g recorded from a distill step,
           kernel vs plain version; two runs must be bit-identical; kernel /
           plain / bound ms, and the g rows read by the ray-owned design
           before (ray runs) and by the column-owned kernel (column reads,
           modelled from its schedule); then the same on the cells of the
           training image augmentation (`K5 train_ida`)
  train tiny      a small float32 camera train step on the card vs the same
           step on the CPU (TF32 off): loss, metrics and every gradient
  lidar train     the LiDAR detector (`lidar_exp().model`, seeded random
           weights) trains with `train_step` on the same frames at the
           train voxel cap, as distill train: s/step, frames/s, peak memory;
           per step K4 must launch 21 times forward and 20 times as the input
           gradient (`sparse_conv_dgrad`, every conv but conv_input), K6 21
           times, K1/K5 never
  K4 sparse_conv_dgrad, K6 sparse_conv_wgrad   each call of one recorded
           LiDAR train step, kernel vs plain version in bf16 and in f32:
           max error, kernel / plain / library (one call on a prebuilt
           gather: `torch.mm` of the [N_in, K*Cout] im2col of g by the
           stacked W^T for dgrad, `torch.bmm` of the [K, Cin, N] rows by g
           for K6) / `torch.mm` per tap / bound ms, summed over the step;
           the dense-tile work and TFLOP/s of the bf16 kernels, as for K4
           (K6's tiles are `k6_tile_rows` rows of the sum); for K6 also the
           chunk count and partial-scratch bytes of its bf16 launch, and a
           rerun in each dtype must be bit-identical
  distill camera->lidar   the LiDAR student from the frozen camera teacher
           (K1 once, K4 21 + 20 dgrad, K6 21 a step)
  lidar train tiny        as train tiny, for a small LiDAR detector
  swin predict    as predict, for the camera detector with the Swin-T image
           backbone (`camera_exp()` with `SWIN_CAMERA_OVERRIDES` of
           `configs.nuscenes`, as `--exp_options` sets them); K1, K2, K3
           once a request (launches_per_request)
  swin tiny       as tiny, for a small float32 Swin camera detector
  swin train      as camera train, for the Swin camera detector (BatchNorms
           tamed as `tame` does); K1 and K5 once a step
  multisweep predict   as predict, for the ResNet camera detector on 2
           sweeps (`nuscenes_batch(..., sweeps=2)`, weights of a 2-sweep
           model): K1 twice a request, K2 and K3 once
  multisweep key block   channel block 0 of the 2-sweep model_output
           against a 1-sweep detector with the same camera encoder on the
           key frame alone, within HEAD_REL_TOL_BF16 (bit_equal printed)
  multisweep train     as camera train on 2 sweeps: K1 twice and K5 once a
           step; then one more forward and backward with a gradient asked
           of the images: the later sweep's must be 0, the key sweep's not
  components scbottleneck, components pillar_vfe, components roiaware_pool3d
           [cells|max|avg]   the leaf modules on the card against the CPU in
           float32: `SCBottleneck` (planes 256, [4, 256, 180, 180], train
           mode: output and running statistics), `PillarVFE` (train mode) on
           the 0.075 x 0.075 x 8 m pillars of a 10-sweep `lidar_batch` frame
           and `pointpillar_scatter` of its output (card = CPU bit for bit),
           `roiaware_pool3d` (100 boxes on the frame's points, axis-aligned
           and then rotated, 14 x 14 x 14 cells, the points' 5 values as
           features) with gradients: first the (point, cell) pairs of both
           devices (axis-aligned: equal; rotated: a pair that differs lies
           within ROI_FACE_M of a cell's face, and its cells and their
           points are left out below), then errors over max |ref| against
           COMPONENT_REL_TOL and ROI_TOL (the max pool's output bit for
           bit); the card's ms
  fusion predict  as predict, for the fusion detector (`fusion_exp().model`,
           both encoders): K1 once, K4 21 times, K2 and K3 once a request
  fusion train, distill fusion->lidar, distill fusion->camera   as distill
           train
  microbench      the sparse-conv microbenchmarks' entry points with every
           launch count set to 0 just before and read just after:
           `mb_pallas_fused` smoke (K8), `mb_gather_pallas` (index_select,
           K9 unroll 1 and 4, K10, K11 at S 65536, W 640, R 2048, band
           4096) and `mb_pallas_fused` one <s2, s0, s3> <prod, fused> on
           four realistic frames planned once (the planner's seconds
           printed); each of K7-K11 must launch
  K8 smoke, K9 fori, K9 fori4, K10 take, K11 onehot   each kernel against
           its plain version on the same inputs, bit for bit, and on a
           rerun (each output in a block of the pool just filled with NaN,
           `harness.poisoned_call`, so that values a kernel leaves
           unwritten cannot hold an earlier call's answer); kernel /
           plain / library (`torch.add`, `index_select`) / bound ms, the
           time's share of the bound (`bound_share`) and its ratio to the
           library call's (`ms_over_library`), the
           kernel's and the library call's ms their device time from
           torch.profiler (`ms_source`, `library_ms_source`; "profiler:N/M"
           where the profile kept N of its M kernel records: the mean over
           the N, `harness.device_ms`) with back-to-back CUDA events beside
           them (`events_ms`); K8 also prints its kernel's grid, block,
           registers and values a thread from a profiler trace beside
           `torch.add`'s (`library_*`); K11 also
           prints the products it runs (modelled by `onehot_slabs_plain`,
           per n8 tile) beside the dense product's, its bound over the
           products it runs and the dense product's (`dense_ops_ms`)
  K7 fused_offsets   on each stage's realistic inputs (the rows the fused
           conv gathers), against its plain version at 1e-4 of max |ref|,
           its output in a NaN-filled block, two runs bit-identical; ms
           the kernel's device time (`ms_source`, CUDA events beside),
           plain / library (bf16 `where` select + `einsum`) / bound ms
           (`ops.fused_offsets.k7_work`: the lanes each case needs),
           `bound_share`, `ms_over_library`, the launch's grid, block,
           registers and shared bytes from a profiler trace (persistent:
           at most one block a tile of K7_TILE_ROWS sites) and W8's
           modelled L2 bytes; the kernels line carries s2
  subm prod vs fused   ms/conv of both paths per stage and their max |diff|
           (within 2e-2 of max |prod|)
  export camera, export lidar, export fusion, export lidar host_voxels
           each detector at full width, batch 4 (seeded weights, BatchNorm
           calibrated) exported on the card with
           `serving.export.export_detector` ("points" mode; the LiDAR
           detector also "host_voxels") into a temporary directory; a fresh
           process (`chip_smoke.py load-artifacts`, which imports
           `serving.export` and nothing of models, layers or training, and
           says so) loads each artifact and predicts on two batches whose
           LiDAR stages hold other site counts; masks and labels must equal
           the live `Detector.predict`'s, boxes and scores within
           EXPORT_TOL_OF_MAX, and the loaded process must launch K1-K4 as
           often a request as the live detector. Prints export s, artifact
           MB, load s, the loaded program's median latency (on device
           inputs) against the live request's, `predict`'s with numpy in
           and out, launches, sites per stage and bit_equal
  launch path  each custom op `unidistill::*` against a direct call of its
           bare ctypes wrapper on the export phases' recorded request
           arguments (K1-K4) and their gradients' shapes (K5, K4 dgrad,
           K6): host us a call (median, the card idle before each call,
           rounds op, bare, bare, op), device ms of both from
           torch.profiler, results bit-equal
  flops    `utils.flops.model_flops_per_frame` of the three eval forwards
           (batch 4) and `matmul_flops` of one camera<-LiDAR distill step,
           a frame, with the JAX package's pins beside them
  cli distill lidar->camera   the launchers' CLIs at full width, in a
           temporary directory: `serving.synthetic.write_nuscenes` writes an
           on-disk nuScenes (12 training and 4 validation frames, six
           900x1600 JPEGs and 10 LiDAR sweeps each, GT boxes of the ray-cast
           scenes); a seeded LiDAR teacher, BatchNorm calibrated on the
           validation frames, is saved with `checkpoint.save_checkpoint`;
           then `run_distill_cli("lidar", "camera")` trains one epoch (batch
           4, 4 spawned loader workers, CBGS off), resumes to a second epoch
           (validation at its end), and `run_cli(camera_exp())` evaluates the
           checkpoint (-e, the native scorer), each run with every launch
           count set to 0 just before and read just after. Checks: K4 21
           times and K1, K5 once a train step, K1, K2, K3 in validation and
           -e; finite losses; the student changed and the teacher did not;
           the resumed run trained only the second epoch; the last
           checkpoint equals the trained model bit for bit; mAP, NDS and the
           five TP errors finite; no loader worker left; no file written
           under the repository. Prints s/step and the loader wait a step
           from metrics.jsonl, and the phase's wall seconds
  ddp distill lidar->camera   two ranks on the one card in a gloo world
           (`parallel.launch.run_ranks`; NCCL takes one rank a card), each
           with its 2 rows of the distill train batch (global 4), through
           the `Trainer`'s data-parallel step: the camera student
           (`distill_exp` seeded weights) from distill train's calibrated
           teacher; one warm-up step, then TIMED_STEPS timed steps with every
           launch count set to 0 just before and read just after, on each
           rank. Checks: after every step both ranks hold the same parameters
           bit for bit; rank 0's loss is the mean of the ranks' totals
           (DDP_LOSS_RTOL); each rank launched K1 and K5 once and K4 21 times
           a step; finite metrics; the teacher untrained. Prints s/step
           (rank 0's clock), global frames/s, each rank's peak memory and
           launches, the five loss terms, each rank's totals and the wall
           seconds
  ddp tiny a small float32 camera<-LiDAR distill step over the same two
           ranks (BatchNorms tamed), on the card (TF32 off) against the same
           two-rank step on the CPU: metrics rtol 1e-3, the averaged
           gradients within 5e-3 of their scale, the parameters' change
           within 1e-2 lr (2 lr where |g| is below 1e-3 of its scale)
  ddp nccl two tiny distill steps through a `Trainer` that makes an NCCL
           group of one rank from `torchrun`'s environment
           (`parallel.mesh.init_from_env`), against the same steps with no
           group: bit for bit where two runs with no group are, else within
           DDP_NCCL_SPREAD times their difference; the trainer destroys its
           group at `close`

Any failed phase raises, so the script exits non-zero. The last three lines
are the kernel table (JSON, K1-K11, K7's row at s2; K4's ms, plain_ms,
library_ms and bound_ms are sums over the 21 convs of one request, K4
dgrad's and K6's over the 20 and 21 calls of one LiDAR train step; K5's
launches are those of the timed distill steps, K4 dgrad's and K6's those
of the timed LiDAR train steps, K7-K11's those of the microbenchmarks),
the card's name and power limit, and {"ok": true, "device": {...}}. nvcc's
register report goes to build/unidistill_torch/nvcc.log.
"""
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BATCH = 4
TIMED_REQUESTS = 3
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory (NVIDIA data sheet)
F32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12      # H100 SXM bf16 tensor cores, dense
# float operations per rotated-IoU pair, counted from csrc/nms.cu: 8 edge
# clips x (4 planes x 14 + 13 tail) + 6 for the IoU
IOU_OPS_PER_PAIR = 8 * (4 * 14 + 13) + 6
# a model of K3's serial chain, printed beside its bound and not part of it
# (no latency is measured here): a row walked is three dependent integer
# operations (bit test, select, OR), taken as 12 SM cycles, at the card's
# maximum SM clock (nvidia-smi)
K3_CHAIN_CYCLES_MODEL = 12
# tolerances, with their reasons
# K1 sums (sum of a ray's depths) x context per (cell, ray) run in a fixed
# order; its plain version sums depth x context with index_add_'s atomics
K1_TOL = dict(rtol=1e-4, atol=1e-4)
K2_TOL = dict(rtol=1e-4, atol=1e-5)  # same float math; libm cos/sin may differ by an ulp
# heads, kernels vs plain, as max |diff| over max |ref|: in f32 the pool's
# summation order only; in bf16 that round-off flips bf16 roundings (2^-8)
# which spread through the convolutions after the pool (3e-2 seen on the H100)
HEAD_REL_TOL_F32 = 1e-3
HEAD_REL_TOL_BF16 = 1e-1
# the LiDAR detector runs 21 bf16 sparse convs before the ~20 dense ones;
# one-ulp flips between K4 and its plain version (both round once, after
# f32 sums in another order) spread through all of them (9.1e-2 seen on the
# H100 with these weights and clouds; 2e-5 in f32)
LIDAR_HEAD_REL_TOL_BF16 = 2.5e-1
# card vs CPU in f32 with TF32 off, as max |diff| over max |ref|: cuDNN's
# f32 convolution algorithms round otherwise than the CPU's direct sums, over
# ~80 convolutions (7.9e-4 seen on the H100; the kernels add ~1e-5)
TINY_REL_TOL = 5e-3
# K4 in bf16 against its plain version: both sum in f32 and round once; the
# other summation order may flip that rounding by one bf16 ulp (at most 2^-7
# of the value), and near a cancellation the f32 orders differ by ~1e-6 of
# the terms' scale
K4_TOL_RTOL = 1e-2
K4_TOL_ATOL_OF_MAX = 1e-4
SPARSE_CONVS_PER_REQUEST = 21
SPARSE_CONV_DGRADS_PER_STEP = 20  # every sparse conv but conv_input, whose input needs no gradient
TIMED_STEPS = 3
# the sparse conv's backward kernels against their plain versions on the
# tensors of one LiDAR train step, as (rtol, atol over max |ref|): K4 as the
# input gradient as K4 (in bf16 both round once after f32 sums in another
# order, a one-ulp flip is 2^-7 of a value; in f32 only the order differs);
# K6 sums exact products (bf16 x bf16 fits f32) in f32 in another order
K4_DGRAD_TOL = {torch.bfloat16: (1e-2, 1e-4), torch.float32: (1e-4, 1e-4)}
K6_TOL = (1e-4, 1e-4)
# the microbenchmark kernels: K7 against its plain version, as max |diff|
# over max |ref| (exact bf16 products summed in f32 in another order); the
# fused conv against the separate path, as max |diff| over max |prod| (the
# separate path rounds each of its 8 offset sums to bf16, the fused one only
# the total); K8-K11 bit for bit
K7_TOL_OF_MAX = 1e-4
FUSED_VS_PROD_TOL_OF_MAX = 2e-2
MB_STAGES = ("s2", "s0", "s3")
# K5 against its plain version, both divided by max |ref|: no atomics, the
# channel dot products and depth sums are float32 sums in another order
K5_TOL = dict(rtol=1e-5, atol=1e-5)
# the tiny train step, card vs CPU in f32 with TF32 off: loss and metrics
# rtol 1e-3, every gradient within 5e-3 of its scale (max |g| of the tensor,
# at least 1e-3 of the largest |g|); cuDNN's f32 convolution algorithms round
# otherwise than the CPU's, and train-mode BatchNorm carries that through
# ~70 layers (the CPU test against JAX holds 2e-3 with the same weights)
TRAIN_TINY_LOSS_RTOL = 1e-3
TRAIN_TINY_GRAD_TOL = 5e-3
# the launcher phase's on-disk synthetic nuScenes: 12 training frames (three
# steps of batch 4 an epoch; CBGS off, since on a 12-frame set of two classes
# it keeps 4 frames) and 4 validation frames, loaded by 4 worker processes
CLI_TRAIN_FRAMES = 12
CLI_VAL_FRAMES = 4
CLI_WORKERS = 4
# the data-parallel phases: two ranks on the one card in a gloo world (NCCL
# takes one rank a card; gloo all-reduces and broadcasts CUDA tensors
# through the host), BATCH // DDP_RANKS frames a rank of each global batch
DDP_RANKS = 2
DDP_RANK_BATCH = BATCH // DDP_RANKS
# seconds the spawned world may take, joining included, before its ranks are
# killed and the run fails
DDP_TIMEOUT_S = 420
# rank 0's loss against the mean of the ranks' totals: the step sums the
# terms in float32, the check again in float64 on the host
DDP_LOSS_RTOL = 1e-6
# [ddp nccl] against the steps with no group: bit for bit where two runs
# with no group are; else within this multiple of their difference (the
# backward of grid_sample and of the losses' gathers adds with atomics)
DDP_NCCL_SPREAD = 4.0
# the export phases: calls timed for the loaded and the live latency
# (medians), the loading process's time limit, and the loaded artifact's
# boxes and scores against the live detector's, as max |diff| over max(1,
# max |ref|): the same kernels and aten ops run (cuDNN benchmarking off, eval
# BatchNorm without cuDNN in both), so equal bits are expected; the
# tolerance would admit an ulp of f32 at the boxes' scale
EXPORT_LATENCY_CALLS = 10
EXPORT_BATCH_SEEDS = (50, 150)
EXPORT_LOAD_TIMEOUT_S = 600
EXPORT_TOL_OF_MAX = 1e-6
# [launch path]: host calls timed a round
LAUNCH_PATH_CALLS = 30
# the multi-sweep phases: the key frame and one earlier sweep
SWEEPS = 2
# [components]: card vs CPU in float32 (TF32 off) as max |diff| over max
# |ref|, outputs and running statistics: cuDNN's convolution algorithms and
# the GEMMs round otherwise than the CPU's over a few layers (the tiny
# detectors, ~80 layers, stay within 5e-3); the max pool and its gradient
# route the same values (0); the avg pool sums with atomics on the card, in
# no fixed order (float32 sums of at most a few thousand terms); a point in
# several boxes sums its gradients from each in no fixed order, on either
# device (7.8e-8 of the range seen on the H100 for the max pool, 7.6e-8
# between two CPU runs)
COMPONENT_REL_TOL = 1e-3
ROI_TOL = {"max": (0.0, 1e-6), "avg": (1e-5, 1e-5)}  # (output, gradient)
# pillars of 0.075 x 0.075 x 8 m (the LiDAR grid's cell, one cell high), at
# most 20 points each; 100 ROI boxes of 14 x 14 x 14 cells
PILLAR_SIZE = (0.075, 0.075, 8.0)
PILLAR_MAX_POINTS = 20
ROI_BOXES = 100
ROI_CELLS = 14
# a rotated box's point may change ROI cells on the card only within this
# distance of a cell's face (float32 rounding of its coordinates in the
# box frame is ~1e-6 m at 50 m; a cell is >= 0.107 m)
ROI_FACE_M = 1e-4
# the JAX package's eval-forward pins a frame (tests/test_flops.py), beside
# the port's counts as a sanity note
JAX_FLOPS_PINS = {"camera": 0.650e12, "lidar": 2.083e12, "fusion": 2.354e12}


def log(phase, **kv):
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in kv.items()), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def sm_clock_hz():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(out.stdout.strip().splitlines()[0]) * 1e6


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
    """Wraps a module-level function and keeps the arguments and results of
    its calls."""

    def __init__(self, module, name):
        self.module, self.name, self.fn = module, name, getattr(module, name)
        self.calls, self.results = [], []

    def __enter__(self):
        def wrapped(*args, **kwargs):
            self.calls.append((args, kwargs))
            self.results.append(self.fn(*args, **kwargs))
            return self.results[-1]
        setattr(self.module, self.name, wrapped)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


class PlainVersions:
    """Routes the main path through the kernels' plain PyTorch versions (on
    the card) while active; used only to build the comparison reference."""

    def __enter__(self):
        from unidistill_torch.decode import proposals
        from unidistill_torch.layers import lidar_encoder, lss
        from unidistill_torch.ops import bev_pool, nms, sparse_conv
        self.saved = [(lss, "bev_pool_outer", lss.bev_pool_outer),
                      (proposals, "nms_bev_batched", proposals.nms_bev_batched),
                      (lidar_encoder, "sparse_conv", lidar_encoder.sparse_conv)]
        lss.bev_pool_outer = bev_pool.bev_pool_outer_plain
        proposals.nms_bev_batched = nms.nms_bev_batched_plain
        lidar_encoder.sparse_conv = lambda f, nbr, w, b=None, nbr_t=None: sparse_conv.sparse_conv_plain(f, nbr, w, b)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def max_err(got, ref):
    d = (got.float() - ref.float()).abs()
    return d.max().item(), (d / ref.float().abs().clamp_min(1e-6)).max().item()


def pool_plan_stats(order, offsets, D):
    """A K1 plan's (cell, ray) runs (one context row read each), occupied
    (sample, cell) rows and longest interval."""
    n_in = int(offsets[-1].item())
    sizes = offsets.diff()
    row = torch.searchsorted(offsets, torch.arange(n_in, device=order.device), right=True)
    ray = order[:n_in] // D
    new_run = torch.ones(n_in, dtype=torch.bool, device=order.device)
    new_run[1:] = (row[1:] != row[:-1]) | (ray[1:] != ray[:-1])
    return int(new_run.sum().item()), int((sizes > 0).sum().item()), int(sizes.max().item())


def tile_work(nbr, n_in, cin, cout, T):
    """The work a bf16 sparse-conv kernel with T-row tiles does on a map, as
    float operations: every row of a tile runs the product of every tap that
    any row of the tile reads (dense tiles), against what the pairs need;
    K4's tiles (K4_TILE_ROWS) are output rows of the conv, K6's
    (`k6_tile_rows`) the rows it sums over. Cin is padded to 16 as the
    wrappers pad it. Returns (active (tile, tap) pairs, dense-tile flops,
    pair flops)."""
    ok = (nbr >= 0) & (nbr < n_in)
    ok = torch.cat([ok, ok.new_zeros(-ok.shape[0] % T, ok.shape[1])])
    tile_taps = int(ok.reshape(-1, T, ok.shape[1]).any(1).sum().item())
    cin_p = cin + -cin % 16
    return tile_taps, 2 * tile_taps * T * cin_p * cout, 2 * int(ok.sum().item()) * cin * cout


def serve(phase, det, cfg, batch_dev, recorders, want):
    """One warm-up request with `recorders` on, then the timed requests,
    with every launch count set to 0 just before and read just after; each
    kernel in `want` must have launched exactly that often. Checks the
    ROIs."""
    from unidistill_torch.kernels import build
    with contextlib.ExitStack() as stack:
        for r in recorders:
            stack.enter_context(r)
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
    log(phase, batch=BATCH, requests=TIMED_REQUESTS,
        latency_ms=[round(x * 1e3, 3) for x in lat],
        frames_per_s=f"{BATCH * len(lat) / sum(lat):.3f}", peak_mem_gib=f"{peak_gib:.3f}",
        kept_boxes=kept, launches=json.dumps(launches, sort_keys=True))
    for k, n in want.items():
        if launches.get(k, 0) != n:
            raise RuntimeError(f"kernel {k} launched {launches.get(k, 0)} times in "
                               f"{TIMED_REQUESTS} requests, expected {n}")
    R = len(cfg.tasks) * cfg.proposal.nms_post_max_size_test
    for k, v in rois.items():
        if tuple(v.shape[:2]) != (BATCH, R):
            raise RuntimeError(f"rois[{k}] has shape {tuple(v.shape)}")
    if not torch.isfinite(rois["boxes"]).all() or not torch.isfinite(rois["scores"]).all():
        raise RuntimeError("non-finite ROI values")
    if not all(k > 0 for k in kept):
        raise RuntimeError(f"a sample kept no boxes: {kept}")
    if not torch.equal(warm["mask"], rois["mask"]):
        print(f"[{phase}] note: kept masks differ between requests (atomic sum order)")


def compare_heads(prefix, det, cfg, inputs, bf16_tol=HEAD_REL_TOL_BF16):
    """One request's heads with the kernels against the plain versions, in
    bf16 (the served model) and in f32 (the kernels' own error); then the
    ROIs decoded from the same heads with K2/K3 and with the plain NMS."""
    from unidistill_torch.decode import proposals
    from unidistill_torch.serving.predictor import Detector
    det32 = Detector(dataclasses.replace(cfg, compute_dtype="float32"), det.model.state_dict(),
                     device="cuda")
    heads = {}
    for label, model, tol in (("bf16", det.model, bf16_tol), ("f32", det32.model, HEAD_REL_TOL_F32)):
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
        log(f"{prefix}heads {label}", bev_max_abs_err=f"{e_bev:.3e}",
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
    log(f"{prefix}rois", from_same_heads="equal", kept_f32=rois_k["mask"].sum(1).tolist())


def card_vs_cpu(phase, tcfg, hg, hc):
    """A small f32 detector's outputs on the card (hg) against the CPU (hc);
    then decode + NMS on the card (K2, K3) and on the CPU (plain) from the
    same heads."""
    from unidistill_torch.decode import proposals
    rel = lambda g, r: max_err(g.cpu(), r)[0] / r.abs().max().clamp_min(1e-6).item()
    bev_rel = rel(hg["model_output"], hc["model_output"])
    head_rel = max(rel(hg["multi_head_features"][tid][name], r)
                   for tid, heads in enumerate(hc["multi_head_features"]) for name, r in heads.items())
    if max(bev_rel, head_rel) > TINY_REL_TOL:
        raise RuntimeError(f"{phase}: card vs CPU differ by {max(bev_rel, head_rel):.3e} of the range")
    targs = (tcfg.proposal, tcfg.tasks, tcfg.point_cloud_range[:2], tcfg.voxel_size[:2],
             tcfg.out_size_factor)
    rg = proposals.generate_proposals(hg["multi_head_features"], *targs)
    heads_cpu = [{k: t.cpu() for k, t in h.items()} for h in hg["multi_head_features"]]
    rc = proposals.generate_proposals(heads_cpu, *targs)
    if not (torch.equal(rg["mask"].cpu(), rc["mask"]) and torch.equal(rg["labels"].cpu(), rc["labels"])):
        raise RuntimeError(f"{phase}: ROI mask/labels differ between the card and the CPU")
    torch.testing.assert_close(rg["boxes"].cpu(), rc["boxes"], rtol=1e-5, atol=1e-5)
    if not all(torch.isfinite(v.float()).all() for v in rg.values()):
        raise RuntimeError(f"{phase}: non-finite ROIs")
    if not (rc["mask"].sum(1) > 0).all():
        raise RuntimeError(f"{phase}: a sample kept no boxes")
    log(phase, bev_err_over_range=f"{bev_rel:.3e}", head_err_over_range=f"{head_rel:.3e}",
        tol=TINY_REL_TOL, rois_from_same_heads="equal", kept=rc["mask"].sum(1).tolist())


def nms_checks(label, bev, v, thr, post):
    """K2 (mask mode) and K3 on one set of lanes against their plain
    versions: K2's words bit for bit outside K2_THR_BAND of thr, K3's keep
    sets equal, each bit-identical on a rerun. Prints the pairs K2 clips
    (modelled by the plain filter, `pairs_to_clip_plain`), the bits set,
    the rows K3 walks and keeps, each kernel's ms and bound, K2's bound if
    every upper pair were clipped and K3's modelled serial chain. A
    kernel's ms is its device time from torch.profiler, or, where three
    profiles recorded none, the mean of back-to-back launches by CUDA
    events (host work included); `ms_source` says which. Returns the two
    kernels' table fields."""
    from unidistill_torch.experiments.harness import device_ms
    from unidistill_torch.ops import nms
    L, C = v.shape
    words = nms.rotated_iou_mask_cuda(bev, v, thr)
    again = nms.rotated_iou_mask_cuda(bev, v, thr)
    iou_p = nms.rotated_iou_bev_plain(bev, bev)
    over_p = nms.iou_over_plain(bev, v, thr)
    diff = nms.unpack_mask_bits(words) ^ over_p
    n_diff = int(diff.sum().item())
    if not torch.equal(words, again):
        raise RuntimeError(f"K2 {label}: two runs on the same inputs are not bit-identical")
    if n_diff and not ((iou_p - thr).abs()[diff] < nms.K2_THR_BAND).all():
        raise RuntimeError(f"K2 {label}: mask differs from the plain version at {n_diff} bits off the threshold band")
    del iou_p, diff
    tri = torch.ones(C, C, dtype=torch.bool, device=v.device).triu(1)
    upper = int((tri[None] & v[:, None, :]).sum().item())
    clipped = int(nms.pairs_to_clip_plain(bev, v, thr).sum().item())
    ms, source, events_ms = device_ms(lambda: nms.rotated_iou_mask_cuda(bev, v, thr), "iou_mask_kernel")
    plain_ms = cuda_ms(lambda: nms.pack_mask_bits(nms.iou_over_plain(bev, v, thr)), iters=3)
    io_s = (bev.numel() * 4 + v.numel() + words.numel() * 8) / HBM_BYTES_PER_S
    ops_s = clipped * IOU_OPS_PER_PAIR / F32_OPS_PER_S
    bound, bound_all = max(io_s, ops_s) * 1e3, max(io_s, L * C * (C - 1) // 2 * IOU_OPS_PER_PAIR / F32_OPS_PER_S) * 1e3
    log(f"K2 rotated_iou_mask {label}", lanes=L, C=C, valid_rows=int(v.sum().item()), upper_pairs=upper,
        pairs_clipped_modelled=clipped, bits_set=int(over_p.sum().item()), differing_bits=n_diff,
        band=nms.K2_THR_BAND, bit_identical="true", ms=f"{ms:.5f}", ms_source=source,
        events_ms=f"{events_ms:.5f}", plain_ms=f"{plain_ms:.4f}",
        bound_ms=f"{bound:.5f}", bound_all_pairs_ms=f"{bound_all:.5f}")
    k2 = dict(ms=ms, ms_source=source, plain_ms=plain_ms, bound_ms=bound,
              bound_by="operations" if ops_s >= io_s else "bytes")

    idx_k, keep_k = nms.nms_greedy_select_cuda(words, v, post)
    idx_2, keep_2 = nms.nms_greedy_select_cuda(words, v, post)
    unpacked = nms.unpack_mask_bits(words)
    idx_p, keep_p = nms.greedy_select_plain(unpacked, v, post)
    if not (torch.equal(idx_k, idx_p) and torch.equal(keep_k, keep_p)):
        raise RuntimeError(f"K3 {label}: keep sets differ from the plain serial greedy")
    if not (torch.equal(idx_k, idx_2) and torch.equal(keep_k, keep_2)):
        raise RuntimeError(f"K3 {label}: two runs on the same inputs are not bit-identical")
    ms, source, events_ms = device_ms(lambda: nms.nms_greedy_select_cuda(words, v, post), "greedy_kernel")
    plain_ms = cuda_ms(lambda: nms.greedy_select_plain(unpacked, v, post), iters=3)
    kept = keep_p.sum(1)
    # the greedy walks a lane's rows up to its post-th kept row (all C if fewer)
    walked = torch.where(kept == post, idx_p[:, -1].long() + 1, torch.full_like(kept, C))
    kept_rows = idx_p.long()[keep_p]
    k3_bytes = int(((C // 64 - kept_rows // 64) * 8).sum().item()) + v.numel() + idx_k.numel() * 5
    bound = k3_bytes / HBM_BYTES_PER_S * 1e3  # its integer operations take far less at any peak
    chain_model_ms = int(walked.max().item()) * K3_CHAIN_CYCLES_MODEL / sm_clock_hz() * 1e3
    log(f"K3 nms_greedy_select {label}", lanes=L, rows_walked_max=int(walked.max().item()),
        rows_walked_total=int(walked.sum().item()), kept_total=int(kept.sum().item()),
        kept_min=int(kept.min().item()), equal=True, bit_identical="true", ms=f"{ms:.5f}", ms_source=source,
        events_ms=f"{events_ms:.5f}", plain_ms=f"{plain_ms:.4f}", bound_ms=f"{bound:.6f}", bound_by="bytes",
        chain_model_ms=f"{chain_model_ms:.6f}")
    k3 = dict(ms=ms, ms_source=source, plain_ms=plain_ms, bound_ms=bound, bound_by="bytes")
    return k2, k3


def camera_phases(dev, table) -> None:
    """The camera detector's path: predict, K1-K3, heads, rois, tiny."""
    from unidistill_torch.configs.nuscenes import camera_exp, tiny_model
    from unidistill_torch.decode import proposals
    from unidistill_torch.kernels import build
    from unidistill_torch.layers import lss
    from unidistill_torch.ops import bev_pool, nms
    from unidistill_torch.serving.predictor import Detector
    from unidistill_torch.serving.synthetic import (
        calibrate_batchnorm, nms_lanes, nuscenes_batch, random_state_dict, small_batch)
    from unidistill_torch.training.steps import model_inputs

    # ---- full-width predict ------------------------------------------------
    cfg = camera_exp().model
    sd = random_state_dict(cfg, seed=0)
    det = Detector(cfg, sd, device="cuda")
    batch = nuscenes_batch(cfg, BATCH, seed=1)
    batch_dev = {"imgs": torch.from_numpy(batch["imgs"]).to(dev),
                 "mats": {k: torch.from_numpy(v).to(dev) for k, v in batch["mats"].items()}}
    calibrate_batchnorm(det.model, model_inputs(batch_dev, cfg, dev, training=False))
    pool_rec, nms_rec = Recorder(lss, "bev_pool_outer"), Recorder(proposals, "nms_bev_batched")
    serve("predict", det, cfg, batch_dev, [pool_rec, nms_rec],
          dict(bev_pool_fwd=TIMED_REQUESTS, rotated_iou_mask=TIMED_REQUESTS,
               nms_greedy_select=TIMED_REQUESTS))
    launches = dict(build.LAUNCHES)

    # ---- K1 ------------------------------------------------------------------
    (geom_idx, depth, context, voxel_num), _ = pool_rec.calls[0]
    nx, ny, nz = voxel_num
    ncells = nx * ny
    cell = bev_pool._linear_index(geom_idx, nx, ny, nz).to(torch.int32).contiguous()
    depth, context = depth.float().contiguous(), context.float().contiguous()
    got = bev_pool.bev_pool_cells_cuda(cell, depth, context, ncells)
    again = bev_pool.bev_pool_cells_cuda(cell, depth, context, ncells)
    ref = bev_pool.bev_pool_outer_plain(geom_idx, depth, context, voxel_num)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise RuntimeError("K1: two runs on the same inputs are not bit-identical")
    got = got.reshape(BATCH, ny, nx, -1)
    abs_e, rel_e = max_err(got, ref)
    torch.testing.assert_close(got, ref, **K1_TOL)
    del again
    ms = cuda_ms(lambda: bev_pool.bev_pool_cells_cuda(cell, depth, context, ncells))
    order, offsets = bev_pool.bev_pool_plan(cell, ncells)
    plan_ms = cuda_ms(lambda: bev_pool.bev_pool_plan(cell, ncells))
    reduce_ms = cuda_ms(lambda: bev_pool.bev_pool_intervals_cuda(order, offsets, depth, context))
    runs, occupied, max_interval = pool_plan_stats(order, offsets, depth.shape[2])
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
        max_rel_err=f"{rel_e:.3e}", tol=K1_TOL, bit_identical="true", ms=f"{ms:.4f}",
        plan_ms=f"{plan_ms:.4f}", reduce_ms=f"{reduce_ms:.4f}", runs=runs, occupied_cells=occupied,
        cells=BATCH * ncells, max_interval=max_interval, plain_ms=f"{plain_ms:.4f}",
        library_ms=f"{library_ms:.4f}", bound_ms=f"{bound:.4f}")
    table.append(dict(name="bev_pool_fwd", route="cuda", source="unidistill_torch/csrc/bev_pool.cu",
                      replaces="unidistill_tpu/ops/bev_pool.py:158", launches=launches["bev_pool_fwd"],
                      max_abs_err=abs_e, ms=ms, plain_ms=plain_ms, bound_ms=bound,
                      bound_by="bytes" if k1_bytes / HBM_BYTES_PER_S >= k1_ops / F32_OPS_PER_S else "operations",
                      library_ms=library_ms))

    # ---- K2 / K3 -------------------------------------------------------------
    (boxes, valid, thr, post), kw = nms_rec.calls[0]
    bev, v = nms._candidate_lanes(boxes, valid, post, kw.get("cap", 512))
    iou_k = nms.rotated_iou_cuda(bev, bev)
    iou_p = nms.rotated_iou_bev_plain(bev, bev)
    iou_abs, iou_rel = max_err(iou_k, iou_p)
    torch.testing.assert_close(iou_k, iou_p, **K2_TOL)
    log("K2 rotated_iou float mode", lanes=v.shape[0], C=v.shape[1], max_abs_err=f"{iou_abs:.3e}",
        max_rel_err=f"{iou_rel:.3e}", tol=K2_TOL, ms=f"{cuda_ms(lambda: nms.rotated_iou_cuda(bev, bev)):.4f}")
    k2, k3 = nms_checks("camera", bev, v, thr, post)
    table.append(dict(name="rotated_iou_mask", route="cuda", source="unidistill_torch/csrc/nms.cu",
                      replaces="unidistill_tpu/ops/nms.py:348", launches=launches["rotated_iou_mask"],
                      max_abs_err=iou_abs, library_ms=None, **k2))
    table.append(dict(name="nms_greedy_select", route="cuda", source="unidistill_torch/csrc/nms.cu",
                      replaces="unidistill_tpu/ops/nms.py:366", launches=launches["nms_greedy_select"],
                      max_abs_err=0.0, library_ms=None, **k3))
    for kind in ("clustered", "coincident"):
        lanes, ok = nms_lanes(kind, seed=0)
        nms_checks(kind, torch.from_numpy(lanes).to(dev), torch.from_numpy(ok).to(dev), thr, post)

    # ---- heads and ROIs: kernels vs plain versions on the card ---------------
    # in bf16 the pool's f32 round-off flips bf16 roundings, and the flips
    # spread through the ~20 bf16 convolutions after it
    compare_heads("", det, cfg, model_inputs(batch_dev, cfg, dev, training=False))

    # ---- small input: the card against the CPU -----------------------------
    tcfg = dataclasses.replace(tiny_model(with_lidar=False), compute_dtype="float32")
    tbatch = small_batch(tcfg, 2, seed=3)
    det_cpu = Detector(tcfg, random_state_dict(tcfg, seed=2), device="cpu")
    calibrate_batchnorm(det_cpu.model, model_inputs(tbatch, tcfg, "cpu", training=False))
    det_gpu = Detector(tcfg, det_cpu.model.state_dict(), device="cuda")
    with Recorder(lss, "bev_pool_outer") as rec_g, torch.no_grad():
        hg = det_gpu.model(**model_inputs(tbatch, tcfg, dev, training=False))
    with Recorder(lss, "bev_pool_outer") as rec_c, torch.no_grad():
        hc = det_cpu.model(**model_inputs(tbatch, tcfg, "cpu", training=False))
    moved = int((rec_g.calls[0][0][0].cpu() != rec_c.calls[0][0][0]).any(-1).sum().item())
    if moved:
        raise RuntimeError(f"tiny detector: {moved} frustum points fall in other cells on the card")
    card_vs_cpu("tiny", tcfg, hg, hc)


def lidar_phases(dev, table) -> None:
    """The LiDAR detector's path: predict, sites per stage, K4, heads, rois,
    tiny."""
    from unidistill_torch.configs.nuscenes import lidar_exp, tiny_model
    from unidistill_torch.decode import proposals
    from unidistill_torch.kernels import build
    from unidistill_torch.layers import lidar_encoder
    from unidistill_torch.ops import nms, sparse_conv
    from unidistill_torch.serving.predictor import Detector
    from unidistill_torch.serving.synthetic import calibrate_batchnorm, lidar_batch, random_state_dict
    from unidistill_torch.training.steps import model_inputs

    # ---- full-width predict from raw points --------------------------------
    cfg = lidar_exp().model
    det = Detector(cfg, random_state_dict(cfg, seed=10), device="cuda")
    t0 = time.time()
    batch = lidar_batch(cfg, BATCH, seed=11)
    cloud_s = time.time() - t0
    batch_dev = {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}
    calibrate_batchnorm(det.model, model_inputs(batch_dev, cfg, dev, training=False))
    conv_rec = Recorder(lidar_encoder, "sparse_conv")
    rb_rec = Recorder(lidar_encoder, "build_rulebooks")
    nms_rec = Recorder(proposals, "nms_bev_batched")
    log("lidar cloud", points=batch["points_mask"].sum(1).tolist(), seconds=f"{cloud_s:.2f}")
    serve("lidar predict", det, cfg, batch_dev, [conv_rec, rb_rec, nms_rec],
          dict(sparse_conv_fwd=SPARSE_CONVS_PER_REQUEST * TIMED_REQUESTS,
               rotated_iou_mask=TIMED_REQUESTS, nms_greedy_select=TIMED_REQUESTS))
    launches = dict(build.LAUNCHES)
    (boxes, valid, thr, post), kw = nms_rec.calls[0]
    nms_checks("lidar", *nms._candidate_lanes(boxes, valid, post, kw.get("cap", 512)), thr, post)

    # ---- voxels and sites per stage, beside the JAX package's caps -----------
    rb = rb_rec.results[0]
    lc = cfg.lidar_encoder
    per_sample = [torch.bincount(st.coords[:, 0], minlength=BATCH).tolist() for st in rb.sites]
    b, z, y, x = rb.sites[0].coords.unbind(1)
    _, H0, W0 = rb.sites[0].spatial_shape
    slots = torch.unique(((b * H0 + y) * W0 + x) * 16 + z // 4)  # (b, column, z // 4)
    s0_slots = torch.bincount(slots // (16 * H0 * W0), minlength=BATCH).tolist()
    rows = [("s0_voxels", per_sample[0], cfg.caps.max_voxels_eval), ("s0_slots", s0_slots, lc.s0_slot_cap)]
    rows += [(f"s{i}_sites", n, cap) for i, n, cap in zip((2, 3, 4, 5), per_sample[1:], lc.stage_voxel_caps)]
    binds = [name for name, n, cap in rows if max(n) > cap]
    log("lidar sites", **{f"{name}": f"{n}(jax_cap={cap})" for name, n, cap in rows},
        jax_caps_that_would_bind=",".join(binds) or "none")

    # ---- K4: every sparse conv of one request, kernel vs plain ---------------
    if len(conv_rec.calls) != SPARSE_CONVS_PER_REQUEST:
        raise RuntimeError(f"{len(conv_rec.calls)} sparse convs in one request")
    names = ["conv_input"]
    for (down, *_), (stage, _) in zip(lidar_encoder.DOWN_CONVS, lidar_encoder.RES_STAGES):
        names += [f"{stage}{ab}.conv{c}" for ab in "ab" for c in (1, 2)] + [down]
    tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, bound_ms=0.0, bytes_ms=0.0, ops_ms=0.0,
               dense_gflop=0.0, pair_gflop=0.0)
    worst = 0.0
    for name, ((f, nbr, w, b), _) in zip(names, conv_rec.calls):
        got = sparse_conv.sparse_conv_cuda(f, nbr, w, b)
        ref = sparse_conv.sparse_conv_plain(f, nbr, w, b)
        torch.cuda.synchronize()
        abs_e, _ = max_err(got, ref)
        torch.testing.assert_close(got.float(), ref.float(), rtol=K4_TOL_RTOL,
                                   atol=K4_TOL_ATOL_OF_MAX * ref.float().abs().max().item())
        worst = max(worst, abs_e)
        ms = cuda_ms(lambda: sparse_conv.sparse_conv_cuda(f, nbr, w, b))
        plain_ms = cuda_ms(lambda: sparse_conv.sparse_conv_plain(f, nbr, w, b), iters=3)
        K, cin, cout = w.shape
        fz = torch.cat([f, f.new_zeros(1, cin)])
        im2col = fz[torch.where(nbr < 0, f.shape[0], nbr).long()].reshape(nbr.shape[0], K * cin)
        w2 = w.reshape(K * cin, cout)
        library_ms = cuda_ms(lambda: torch.mm(im2col, w2), iters=5)
        del im2col, fz
        pairs = int((nbr >= 0).sum().item())
        nbytes = (f.numel() + w.numel() + nbr.shape[0] * cout) * f.element_size() + nbr.numel() * 4
        if b is not None:
            nbytes += b.numel() * b.element_size()
        peak = BF16_OPS_PER_S if f.dtype == torch.bfloat16 else F32_OPS_PER_S
        bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, 2 * pairs * cin * cout / peak * 1e3
        bound = max(bytes_ms, ops_ms)
        tile_taps, dense_flop, pair_flop = tile_work(nbr, f.shape[0], cin, cout, sparse_conv.K4_TILE_ROWS)
        log(f"K4 sparse_conv_fwd {name}", n_in=f.shape[0], n_out=nbr.shape[0], K=K, cin=cin, cout=cout,
            pairs=pairs, tile_taps=tile_taps, dense_gflop=f"{dense_flop / 1e9:.3f}",
            pair_gflop=f"{pair_flop / 1e9:.3f}", dense_tflop_per_s=f"{dense_flop / ms / 1e9:.1f}",
            max_abs_err=f"{abs_e:.3e}", ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}",
            library_ms=f"{library_ms:.4f}", bound_ms=f"{bound:.4f}",
            bound_by="bytes" if bytes_ms >= ops_ms else "operations")
        for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms), ("bound_ms", bound),
                     ("bytes_ms", bytes_ms), ("ops_ms", ops_ms), ("dense_gflop", dense_flop / 1e9),
                     ("pair_gflop", pair_flop / 1e9)):
            tot[k] += v
    bound_by = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
    log("K4 sparse_conv_fwd", convs=len(names), dtype=str(conv_rec.calls[0][0][0].dtype),
        max_abs_err=f"{worst:.3e}", tol=f"rtol={K4_TOL_RTOL},atol={K4_TOL_ATOL_OF_MAX}*max|ref|",
        **{f"{k}_per_request": f"{v:.4f}" for k, v in tot.items()}, bound_by=bound_by,
        dense_tflop_per_s=f"{tot['dense_gflop'] / tot['ms']:.1f}")
    table.append(dict(name="sparse_conv_fwd", route="cuda", source="unidistill_torch/csrc/sparse_conv.cu",
                      replaces="unidistill_tpu/ops/sparse_conv_pallas.py:128",
                      launches=launches["sparse_conv_fwd"], max_abs_err=worst, ms=tot["ms"],
                      plain_ms=tot["plain_ms"], bound_ms=tot["bound_ms"], bound_by=bound_by,
                      library_ms=tot["library_ms"]))
    del conv_rec, rb_rec, rb

    # ---- heads and ROIs: kernels vs plain versions on the card ---------------
    compare_heads("lidar ", det, cfg, model_inputs(batch_dev, cfg, dev, training=False), LIDAR_HEAD_REL_TOL_BF16)
    del det

    # ---- small input: the card against the CPU -----------------------------
    tcfg = dataclasses.replace(tiny_model(with_camera=False), compute_dtype="float32")
    tbatch = lidar_batch(tcfg, 2, seed=13)
    det_cpu = Detector(tcfg, random_state_dict(tcfg, seed=12), device="cpu")
    calibrate_batchnorm(det_cpu.model, model_inputs(tbatch, tcfg, "cpu", training=False))
    det_gpu = Detector(tcfg, det_cpu.model.state_dict(), device="cuda")
    in_g, in_c = model_inputs(tbatch, tcfg, dev, training=False), model_inputs(tbatch, tcfg, "cpu", training=False)
    if not torch.equal(in_g["voxel_coords"].cpu(), in_c["voxel_coords"]):
        raise RuntimeError("lidar tiny: the card puts points in other voxels than the CPU")
    if not torch.equal(in_g["voxel_feats"].cpu(), in_c["voxel_feats"]):  # no atomics: the CPU's sums
        raise RuntimeError("lidar tiny: the card's voxel features differ from the CPU's")
    with torch.no_grad():
        hg, hc = det_gpu.model(**in_g), det_cpu.model(**in_c)
    card_vs_cpu("lidar tiny", tcfg, hg, hc)


def tame(model) -> None:
    """BatchNorm scales × 0.3 and biases + 1: keeps a random BN-ReLU network
    in train mode out of its chaotic regime, where round-off of 1e-7 moves
    gradients by tens of percent (tests/test_torch_train_step.py)."""
    from torch import nn
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.modules.batchnorm._BatchNorm):
                m.weight.mul_(0.3)
                m.bias.add_(1.0)


def to_device(batch, dev):
    out = {}
    for k, v in batch.items():
        out[k] = to_device(v, dev) if isinstance(v, dict) else torch.from_numpy(v).to(dev)
    return out


def train_run(phase, step_fn, student, want, recorders=(), n_steps=TIMED_STEPS):
    """One warm-up step (`step_fn()` returns the metrics) with `recorders`
    on, then `n_steps` timed steps with every launch count set to 0 just
    before and read just after; each kernel in `want` must launch exactly
    that often per step. Checks the loss terms and the parameter change."""
    from unidistill_torch.kernels import build
    from unidistill_torch.training.steps import metrics_to_host
    with contextlib.ExitStack() as stack:
        for r in recorders:
            stack.enter_context(r)
        metrics_to_host(step_fn())
    before = [p.detach().clone() for p in student.parameters()]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    build.reset_launches()
    times, host = [], []
    for _ in range(n_steps):
        t0 = time.perf_counter()
        host.append(metrics_to_host(step_fn()))  # the one read-back of a step
        times.append(time.perf_counter() - t0)
    launches = dict(build.LAUNCHES)
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    change = max((p.detach() - b).abs().max().item() for p, b in zip(student.parameters(), before))
    del before
    terms = {k: v for k, v in host[-1].items() if not k.startswith("task_")}
    log(phase, batch=BATCH, steps=n_steps, s_per_step=[round(t, 4) for t in times],
        frames_per_s=f"{BATCH * len(times) / sum(times):.3f}", peak_mem_gib=f"{peak_gib:.3f}",
        param_max_change=f"{change:.3e}", launches=json.dumps(launches, sort_keys=True),
        **{k: f"{v:.6g}" for k, v in sorted(terms.items())})
    for k, n in want.items():
        if launches.get(k, 0) != n * n_steps:
            raise RuntimeError(f"{phase}: kernel {k} launched {launches.get(k, 0)} times in "
                               f"{n_steps} steps, expected {n} a step")
    for h in host:
        bad = [k for k, v in h.items() if not math.isfinite(v)]
        if bad:
            raise RuntimeError(f"{phase}: non-finite metrics {bad}")
    if not change > 0:
        raise RuntimeError(f"{phase}: the parameters did not change")
    return launches


def train_phases(dev, table):
    """The training paths: distill train (main path), camera train, K5,
    train tiny. Returns the distill step's batch (numpy) and its calibrated
    teacher's state dict (on the CPU), for the data-parallel phases."""
    from unidistill_torch.configs.nuscenes import (
        DISTILL_VARIANTS, DataConfig, camera_exp, distill_exp, lidar_exp, tiny_model)
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.ops import bev_pool
    from unidistill_torch.serving.synthetic import (
        calibrate_batchnorm, nuscenes_cells, random_state_dict, small_batch, train_batch)
    from unidistill_torch.training import steps
    from unidistill_torch.training.train_state import TrainState, make_optimizer

    # ---- distill train: camera student <- frozen LiDAR teacher -------------
    s_cfg, t_cfg = camera_exp().model, lidar_exp().model
    exp = distill_exp("lidar", "camera")
    t0 = time.time()
    batch_np = train_batch(s_cfg, t_cfg, BATCH, seed=21)
    batch = to_device(batch_np, dev)
    data_s = time.time() - t0
    teacher = BEVFusionCenterHead(t_cfg)
    teacher.load_state_dict(random_state_dict(t_cfg, seed=10))
    teacher.to(dev).requires_grad_(False)
    calibrate_batchnorm(teacher, steps.model_inputs(batch, t_cfg, dev, training=False))
    teacher_sd = {k: v.detach().cpu().clone() for k, v in teacher.state_dict().items()}
    student = BEVFusionCenterHead(s_cfg)
    student.load_state_dict(random_state_dict(s_cfg, seed=0))
    student.to(dev)
    opt = make_optimizer(student, exp.train)
    state = TrainState()
    n_gt = (batch["gt_boxes"].abs().sum(-1) > 0).sum(1).tolist()
    log("distill data", frames=BATCH, gt_boxes=n_gt, points=batch["points_mask"].sum(1).tolist(),
        seconds=f"{data_s:.2f}")
    step = lambda: steps.distill_train_step(state, batch, student, teacher, opt, s_cfg, t_cfg,
                                            DISTILL_VARIANTS[("lidar", "camera")])
    with Recorder(bev_pool, "bev_pool_bwd_cuda") as bwd_rec:
        launches = train_run("distill train", step, student,
                             dict(bev_pool_fwd=1, bev_pool_bwd=1, sparse_conv_fwd=SPARSE_CONVS_PER_REQUEST))
        rec_args = bwd_rec.calls[0][0]
        bwd_rec.calls.clear()
        bwd_rec.results.clear()
    if teacher.training or any(p.grad is not None for p in teacher.parameters()):
        raise RuntimeError("distill train: the teacher was trained")
    del teacher, student, opt, state
    torch.cuda.empty_cache()

    # ---- camera train: the detector's own train step ----------------------
    student = BEVFusionCenterHead(s_cfg)
    student.load_state_dict(random_state_dict(s_cfg, seed=0))
    student.to(dev)
    opt = make_optimizer(student, camera_exp().train)
    state = TrainState()
    cam_batch = {k: batch[k] for k in ("imgs", "mats", "gt_boxes")}
    train_run("camera train", lambda: steps.train_step(state, cam_batch, student, opt, s_cfg), student,
              dict(bev_pool_fwd=1, bev_pool_bwd=1))
    del student, opt, state, batch, cam_batch
    torch.cuda.empty_cache()

    # ---- K5: the recorded backward, kernel vs plain -------------------------
    cell, depth, context, g, ncells = rec_args
    gd_k, gc_k = bev_pool.bev_pool_bwd_cuda(cell, depth, context, g, ncells)
    again = bev_pool.bev_pool_bwd_cuda(cell, depth, context, g, ncells)
    gd_p, gc_p = bev_pool.bev_pool_outer_bwd_plain(cell, depth, context, g, ncells)
    torch.cuda.synchronize()
    if not (torch.equal(gd_k, again[0]) and torch.equal(gc_k, again[1])):
        raise RuntimeError("K5: two runs on the same inputs are not bit-identical")
    del again
    errs = []
    for got, ref in ((gd_k, gd_p), (gc_k, gc_p)):
        scale = ref.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(got / scale, ref / scale, **K5_TOL)
        errs.append(max_err(got, ref)[0])
    ms = cuda_ms(lambda: bev_pool.bev_pool_bwd_cuda(cell, depth, context, g, ncells))
    plain_ms = cuda_ms(lambda: bev_pool.bev_pool_outer_bwd_plain(cell, depth, context, g, ncells), iters=3)
    C = context.shape[-1]
    n_valid = int(((cell >= 0) & (cell < ncells)).sum().item())
    k5_bytes = (cell.numel() * 4 + depth.numel() * 4 * 2 + context.numel() * 4 * 2 + g.numel() * 4)
    k5_ops = 4 * n_valid * C  # two multiply-adds per channel per valid point
    bytes_ms, ops_ms = k5_bytes / HBM_BYTES_PER_S * 1e3, k5_ops / F32_OPS_PER_S * 1e3
    ray_runs, column_reads = bev_pool.bev_pool_bwd_reads(cell, ncells)
    log("K5 bev_pool_bwd", points=cell.numel(), valid_points=n_valid, C=C,
        g_max=f"{g.abs().max().item():.3e}", max_abs_err_depth=f"{errs[0]:.3e}",
        max_abs_err_context=f"{errs[1]:.3e}", tol=f"{K5_TOL} of max|ref|", bit_identical="true",
        ray_runs=ray_runs, column_reads=column_reads, g_row_mb=f"{column_reads * C * 4 / 1e6:.1f}", ms=f"{ms:.4f}",
        plain_ms=f"{plain_ms:.4f}", bound_ms=f"{max(bytes_ms, ops_ms):.4f}",
        bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    table.append(dict(name="bev_pool_bwd", route="cuda", source="unidistill_torch/csrc/bev_pool.cu",
                      replaces="unidistill_tpu/ops/bev_pool.py:282", launches=launches["bev_pool_bwd"],
                      max_abs_err=max(errs), ms=ms, plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms),
                      bound_by="bytes" if bytes_ms >= ops_ms else "operations", library_ms=None))
    del gd_k, gc_k, gd_p, gc_p

    # K5 on the same depth, context and g, but the cells of the training
    # image augmentation (rays of a column share fewer cells)
    cell = nuscenes_cells(camera_exp().model, cell.shape[0], seed=21, data=DataConfig()).to(dev)
    out = bev_pool.bev_pool_bwd_cuda(cell, depth, context, g, ncells)
    again = bev_pool.bev_pool_bwd_cuda(cell, depth, context, g, ncells)
    if not (torch.equal(out[0], again[0]) and torch.equal(out[1], again[1])):
        raise RuntimeError("K5 (train_ida): two runs on the same inputs are not bit-identical")
    errs = []
    for got, ref in zip(out, bev_pool.bev_pool_outer_bwd_plain(cell, depth, context, g, ncells)):
        scale = ref.abs().max().clamp_min(1e-30)
        torch.testing.assert_close(got / scale, ref / scale, **K5_TOL)
        errs.append(max_err(got, ref)[0])
    del out, again
    ms = cuda_ms(lambda: bev_pool.bev_pool_bwd_cuda(cell, depth, context, g, ncells))
    ray_runs, column_reads = bev_pool.bev_pool_bwd_reads(cell, ncells)
    log("K5 train_ida", max_abs_err=f"{max(errs):.3e}", bit_identical="true", ray_runs=ray_runs,
        column_reads=column_reads, ms=f"{ms:.4f}")
    del rec_args, cell, depth, context, g
    torch.cuda.empty_cache()

    # ---- small input: a train step on the card against the CPU -------------
    tcfg = dataclasses.replace(tiny_model(with_lidar=False), compute_dtype="float32")
    boxes = train_batch(tcfg, tiny_model(with_camera=False), 2, seed=23)["gt_boxes"]
    tbatch = dict(small_batch(tcfg, 2, seed=3), gt_boxes=boxes)
    train_card_vs_cpu("train tiny", dev, tcfg, tbatch, random_state_dict(tcfg, seed=2), camera_exp().train)
    return batch_np, teacher_sd


def train_card_vs_cpu(phase, dev, tcfg, tbatch, sd, train_cfg) -> None:
    """One small float32 train step (BatchNorms tamed) on the CPU and on the
    card from the same weights: loss, metrics and every gradient."""
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.training import steps
    from unidistill_torch.training.train_state import TrainState, make_optimizer
    results = {}
    for label, device in (("cpu", torch.device("cpu")), ("card", dev)):
        model = BEVFusionCenterHead(tcfg)
        model.load_state_dict(sd)
        tame(model)
        model.to(device)
        opt = make_optimizer(model, train_cfg)
        metrics = steps.metrics_to_host(steps.train_step(TrainState(), tbatch, model, opt, tcfg))
        unclip = max(1.0, metrics["grad_norm"] / opt.grad_clip)  # .grad holds the clipped gradients
        results[label] = metrics, {k: (p.grad * unclip).cpu() for k, p in model.named_parameters()}
    (m_c, g_c), (m_g, g_g) = results["cpu"], results["card"]
    for k, v in m_c.items():
        if not math.isclose(m_g[k], v, rel_tol=TRAIN_TINY_LOSS_RTOL, abs_tol=1e-6):
            raise RuntimeError(f"{phase}: metric {k} card {m_g[k]} vs CPU {v}")
    top = max(t.abs().max().item() for t in g_c.values())
    worst, worst_k = 0.0, None
    for k, ref in g_c.items():
        err = (g_g[k] - ref).abs().max().item() / max(ref.abs().max().item(), 1e-3 * top)
        if err > worst:
            worst, worst_k = err, k
    log(phase, loss_cpu=f"{m_c['loss']:.6g}", loss_card=f"{m_g['loss']:.6g}",
        grad_norm_cpu=f"{m_c['grad_norm']:.6g}", grad_norm_card=f"{m_g['grad_norm']:.6g}",
        worst_grad_err_over_scale=f"{worst:.3e}", at=worst_k, tol=TRAIN_TINY_GRAD_TOL,
        metrics_rtol=TRAIN_TINY_LOSS_RTOL)
    if worst > TRAIN_TINY_GRAD_TOL:
        raise RuntimeError(f"{phase}: gradient {worst_k} differs by {worst:.3e} of its scale")


def backward_kernel_phases(table, dgrad_calls, wgrad_calls, launches) -> None:
    """K4 as the input gradient and K6 on the tensors recorded from one
    LiDAR train step, each call against its plain version in bf16 (as
    recorded) and in f32; kernel / plain / library / bound ms summed over
    the step's launches."""
    from unidistill_torch.layers import lidar_encoder
    from unidistill_torch.ops import sparse_conv
    names = ["conv_input"]
    for (down, *_), (stage, _) in zip(lidar_encoder.DOWN_CONVS, lidar_encoder.RES_STAGES):
        names += [f"{stage}{ab}.conv{c}" for ab in "ab" for c in (1, 2)] + [down]
    names = names[::-1]  # the backward runs the convs in reverse
    if len(dgrad_calls) != SPARSE_CONV_DGRADS_PER_STEP or len(wgrad_calls) != SPARSE_CONVS_PER_REQUEST:
        raise RuntimeError(f"{len(dgrad_calls)} dgrad and {len(wgrad_calls)} wgrad calls in one step")

    def bound(nbytes, ops, dtype):
        peak = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
        return nbytes / HBM_BYTES_PER_S * 1e3, ops / peak * 1e3

    for kernel, calls, labels in (("K4 sparse_conv_dgrad", dgrad_calls, names[:-1]),
                                  ("K6 sparse_conv_wgrad", wgrad_calls, names)):
        tot = dict(ms=0.0, plain_ms=0.0, library_ms=0.0, library_per_tap_ms=0.0, bound_ms=0.0,
                   bytes_ms=0.0, ops_ms=0.0, tile_taps=0, dense_gflop=0.0, pair_gflop=0.0)
        if kernel.startswith("K6"):
            tot.update(scratch_bytes=0, max_scratch_bytes=0)
        worst = {torch.bfloat16: 0.0, torch.float32: 0.0}
        for name, (args, _) in zip(labels, calls):
            args = [t.detach() for t in args]  # the saved weight is part of the graph
            dgrad = kernel.startswith("K4")
            fn, plain = ((sparse_conv.sparse_conv_dgrad_cuda, sparse_conv.sparse_conv_dgrad_plain) if dgrad
                         else (sparse_conv.sparse_conv_wgrad_cuda, sparse_conv.sparse_conv_wgrad_plain))
            for dt in worst:
                a = [t.to(dt) if t.is_floating_point() else t for t in args]
                got, ref = fn(*a), plain(*a)
                torch.cuda.synchronize()
                scale = ref.float().abs().max().item()
                tol = K4_DGRAD_TOL[dt] if dgrad else K6_TOL
                torch.testing.assert_close(got.float(), ref.float(), rtol=tol[0], atol=tol[1] * scale,
                                           msg=f"{kernel} {name} {dt}")
                worst[dt] = max(worst[dt], max_err(got, ref)[0])
                if not dgrad and not torch.equal(got, fn(*a)):
                    raise RuntimeError(f"{kernel} {name} {dt}: a rerun is not bit-identical")
            ms = cuda_ms(lambda: fn(*args))
            plain_ms = cuda_ms(lambda: plain(*args), iters=3)
            dense = {}
            if dgrad:  # out[i] = Σ_k W[k]·g[nbr_t[i, k]]
                g, nbr, w = args
                K, cin, cout = w.shape
                n_in, esize = nbr.shape[0], g.element_size()
                src = torch.cat([g, g.new_zeros(1, cout)])
                gath = src[torch.where(nbr < 0, g.shape[0], nbr).long().t()]  # [K, N_in, Cout]
                wt = w.transpose(1, 2).contiguous()
                out = torch.empty(n_in, cin, dtype=g.dtype, device=g.device)
                im2col = gath.transpose(0, 1).reshape(n_in, K * cout)  # [N_in, K·Cout]
                wstack = wt.reshape(K * cout, cin)                      # [K·Cout, Cin]

                def library():  # one call, as the forward's yardstick
                    torch.mm(im2col, wstack, out=out)

                def library_per_tap():
                    torch.mm(gath[0], wt[0], out=out)
                    for k in range(1, K):
                        out.addmm_(gath[k], wt[k])
                nbytes = (g.numel() + w.numel() + n_in * cin) * esize + nbr.numel() * 4
                # K4's view: the rows are inputs, its Cin the conv's Cout
                tile_taps, dense_flop, pair_flop = tile_work(nbr, g.shape[0], cout, cin, sparse_conv.K4_TILE_ROWS)
            else:  # dW[k] = Σ_o x[nbr[o, k]]ᵀ·g[o]
                x, g, nbr = args
                K, cin, cout = nbr.shape[1], x.shape[1], g.shape[1]
                esize = x.element_size()
                src = torch.cat([x, x.new_zeros(1, cin)])
                gath = src[torch.where(nbr < 0, x.shape[0], nbr).long().t()].transpose(1, 2)  # [K, Cin, N]
                out = torch.empty(K, cin, cout, dtype=g.dtype, device=g.device)
                gk = g.expand(K, *g.shape)

                def library():  # one call: the gathered rows of every tap by g
                    torch.bmm(gath, gk, out=out)

                def library_per_tap():
                    for k in range(K):
                        torch.mm(gath[k], g, out=out[k])
                nbytes = (x.numel() + g.numel()) * esize + nbr.numel() * 4 + K * cin * cout * 4
                # the bf16 kernel's tiles, chunks and partial sums (the f32 kernel's are not timed)
                cin_p = cin + -cin % 16
                tile_taps, dense_flop, pair_flop = tile_work(nbr, x.shape[0], cin, cout,
                                                             sparse_conv.k6_tile_rows(cin_p, cout))
                chunks, rows = sparse_conv.k6_launch_plan(g.shape[0], K, cin_p, cout, x.dtype, x.device)
                scratch = chunks * K * cin_p * cout * 4
                dense["chunks"], dense["rows_per_chunk"], dense["scratch_bytes"] = chunks, rows, scratch
                tot["scratch_bytes"] += scratch
                tot["max_scratch_bytes"] = max(tot["max_scratch_bytes"], scratch)
            dense.update(tile_taps=tile_taps, dense_gflop=f"{dense_flop / 1e9:.3f}",
                         pair_gflop=f"{pair_flop / 1e9:.3f}", dense_tflop_per_s=f"{dense_flop / ms / 1e9:.1f}")
            tot["tile_taps"] += tile_taps
            tot["dense_gflop"] += dense_flop / 1e9
            tot["pair_gflop"] += pair_flop / 1e9
            library_ms = cuda_ms(library, iters=5)
            per_tap_ms = cuda_ms(library_per_tap, iters=5)
            del gath, src, out
            pairs = int((nbr >= 0).sum().item())
            bytes_ms, ops_ms = bound(nbytes, 2 * pairs * cin * cout, args[0].dtype)
            log(f"{kernel} {name}", rows=nbr.shape[0], K=K, cin=cin, cout=cout, pairs=pairs, **dense,
                ms=f"{ms:.4f}", plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}",
                library_per_tap_ms=f"{per_tap_ms:.4f}", bound_ms=f"{max(bytes_ms, ops_ms):.4f}")
            for k, v in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", library_ms),
                         ("library_per_tap_ms", per_tap_ms), ("bound_ms", max(bytes_ms, ops_ms)),
                         ("bytes_ms", bytes_ms), ("ops_ms", ops_ms)):
                tot[k] += v
        bound_by = "bytes" if tot["bytes_ms"] >= tot["ops_ms"] else "operations"
        tol = K4_DGRAD_TOL if kernel.startswith("K4") else {dt: K6_TOL for dt in worst}
        log(kernel, convs=len(calls), max_abs_err_bf16=f"{worst[torch.bfloat16]:.3e}",
            max_abs_err_f32=f"{worst[torch.float32]:.3e}",
            tol="; ".join(f"{dt}: rtol={r},atol={a}*max|ref|" for dt, (r, a) in tol.items()),
            **{f"{k}_per_step": (v if isinstance(v, int) else f"{v:.4f}") for k, v in tot.items()},
            bound_by=bound_by, dense_tflop_per_s=f"{tot['dense_gflop'] / tot['ms']:.1f}")
        key = "sparse_conv_dgrad" if kernel.startswith("K4") else "sparse_conv_wgrad"
        table.append(dict(name=key, route="cuda", source="unidistill_torch/csrc/sparse_conv.cu",
                          replaces="unidistill_tpu/ops/sparse_conv_pallas.py:279", launches=launches[key],
                          max_abs_err=worst[torch.bfloat16], ms=tot["ms"], plain_ms=tot["plain_ms"],
                          bound_ms=tot["bound_ms"], bound_by=bound_by, library_ms=tot["library_ms"]))


def frozen_teacher(cfg, seed, batch, dev):
    """A detector with seeded weights, BatchNorm calibrated on `batch`,
    frozen in eval mode."""
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.serving.synthetic import calibrate_batchnorm, random_state_dict
    from unidistill_torch.training.steps import model_inputs
    teacher = BEVFusionCenterHead(cfg)
    teacher.load_state_dict(random_state_dict(cfg, seed=seed))
    teacher.to(dev).requires_grad_(False)
    calibrate_batchnorm(teacher, model_inputs(batch, cfg, dev, training=False))
    return teacher


def student_model(cfg, seed, dev, sweeps=1):
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.serving.synthetic import random_state_dict
    model = BEVFusionCenterHead(cfg, sweeps)
    model.load_state_dict(random_state_dict(cfg, seed=seed, sweeps=sweeps))
    return model.to(dev)


def check_frozen(phase, teacher) -> None:
    if teacher.training or any(p.grad is not None for p in teacher.parameters()):
        raise RuntimeError(f"{phase}: the teacher was trained")


def lidar_train_phases(dev, table) -> None:
    """This slice's main path, the LiDAR detector's train step (K4 forward,
    K4 as the input gradient, K6), then K4 dgrad and K6 against their plain
    versions, camera->LiDAR distillation, and a tiny f32 LiDAR train step on
    the card against the CPU."""
    from unidistill_torch.configs.nuscenes import (
        DISTILL_VARIANTS, camera_exp, distill_exp, lidar_exp, tiny_model)
    from unidistill_torch.ops import sparse_conv
    from unidistill_torch.serving.synthetic import random_state_dict, train_batch
    from unidistill_torch.training import steps
    from unidistill_torch.training.train_state import TrainState, make_optimizer

    # ---- lidar train: the detector's train step at full width ---------------
    exp = lidar_exp()
    cfg = exp.model
    t0 = time.time()
    batch = to_device(train_batch(camera_exp().model, cfg, BATCH, seed=21), dev)
    data_s = time.time() - t0
    voxels = (steps.model_inputs(batch, cfg, dev, training=True)["voxel_coords"][..., 0] >= 0).sum(1).tolist()
    log("lidar train data", frames=BATCH, points=batch["points_mask"].sum(1).tolist(), voxels=voxels,
        max_voxels_train=cfg.caps.max_voxels_train,
        gt_boxes=(batch["gt_boxes"].abs().sum(-1) > 0).sum(1).tolist(), seconds=f"{data_s:.2f}")
    model = student_model(cfg, 30, dev)
    opt = make_optimizer(model, exp.train)
    state = TrainState()
    dgrad_rec = Recorder(sparse_conv, "sparse_conv_dgrad_cuda")
    wgrad_rec = Recorder(sparse_conv, "sparse_conv_wgrad_cuda")
    launches = train_run("lidar train", lambda: steps.train_step(state, batch, model, opt, cfg), model,
                         dict(sparse_conv_fwd=SPARSE_CONVS_PER_REQUEST, sparse_conv_dgrad=SPARSE_CONV_DGRADS_PER_STEP,
                              sparse_conv_wgrad=SPARSE_CONVS_PER_REQUEST, bev_pool_fwd=0, bev_pool_bwd=0),
                         recorders=(dgrad_rec, wgrad_rec))
    del model, opt, state
    torch.cuda.empty_cache()

    # ---- K4 dgrad and K6 on the recorded step ---------------------------------
    backward_kernel_phases(table, dgrad_rec.calls, wgrad_rec.calls, launches)
    del dgrad_rec, wgrad_rec
    torch.cuda.empty_cache()

    # ---- distill camera -> lidar ------------------------------------------------
    pair = ("camera", "lidar")
    teacher = frozen_teacher(camera_exp().model, 0, batch, dev)
    student = student_model(cfg, 30, dev)
    opt = make_optimizer(student, distill_exp(*pair).train)
    state = TrainState()
    train_run("distill camera->lidar", lambda: steps.distill_train_step(
        state, batch, student, teacher, opt, cfg, camera_exp().model, DISTILL_VARIANTS[pair]), student,
        dict(bev_pool_fwd=1, bev_pool_bwd=0, sparse_conv_fwd=SPARSE_CONVS_PER_REQUEST,
             sparse_conv_dgrad=SPARSE_CONV_DGRADS_PER_STEP, sparse_conv_wgrad=SPARSE_CONVS_PER_REQUEST))
    check_frozen("distill camera->lidar", teacher)
    del teacher, student, opt, state, batch
    torch.cuda.empty_cache()

    # ---- small input: a LiDAR train step on the card against the CPU -------
    tcfg = dataclasses.replace(tiny_model(with_camera=False), compute_dtype="float32")
    tbatch = train_batch(tcfg, tcfg, 2, seed=24)
    train_card_vs_cpu("lidar train tiny", dev, tcfg, tbatch, random_state_dict(tcfg, seed=12), exp.train)


def fusion_phases(dev) -> None:
    """The fusion detector: predict, train, and the two distillation pairs
    with the fusion teacher (one warm-up and TIMED_STEPS timed steps each:
    a single fusion step's time varies by more than the kernels move)."""
    from unidistill_torch.configs.nuscenes import DISTILL_VARIANTS, camera_exp, distill_exp, fusion_exp, lidar_exp
    from unidistill_torch.serving.predictor import Detector
    from unidistill_torch.serving.synthetic import calibrate_batchnorm, random_state_dict, train_batch
    from unidistill_torch.training import steps
    from unidistill_torch.training.train_state import TrainState, make_optimizer

    exp = fusion_exp()
    cfg = exp.model
    batch = to_device(train_batch(cfg, cfg, BATCH, seed=21), dev)

    # ---- fusion predict -----------------------------------------------------
    det = Detector(cfg, random_state_dict(cfg, seed=40), device="cuda")
    calibrate_batchnorm(det.model, steps.model_inputs(batch, cfg, dev, training=False))
    request = {k: batch[k] for k in ("points", "points_mask", "imgs", "mats")}
    serve("fusion predict", det, cfg, request, [],
          dict(bev_pool_fwd=TIMED_REQUESTS, sparse_conv_fwd=SPARSE_CONVS_PER_REQUEST * TIMED_REQUESTS,
               rotated_iou_mask=TIMED_REQUESTS, nms_greedy_select=TIMED_REQUESTS))
    teacher = det.model.requires_grad_(False)
    del det

    # ---- fusion train -------------------------------------------------------
    model = student_model(cfg, 41, dev)
    opt = make_optimizer(model, exp.train)
    state = TrainState()
    train_run("fusion train", lambda: steps.train_step(state, batch, model, opt, cfg), model,
              dict(bev_pool_fwd=1, bev_pool_bwd=1, sparse_conv_fwd=SPARSE_CONVS_PER_REQUEST,
                   sparse_conv_dgrad=SPARSE_CONV_DGRADS_PER_STEP, sparse_conv_wgrad=SPARSE_CONVS_PER_REQUEST))
    del model, opt, state
    torch.cuda.empty_cache()

    # ---- distill fusion -> lidar and fusion -> camera ------------------------
    for student_exp, want in (
            (lidar_exp(), dict(bev_pool_fwd=1, bev_pool_bwd=0, sparse_conv_fwd=2 * SPARSE_CONVS_PER_REQUEST,
                               sparse_conv_dgrad=SPARSE_CONV_DGRADS_PER_STEP,
                               sparse_conv_wgrad=SPARSE_CONVS_PER_REQUEST)),
            (camera_exp(), dict(bev_pool_fwd=2, bev_pool_bwd=1, sparse_conv_fwd=SPARSE_CONVS_PER_REQUEST,
                                sparse_conv_dgrad=0, sparse_conv_wgrad=0))):
        s_cfg = student_exp.model
        pair = ("fusion", "lidar" if s_cfg.with_lidar else "camera")
        phase = f"distill fusion->{pair[1]}"
        student = student_model(s_cfg, 30 if s_cfg.with_lidar else 0, dev)
        opt = make_optimizer(student, distill_exp(*pair).train)
        state = TrainState()
        train_run(phase, lambda: steps.distill_train_step(
            state, batch, student, teacher, opt, s_cfg, cfg, DISTILL_VARIANTS[pair]), student, want)
        check_frozen(phase, teacher)
        del student, opt, state
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the Swin-T camera backbone, multi-sweep camera input, the leaf modules
# ---------------------------------------------------------------------------

def per_unit(launches, n):
    return json.dumps({k: v / n for k, v in sorted(launches.items())})


def swin_multisweep_phases(dev, batch_np) -> None:
    """The Swin camera detector and the 2-sweep ResNet camera detector,
    served and trained at full width (batch 4, seeded weights, BatchNorm
    calibrated for serving, tamed for training); `batch_np` gives the
    training frames' images, matrices and GT boxes."""
    from unidistill_torch.configs.nuscenes import (
        SWIN_CAMERA_OVERRIDES, ExpConfig, apply_overrides, camera_exp, tiny_model)
    from unidistill_torch.kernels import build
    from unidistill_torch.layers import lss
    from unidistill_torch.serving.predictor import Detector
    from unidistill_torch.serving.synthetic import (
        calibrate_batchnorm, nuscenes_batch, random_state_dict, small_batch)
    from unidistill_torch.training import steps
    from unidistill_torch.training.train_state import TrainState, make_optimizer

    # ---- swin predict, swin tiny, swin train ---------------------------------
    exp = apply_overrides(camera_exp(), SWIN_CAMERA_OVERRIDES)
    cfg = exp.model
    det = Detector(cfg, random_state_dict(cfg, seed=0), device="cuda")
    request = to_device(nuscenes_batch(cfg, BATCH, seed=1), dev)
    calibrate_batchnorm(det.model, steps.model_inputs(request, cfg, dev, training=False))
    serve("swin predict", det, cfg, request, [],
          dict(bev_pool_fwd=TIMED_REQUESTS, rotated_iou_mask=TIMED_REQUESTS, nms_greedy_select=TIMED_REQUESTS))
    log("swin predict", launches_per_request=per_unit(build.LAUNCHES, TIMED_REQUESTS))
    del det, request
    torch.cuda.empty_cache()

    tcfg = dataclasses.replace(
        apply_overrides(ExpConfig(model=tiny_model(with_lidar=False)), SWIN_CAMERA_OVERRIDES).model,
        compute_dtype="float32")
    tbatch = small_batch(tcfg, 2, seed=3)
    det_cpu = Detector(tcfg, random_state_dict(tcfg, seed=2), device="cpu")
    calibrate_batchnorm(det_cpu.model, steps.model_inputs(tbatch, tcfg, "cpu", training=False))
    det_gpu = Detector(tcfg, det_cpu.model.state_dict(), device="cuda")
    with Recorder(lss, "bev_pool_outer") as rec_g, torch.no_grad():
        hg = det_gpu.model(**steps.model_inputs(tbatch, tcfg, dev, training=False))
    with Recorder(lss, "bev_pool_outer") as rec_c, torch.no_grad():
        hc = det_cpu.model(**steps.model_inputs(tbatch, tcfg, "cpu", training=False))
    moved = int((rec_g.calls[0][0][0].cpu() != rec_c.calls[0][0][0]).any(-1).sum().item())
    if moved:
        raise RuntimeError(f"swin tiny: {moved} frustum points fall in other cells on the card")
    card_vs_cpu("swin tiny", tcfg, hg, hc)
    del det_cpu, det_gpu, hg, hc

    batch = to_device({k: batch_np[k] for k in ("imgs", "mats", "gt_boxes")}, dev)
    model = student_model(cfg, 0, dev)
    tame(model)
    opt = make_optimizer(model, exp.train)
    state = TrainState()
    launches = train_run("swin train", lambda: steps.train_step(state, batch, model, opt, cfg), model,
                         dict(bev_pool_fwd=1, bev_pool_bwd=1))
    log("swin train", launches_per_step=per_unit(launches, TIMED_STEPS))
    del model, opt, state, batch
    torch.cuda.empty_cache()

    # ---- multisweep predict: 2 sweeps, ResNet-50 -----------------------------
    exp = camera_exp()
    cfg = exp.model
    det = Detector(cfg, random_state_dict(cfg, seed=0, sweeps=SWEEPS), device="cuda")
    request = to_device(nuscenes_batch(cfg, BATCH, seed=1, sweeps=SWEEPS), dev)
    kw = steps.model_inputs(request, cfg, dev, training=False)
    calibrate_batchnorm(det.model, kw)
    serve("multisweep predict", det, cfg, request, [],
          dict(bev_pool_fwd=SWEEPS * TIMED_REQUESTS, rotated_iou_mask=TIMED_REQUESTS,
               nms_greedy_select=TIMED_REQUESTS))
    log("multisweep predict", sweeps=SWEEPS, launches_per_request=per_unit(build.LAUNCHES, TIMED_REQUESTS))
    # channel block 0 against a one-sweep detector with the same camera
    # encoder (the weights and the statistics calibrated on both sweeps) on
    # the key frame alone
    sd1 = random_state_dict(cfg, seed=0)
    sd1.update({k: v for k, v in det.model.state_dict().items() if k.startswith("camera_encoder.")})
    det1 = Detector(cfg, sd1, device="cuda")
    key = {"imgs": kw["imgs"][:, 0], "mats": {k: (v if k == "bda_mat" else v[:, 0]) for k, v in kw["mats"].items()}}
    with torch.no_grad():
        both = det.model(**kw)["model_output"]
        alone = det1.model(**key)["model_output"]
    C = alone.shape[1]
    if both.shape[1] != SWEEPS * C:
        raise RuntimeError(f"multisweep: model_output has {both.shape[1]} channels, expected {SWEEPS * C}")
    err = (both[:, :C] - alone).abs().max().item() / alone.abs().max().clamp_min(1e-6).item()
    log("multisweep key block", channels=f"{both.shape[1]}={SWEEPS}x{C}", err_over_range=f"{err:.3e}",
        tol=HEAD_REL_TOL_BF16, bit_equal=torch.equal(both[:, :C], alone),
        other_block_differs=not torch.equal(both[:, C:], both[:, :C]))
    if err > HEAD_REL_TOL_BF16:
        raise RuntimeError(f"multisweep: channel block 0 differs from the key frame's own by {err:.3e}")
    del det, det1, request, kw, key, both, alone
    torch.cuda.empty_cache()

    # ---- multisweep train ------------------------------------------------------
    frames = nuscenes_batch(cfg, BATCH, seed=21, sweeps=SWEEPS)
    batch = to_device(dict(frames, gt_boxes=batch_np["gt_boxes"]), dev)
    model = student_model(cfg, 0, dev, sweeps=SWEEPS)
    opt = make_optimizer(model, exp.train)
    state = TrainState()
    launches = train_run("multisweep train", lambda: steps.train_step(state, batch, model, opt, cfg), model,
                         dict(bev_pool_fwd=SWEEPS, bev_pool_bwd=1))
    log("multisweep train", sweeps=SWEEPS, launches_per_step=per_unit(launches, TIMED_STEPS))
    # a gradient asked of the images: the key sweep's only
    kw = steps.model_inputs(batch, cfg, dev, training=True)
    kw["imgs"].requires_grad_(True)
    model(**kw)["model_output"].square().mean().backward()
    g = kw["imgs"].grad
    key_g, other_g = g[:, 0].abs().max().item(), g[:, 1:].abs().max().item()
    log("multisweep train", image_grad_key_max=f"{key_g:.3e}", image_grad_other_max=f"{other_g:.3e}")
    if not (key_g > 0 and other_g == 0):
        raise RuntimeError(f"multisweep train: image gradients key {key_g:.3e}, later sweeps {other_g:.3e}")
    del model, opt, state, batch, kw, g
    torch.cuda.empty_cache()


def components_phase(dev) -> None:
    """The leaf modules on the card against the same calls on the CPU, float32
    (TF32 off): `SCBottleneck` (planes 256, train mode: output and running
    statistics), `PillarVFE` + `pointpillar_scatter` on a 10-sweep LiDAR
    frame's pillars, `roiaware_pool3d` max and avg with gradients (100 boxes
    on the frame's points, axis-aligned and rotated, 14 x 14 x 14 cells)."""
    from unidistill_torch.configs.nuscenes import lidar_exp
    from unidistill_torch.layers.pillar_vfe import PillarVFE, pointpillar_scatter
    from unidistill_torch.layers.sc_conv import SCBottleneck
    from unidistill_torch.ops.roiaware_pool import roi_point_cells, roiaware_pool3d
    from unidistill_torch.serving.synthetic import lidar_batch, pillars

    def rel(got, ref):
        return (got.cpu().float() - ref.float()).abs().max().item() / ref.abs().max().clamp_min(1e-6).item()

    def both(make, args, train=True):
        """make() built once, copied to the card; the module's outputs on
        both devices, its state dicts after."""
        torch.manual_seed(0)
        cpu = make().train(train)
        card = make().train(train)
        card.load_state_dict(cpu.state_dict())
        card.to(dev)
        args_g = [a.to(dev) for a in args]
        with torch.no_grad():
            out_c = cpu(*args)
            out_g = card(*args_g)
            sd_c = {k: v.clone() for k, v in cpu.state_dict().items()}
            sd_g = {k: v.clone() for k, v in card.state_dict().items()}
            ms = cuda_ms(lambda: card(*args_g), iters=3, warmup=1)
        return out_c, out_g, sd_c, sd_g, ms

    def stats_rel(sd_c, sd_g):
        return max(rel(sd_g[k], v) for k, v in sd_c.items() if k.startswith("running") or ".running" in k)

    # ---- SCBottleneck --------------------------------------------------------
    x = torch.randn(BATCH, 256, 180, 180, generator=torch.Generator().manual_seed(0))
    out_c, out_g, sd_c, sd_g, ms = both(lambda: SCBottleneck(256, 256), (x,))
    e_out, e_stats = rel(out_g, out_c), stats_rel(sd_c, sd_g)
    log("components scbottleneck", shape=list(x.shape), err_over_range=f"{e_out:.3e}",
        stats_err=f"{e_stats:.3e}", tol=COMPONENT_REL_TOL, card_ms=f"{ms:.3f}")
    if max(e_out, e_stats) > COMPONENT_REL_TOL:
        raise RuntimeError(f"SCBottleneck: card vs CPU {e_out:.3e} (statistics {e_stats:.3e})")

    # ---- PillarVFE + pointpillar_scatter ------------------------------------
    lcfg = lidar_exp().model
    frame = lidar_batch(lcfg, 1, seed=5)
    pts, mask = frame["points"][0], frame["points_mask"][0]
    feats, coords, npts = (torch.from_numpy(a) for a in pillars(
        pts, mask, PILLAR_SIZE, lcfg.point_cloud_range, PILLAR_MAX_POINTS))
    grid = tuple(int(round((lcfg.point_cloud_range[i + 3] - lcfg.point_cloud_range[i]) / PILLAR_SIZE[i]))
                 for i in range(3))
    out_c, out_g, sd_c, sd_g, ms = both(
        lambda: PillarVFE(5, voxel_size=PILLAR_SIZE, point_cloud_range=lcfg.point_cloud_range),
        (feats, coords, npts))
    e_out, e_stats = rel(out_g, out_c), stats_rel(sd_c, sd_g)
    valid = npts > 0
    canvas_g = pointpillar_scatter(out_g, coords.to(dev), valid.to(dev), grid)
    canvas_c = pointpillar_scatter(out_g.cpu(), coords, valid, grid)
    exact = torch.equal(canvas_g.cpu(), canvas_c)
    log("components pillar_vfe", points=int(mask.sum()), pillars=len(npts), grid=list(grid),
        max_points=PILLAR_MAX_POINTS, err_over_range=f"{e_out:.3e}", stats_err=f"{e_stats:.3e}",
        tol=COMPONENT_REL_TOL, scatter_exact=exact, card_ms=f"{ms:.3f}")
    if max(e_out, e_stats) > COMPONENT_REL_TOL or not exact:
        raise RuntimeError(f"PillarVFE: card vs CPU {e_out:.3e} (statistics {e_stats:.3e}), scatter exact {exact}")

    # ---- roiaware_pool3d -----------------------------------------------------
    rng = np.random.RandomState(6)
    xyz = torch.from_numpy(pts[mask][:, :3].copy())
    feat = torch.from_numpy(pts[mask].copy())  # x, y, z, intensity, dt
    centres = pts[mask][rng.choice(int(mask.sum()), ROI_BOXES, replace=False), :3]
    sizes = np.concatenate([rng.uniform(2.0, 6.0, (ROI_BOXES, 2)), rng.uniform(1.5, 3.0, (ROI_BOXES, 1))], 1)
    headings = rng.uniform(-np.pi, np.pi, (ROI_BOXES, 1))
    cot = torch.randn(ROI_BOXES, *(ROI_CELLS,) * 3, feat.shape[1], generator=torch.Generator().manual_seed(7))
    n_cells = ROI_BOXES * ROI_CELLS ** 3
    for boxes, heading in (("axis-aligned", np.zeros_like(headings)), ("rotated", headings)):
        rois = torch.from_numpy(np.concatenate([centres, sizes, heading], 1).astype(np.float32))
        # the (point, cell) pairs on each device; a rotated box's sin, cos
        # and fused multiply-adds round otherwise on the card, so a point
        # within rounding of a cell's face may change cells there: each such
        # pair must lie within ROI_FACE_M of a face (float64), and its
        # cells and their points are left out of the comparison
        keys = {}
        for label, d in (("cpu", torch.device("cpu")), ("card", dev)):
            _, pt, cell = roi_point_cells(rois.to(d), xyz.to(d), (ROI_CELLS,) * 3)
            keys[label] = pt.cpu() * n_cells + cell.cpu()
        kc, kg = keys["cpu"], keys["card"]
        moved = torch.cat([kc[~torch.isin(kc, kg)], kg[~torch.isin(kg, kc)]])
        m_pt, m_cell = moved // n_cells, moved % n_cells
        face_m = roi_face_distance(rois, xyz, m_pt, m_cell).max().item() if len(moved) else 0.0
        hit = torch.cat([k[torch.isin(k % n_cells, m_cell)] for k in (kc, kg)])
        cell_ok = torch.ones(n_cells, dtype=torch.bool)
        cell_ok[m_cell] = False
        pt_ok = torch.ones(xyz.shape[0], dtype=torch.bool)
        pt_ok[hit // n_cells] = False
        log(f"components roiaware_pool3d {boxes} cells", pairs=len(kc), moved_pairs=len(moved),
            cells_left_out=int((~cell_ok).sum()), points_left_out=int((~pt_ok).sum()),
            moved_max_face_distance_m=f"{face_m:.3e}", face_tol_m=ROI_FACE_M)
        if (boxes == "axis-aligned" and len(moved)) or face_m > ROI_FACE_M:
            raise RuntimeError(f"roiaware_pool3d {boxes}: {len(moved)} (point, cell) pairs differ on the "
                               f"card, up to {face_m:.3e} m from a face")
        for method, (tol, grad_tol) in ROI_TOL.items():
            res = {}
            for label, d in (("cpu", torch.device("cpu")), ("card", dev)):
                f = feat.to(d, copy=True).requires_grad_(True)
                out = roiaware_pool3d(rois.to(d), xyz.to(d), f, ROI_CELLS, method)
                (out * cot.to(d)).sum().backward()
                res[label] = out.detach().cpu().reshape(n_cells, -1), f.grad.cpu()
            ms = cuda_ms(lambda: roiaware_pool3d(rois.to(dev), xyz.to(dev), feat.to(dev), ROI_CELLS, method),
                         iters=3, warmup=1)
            (o_c, g_c), (o_g, g_g) = res["cpu"], res["card"]
            e_out, e_grad = rel(o_g[cell_ok], o_c[cell_ok]), rel(g_g[pt_ok], g_c[pt_ok])
            filled = int((o_c.abs().sum(-1) > 0).sum())
            log(f"components roiaware_pool3d {method}", boxes=boxes, rois=ROI_BOXES, points=xyz.shape[0],
                cells=n_cells, filled_cells=filled, err_over_range=f"{e_out:.3e}",
                grad_err_over_range=f"{e_grad:.3e}", tol=tol, grad_tol=grad_tol, card_ms=f"{ms:.3f}")
            if e_out > tol or e_grad > grad_tol or filled == 0:
                raise RuntimeError(f"roiaware_pool3d {method} ({boxes}): card vs CPU {e_out:.3e} "
                                   f"(gradient {e_grad:.3e})")


def roi_face_distance(rois, xyz, pt, cell):
    """Distance in metres (float64) from each point `pt` to the nearest
    face of the ROI cells grid it was binned into (`cell` a flat index of
    `roi_point_cells`)."""
    r, p = rois.double()[cell // ROI_CELLS ** 3], xyz.double()[pt]
    px, py, pz = (p[:, i] - r[:, i] for i in range(3))
    c, s = torch.cos(-r[:, 6]), torch.sin(-r[:, 6])
    local = torch.stack([px * c - py * s, px * s + py * c, pz], 1)
    size = r[:, 3:6] / ROI_CELLS
    u = (local + r[:, 3:6] / 2) / size
    return ((u - u.round()).abs() * size).min(1).values


# ---------------------------------------------------------------------------
# the serving export, the ops' launch path, the FLOP counts
# ---------------------------------------------------------------------------

# the modules a loaded artifact must not need
MODEL_MODULES = ("unidistill_torch.models", "unidistill_torch.layers", "unidistill_torch.training")


def load_artifacts(jobs_path: str, out_path: str) -> int:
    """The loading process of the export phases (`chip_smoke.py
    load-artifacts JOBS OUT`): imports `unidistill_torch.serving.export` and
    nothing of `models`, `layers` or `training`; for each artifact of the
    pickled jobs, loads it (seconds), predicts on each batch, counts one
    request's launches, and times `EXPORT_LATENCY_CALLS` calls of the loaded
    program on the batch's device tensors and of `predict` (numpy in and
    out; host clock ending in a synchronise); pickles the results."""
    import pickle
    import statistics
    sys.path.insert(0, str(ROOT))
    from unidistill_torch.kernels import build
    from unidistill_torch.serving.export import load_detector
    with open(jobs_path, "rb") as f:
        jobs = pickle.load(f)
    out = {}
    for name, job in jobs.items():
        t0 = time.perf_counter()
        det = load_detector(job["path"])
        load_s = time.perf_counter() - t0
        rois = [det.predict(b) for b in job["batches"]]
        build.reset_launches()
        det.predict(job["batches"][0])
        launches = dict(build.LAUNCHES)
        inputs = det.inputs(job["batches"][0])
        times = {"program": [], "predict": []}
        with torch.no_grad():
            for _ in range(EXPORT_LATENCY_CALLS):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                det.program(inputs)
                torch.cuda.synchronize()
                times["program"].append(time.perf_counter() - t0)
        for _ in range(EXPORT_LATENCY_CALLS):
            t0 = time.perf_counter()
            det.predict(job["batches"][0])  # ends in the outputs' copy to the host
            times["predict"].append(time.perf_counter() - t0)
        out[name] = dict(load_s=load_s, rois=rois, launches=launches,
                         **{f"{k}_ms": statistics.median(v) * 1e3 for k, v in times.items()})
        del det, inputs
        torch.cuda.empty_cache()
    out["modules"] = sorted(m for m in sys.modules
                            if m.startswith(MODEL_MODULES) or m.split(".")[0] in ("jax", "unidistill_tpu"))
    with open(out_path, "wb") as f:
        pickle.dump(out, f)
    return 0


def _numpy_tree(batch):
    return {k: _numpy_tree(v) if isinstance(v, dict) else v.cpu().numpy() for k, v in batch.items()}


def export_phases(dev) -> dict:
    """The serving export of the three detectors at full width, batch 4
    (seeded weights, BatchNorm calibrated): export on the card, save, load
    in a fresh process, predict on two batches of other seeds, compare with
    the live `Detector.predict`. Returns the kernels' recorded arguments of
    the live requests, for the launch path."""
    import pickle
    import statistics
    import tempfile
    from unidistill_torch.configs.nuscenes import camera_exp, fusion_exp, lidar_exp
    from unidistill_torch.kernels import build
    from unidistill_torch.layers.lidar_encoder import build_rulebooks, stage_shapes
    from unidistill_torch.ops import bev_pool, nms, sparse_conv
    from unidistill_torch.serving.export import _batch_spec, _flatten_paths, export_detector
    from unidistill_torch.serving.predictor import Detector
    from unidistill_torch.serving.synthetic import calibrate_batchnorm, random_state_dict, train_batch
    from unidistill_torch.training.steps import model_inputs, voxelize_batch

    t_phase = time.time()
    recorded = {}
    # (name, config, input mode, weight seed); every detector takes its keys
    # of the same two camera + LiDAR batches
    cases = (("camera", camera_exp, "points", 50), ("lidar", lidar_exp, "points", 51),
             ("fusion", fusion_exp, "points", 52), ("lidar host_voxels", lidar_exp, "host_voxels", 51))
    fcfg = fusion_exp().model
    full_batches = [to_device(train_batch(fcfg, fcfg, BATCH, seed=s), dev) for s in EXPORT_BATCH_SEEDS]
    with tempfile.TemporaryDirectory(prefix="unidistill_export_") as tmp:
        jobs, live = {}, {}
        for name, exp, mode, seed in cases:
            cfg = exp().model
            batches = []
            for full in full_batches:
                b = {k: full[k] for k in _flatten_paths(_batch_spec(cfg, BATCH)) if "/" not in k}
                if cfg.with_camera:
                    b["mats"] = full["mats"]
                if mode == "host_voxels":
                    b = dict(voxelize_batch(full, cfg, dev, training=False), gt_boxes=full["gt_boxes"])
                batches.append(b)
            det = Detector(cfg, random_state_dict(cfg, seed=seed), device=dev)
            calibrate_batchnorm(det.model, model_inputs(batches[0], cfg, dev, training=False))
            if cfg.with_lidar:  # the stages' active sites of each batch
                sites = []
                for b in batches:
                    kw = model_inputs(b, cfg, dev, training=False)
                    rb = build_rulebooks(kw["voxel_feats"].float(), kw["voxel_coords"],
                                         stage_shapes(cfg.lidar_encoder.grid_size))
                    sites.append([st.keys.numel() for st in rb.sites])
                if any(a == b for a, b in zip(*sites)):
                    raise RuntimeError(f"[export {name}] the two batches share a stage's site count: {sites}")
            else:
                sites = None
            # the live detector: ROIs, one request's launches, latency
            recorders = ([Recorder(bev_pool, "bev_pool_cells_cuda"), Recorder(sparse_conv, "sparse_conv_cuda"),
                          Recorder(nms, "rotated_iou_mask_cuda"), Recorder(nms, "nms_greedy_select_cuda")]
                         if mode == "points" and name != "fusion" else [])
            with contextlib.ExitStack() as stack:
                for r in recorders:
                    stack.enter_context(r)
                rois = [det.predict(batches[0])]
            rois.append(det.predict(batches[1]))
            for r in recorders:
                if r.calls:
                    recorded.setdefault(r.name, [a for a, _ in r.calls])
            torch.cuda.synchronize()
            build.reset_launches()
            det.predict(batches[0])
            torch.cuda.synchronize()
            live_launches = dict(build.LAUNCHES)
            lat = []
            for _ in range(EXPORT_LATENCY_CALLS):
                t0 = time.perf_counter()
                det.predict(batches[0])
                torch.cuda.synchronize()
                lat.append(time.perf_counter() - t0)
            path = str(Path(tmp) / name.replace(" ", "_"))
            t0 = time.perf_counter()
            export_detector(cfg, det.model.state_dict(), path, batch_size=BATCH, input_mode=mode, device=dev)
            export_s = time.perf_counter() - t0
            live[name] = dict(rois=[{k: v.cpu().numpy() for k, v in r.items()} for r in rois],
                              launches=live_launches, ms=statistics.median(lat) * 1e3, export_s=export_s,
                              mb=os.path.getsize(Path(path) / "model.pt2") / 1e6, sites=sites)
            jobs[name] = dict(path=path, batches=[_numpy_tree(b) for b in batches])
            del det, batches, rois
            torch.cuda.empty_cache()
        del full_batches
        with open(Path(tmp) / "jobs.pkl", "wb") as f:
            pickle.dump(jobs, f)
        del jobs
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "load-artifacts",
                               str(Path(tmp) / "jobs.pkl"), str(Path(tmp) / "out.pkl")],
                              capture_output=True, text=True, timeout=EXPORT_LOAD_TIMEOUT_S)
        process_s = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"[export] the loading process failed:\n{proc.stdout[-3000:]}\n{proc.stderr[-6000:]}")
        with open(Path(tmp) / "out.pkl", "rb") as f:
            loaded = pickle.load(f)
    if loaded["modules"]:
        raise RuntimeError(f"[export] the loading process imported {loaded['modules']}")
    for name, _, mode, _ in cases:
        got, ref = loaded[name], live[name]
        errs, bit_equal = {}, True
        for g, r in zip(got["rois"], ref["rois"]):
            for k in ("mask", "labels"):
                if not np.array_equal(g[k], r[k]):
                    raise RuntimeError(f"[export {name}] the loaded artifact's {k} differ from the live detector's")
            for k in ("boxes", "scores"):
                d = float(np.abs(g[k].astype(np.float64) - r[k]).max())
                errs[k] = max(errs.get(k, 0.0), d)
                bit_equal &= bool(np.array_equal(g[k], r[k]))
                if d > EXPORT_TOL_OF_MAX * max(1.0, float(np.abs(r[k]).max())):
                    raise RuntimeError(f"[export {name}] {k} differ by {d:.3e} from the live detector's")
        if got["launches"] != ref["launches"]:
            raise RuntimeError(f"[export {name}] the loaded artifact launched {got['launches']} a request, "
                               f"the live detector {ref['launches']}")
        log(f"export {name}", input_mode=mode, batch=BATCH, export_s=f"{ref['export_s']:.2f}",
            artifact_mb=f"{ref['mb']:.1f}", load_s=f"{got['load_s']:.2f}",
            loaded_program_ms=f"{got['program_ms']:.3f}", live_predict_ms=f"{ref['ms']:.3f}",
            loaded_over_live=f"{got['program_ms'] / ref['ms']:.4f}",
            loaded_predict_ms_numpy=f"{got['predict_ms']:.3f}", latency_calls=EXPORT_LATENCY_CALLS,
            launches=json.dumps(got["launches"], sort_keys=True),
            kept_boxes=[int(r["mask"].sum()) for r in got["rois"]], sites_per_stage=ref["sites"],
            bit_equal=str(bit_equal).lower(), max_abs_err_boxes=f"{errs['boxes']:.3e}",
            max_abs_err_scores=f"{errs['scores']:.3e}", tol=f"masks and labels equal, "
            f"boxes and scores within {EXPORT_TOL_OF_MAX} of max(1, max|ref|)")
    log("export", seconds=f"{time.time() - t_phase:.1f}", loading_process_s=f"{process_s:.1f}",
        loading_process_modules="none of models/layers/training")
    return recorded


def host_us(fn, n=None):
    """Median host time of one call of fn, the card idle before each call:
    the time to return, the launch's enqueue included, the kernel's run not."""
    import statistics
    ts = []
    for _ in range(n or LAUNCH_PATH_CALLS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    torch.cuda.synchronize()
    return statistics.median(ts) * 1e6


def launch_path_phase(recorded) -> None:
    """Each op's dispatch (`torch.ops.unidistill.*`) against a direct call of
    its bare ctypes wrapper, on the arguments recorded in the export phases'
    live requests (K1-K4) and on those shapes' gradients (K5, K4 dgrad, K6):
    host µs a call (median of LAUNCH_PATH_CALLS, the card idle before each
    call) and the device ms of all the calls' kernels from torch.profiler,
    with the two results equal bit for bit."""
    from unidistill_torch.experiments.harness import kernel_ms
    from unidistill_torch.ops import bev_pool, nms, sparse_conv
    ops = torch.ops.unidistill
    gen = torch.Generator(device="cuda").manual_seed(7)
    pool = recorded["bev_pool_cells_cuda"][0]
    cell, depth, context, ncells = pool
    g_pool = torch.randn(depth.shape[0], ncells, context.shape[-1], device="cuda", generator=gen)
    convs = [a[:3] + (a[3] if len(a) > 3 else None,) for a in recorded["sparse_conv_cuda"]]
    grads = []
    for f, nbr, w, b in convs:
        g = torch.randn(nbr.shape[0], w.shape[2], device="cuda", generator=gen).to(f.dtype)
        grads.append((f, nbr, w, g, sparse_conv.transpose_rules(nbr, f.shape[0])))
    dgrads = [(g, nbr_t, w) for f, nbr, w, g, nbr_t in grads if w.shape[1] in sparse_conv.K4_COUTS]
    wgrads = [(f, g, nbr) for f, nbr, w, g, nbr_t in grads]
    rows = (
        ("bev_pool", "K1", ops.bev_pool, bev_pool.bev_pool_cells_cuda, [pool]),
        ("bev_pool_bwd", "K5", ops.bev_pool_bwd, bev_pool.bev_pool_bwd_cuda, [(cell, depth, context, g_pool, ncells)]),
        ("rotated_iou_mask", "K2", ops.rotated_iou_mask, nms.rotated_iou_mask_cuda,
         recorded["rotated_iou_mask_cuda"][:1]),
        ("nms_greedy_select", "K3", ops.nms_greedy_select, nms.nms_greedy_select_cuda,
         recorded["nms_greedy_select_cuda"][:1]),
        ("sparse_conv", "K4", ops.sparse_conv, sparse_conv.sparse_conv_cuda, convs),
        ("sparse_conv_dgrad", "K4 dgrad", ops.sparse_conv_dgrad, sparse_conv.sparse_conv_dgrad_cuda, dgrads),
        ("sparse_conv_wgrad", "K6", ops.sparse_conv_wgrad, sparse_conv.sparse_conv_wgrad_cuda, wgrads),
    )
    with torch.no_grad():
        for name, kernel, op, bare, calls in rows:
            for args in calls:
                a, b = op(*args), bare(*args)
                for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
                    if not torch.equal(x, y):
                        raise RuntimeError(f"[launch path] unidistill::{name} and its bare wrapper differ")
            # op, bare, bare, op: the host clock drifts
            us = {"op": [], "bare": []}
            for which in ("op", "bare", "bare", "op"):
                fn = op if which == "op" else bare
                us[which].append(sum(host_us(lambda: fn(*args)) for args in calls) / len(calls))
            dev_ms = {w: kernel_ms(lambda: [(op if w == "op" else bare)(*args) for args in calls], None, iters=5)
                      for w in ("op", "bare")}
            op_us, bare_us = sum(us["op"]) / 2, sum(us["bare"]) / 2
            log("launch path", op=f"unidistill::{name}", kernel=repr(kernel), calls=len(calls),
                host_us_op=f"{op_us:.1f}", host_us_bare=f"{bare_us:.1f}", added_us=f"{op_us - bare_us:.1f}",
                device_ms_op=f"{dev_ms['op']:.4f}" if dev_ms["op"] is not None else "not measured",
                device_ms_bare=f"{dev_ms['bare']:.4f}" if dev_ms["bare"] is not None else "not measured",
                rounds=[round(x, 1) for x in us["op"] + us["bare"]], bit_equal="true")


def flops_phase(dev, batch_np, teacher_sd) -> None:
    """`utils.flops.model_flops_per_frame` of the three eval forwards (batch
    4, seeded weights and clouds), and `matmul_flops` of one camera<-LiDAR
    distill step (forward + backward) on the distill train batch, a frame;
    the JAX package's pins beside them (a sanity note: the JAX LiDAR counts
    stage caps, the port the clouds' sites)."""
    from unidistill_torch.configs.nuscenes import DISTILL_VARIANTS, camera_exp, distill_exp, fusion_exp, lidar_exp
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.training import steps
    from unidistill_torch.training.train_state import TrainState, make_optimizer
    from unidistill_torch.utils.flops import matmul_flops, model_flops_per_frame
    t0 = time.time()
    for name, exp in (("camera", camera_exp), ("lidar", lidar_exp), ("fusion", fusion_exp)):
        got = model_flops_per_frame(exp().model, batch=BATCH, device=dev)
        log("flops", path=f"{name} eval forward", batch=BATCH, tflop_per_frame=f"{got['total'] / 1e12:.4f}",
            dense_conv=f"{got['conv'] / 1e12:.4f}", sparse_conv=f"{got['sparse_conv'] / 1e12:.4f}",
            matmul=f"{got['dot_general'] / 1e12:.4f}", jax_pin=f"{JAX_FLOPS_PINS[name] / 1e12:.3f}")
        torch.cuda.empty_cache()
    s_cfg, t_cfg = camera_exp().model, lidar_exp().model
    teacher = BEVFusionCenterHead(t_cfg)
    teacher.load_state_dict(teacher_sd)
    teacher.to(dev).requires_grad_(False).eval()
    student = student_model(s_cfg, 0, dev)
    opt = make_optimizer(student, distill_exp("lidar", "camera").train)
    state = TrainState()
    batch = to_device(batch_np, dev)
    got = matmul_flops(lambda: steps.distill_train_step(state, batch, student, teacher, opt, s_cfg, t_cfg,
                                                        DISTILL_VARIANTS[("lidar", "camera")]))
    log("flops", path="distill lidar->camera step (teacher forward, student forward + backward)", batch=BATCH,
        tflop_per_frame=f"{got['total'] / BATCH / 1e12:.4f}", dense_conv=f"{got['conv'] / BATCH / 1e12:.4f}",
        sparse_conv=f"{got['sparse_conv'] / BATCH / 1e12:.4f}",
        matmul=f"{got['dot_general'] / BATCH / 1e12:.4f}", seconds=f"{time.time() - t0:.1f}")
    del teacher, student, opt, state, batch
    torch.cuda.empty_cache()


def repo_files() -> dict:
    """Every file under the checkout but bytecode caches and the kernel
    build, with its size and modification time."""
    out = {}
    for path in ROOT.rglob("*"):
        rel = path.relative_to(ROOT)
        if path.is_file() and "__pycache__" not in rel.parts and rel.parts[:1] != ("build",):
            st = path.stat()
            out[str(rel)] = (st.st_size, st.st_mtime_ns)
    return out


def cli_run(phase, fn, argv, want):
    """One launcher run (`fn(argv=...)`) with every launch count set to 0
    just before and read just after; each kernel in `want` must launch
    exactly that often (a count) or at least once (None). Returns the
    trainer, the launches and the logged step records; no loader worker
    may outlive the run."""
    import gc
    import multiprocessing
    from unidistill_torch.kernels import build
    build.reset_launches()
    t0 = time.time()
    trainer = fn(argv=argv)
    seconds = time.time() - t0
    launches = dict(build.LAUNCHES)
    gc.collect()
    if multiprocessing.active_children():
        raise RuntimeError(f"{phase}: loader workers still running: {multiprocessing.active_children()}")
    with open(Path(trainer.output_dir) / "metrics.jsonl") as f:
        records = [json.loads(line) for line in f]
    steps_logged = [r for r in records if "step" in r]
    log(phase, seconds=f"{seconds:.2f}", launches=json.dumps(launches, sort_keys=True),
        logged_steps=[r["step"] for r in steps_logged],
        s_per_step=[round(r["sec_per_step"], 4) for r in steps_logged],
        loader_wait_s_per_step=[round(r["loader_wait_sec_per_step"], 4) for r in steps_logged],
        **{k: f"{v:.6g}" for k, v in sorted((steps_logged[-1] if steps_logged else {}).items())
           if k.startswith("loss")})
    for k, n in want.items():
        if (launches.get(k, 0) == 0) if n is None else (launches.get(k, 0) != n):
            raise RuntimeError(f"{phase}: kernel {k} launched {launches.get(k, 0)} times, expected "
                               f"{'at least once' if n is None else n}")
    for r in steps_logged:
        bad = [k for k, v in r.items() if isinstance(v, float) and not math.isfinite(v)]
        if bad:
            raise RuntimeError(f"{phase}: non-finite metrics {bad} at step {r['step']}")
    return trainer, launches, steps_logged


def cli_data(tmp: Path, n_train: int, n_val: int, dev):
    """The launcher phase's inputs under `tmp`: an on-disk synthetic
    nuScenes (`serving.synthetic.write_nuscenes`, seed 50) and a seeded
    LiDAR teacher, BatchNorm calibrated on the validation frames as the
    loader voxelises them, saved as a checkpoint in tmp/teacher. Returns the
    data root, the teacher's state dict on the CPU, and the seconds of the
    write and of the teacher."""
    from unidistill_torch.configs.nuscenes import DataConfig, lidar_exp
    from unidistill_torch.data.collate import collate
    from unidistill_torch.data.dataset import NuScenesDataset
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.serving.synthetic import calibrate_batchnorm, random_state_dict, write_nuscenes
    from unidistill_torch.training import checkpoint as ckpt_lib
    from unidistill_torch.training.steps import model_inputs

    t0 = time.time()
    root = write_nuscenes(str(tmp / "nuscenes"), n_train, n_val, seed=50)
    write_s = time.time() - t0
    t_cfg = lidar_exp().model
    t0 = time.time()
    val = NuScenesDataset(DataConfig(root_path=root), t_cfg, "validation")
    frames = collate([val[i] for i in range(len(val))])
    teacher = BEVFusionCenterHead(t_cfg)
    teacher.load_state_dict(random_state_dict(t_cfg, seed=10))
    teacher.to(dev)
    calibrate_batchnorm(teacher, model_inputs(frames, t_cfg, dev, training=False))
    ckpt_lib.save_checkpoint(str(tmp / "teacher"), 0, teacher)
    saved = {k: v.detach().cpu().clone() for k, v in teacher.state_dict().items()}
    del teacher, frames
    torch.cuda.empty_cache()
    return root, saved, write_s, time.time() - t0


def cli_phases(dev) -> None:
    """[cli distill lidar->camera]: the camera<-LiDAR launcher's CLI at full
    width on an on-disk synthetic nuScenes in a temporary directory: one
    epoch from a saved LiDAR teacher, a resume to the second epoch (with
    validation), then the camera launcher's CLI with -e on the checkpoint."""
    import tempfile
    from unidistill_torch.configs.nuscenes import camera_exp
    from unidistill_torch.exps.base_cli import run_cli
    from unidistill_torch.exps.distill_cli import run_distill_cli
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.training import checkpoint as ckpt_lib
    from unidistill_torch.training.loop import init_params

    phase = "cli distill lidar->camera"
    t_phase = time.time()
    before = repo_files()
    with tempfile.TemporaryDirectory(prefix="unidistill_cli_") as tmp:
        tmp = Path(tmp)
        root, saved_teacher, write_s, teacher_s = cli_data(tmp, CLI_TRAIN_FRAMES, CLI_VAL_FRAMES, dev)
        log(f"{phase} data", train_frames=CLI_TRAIN_FRAMES, val_frames=CLI_VAL_FRAMES, cameras=6,
            image="900x1600 jpeg", sweeps=10, write_seconds=f"{write_s:.2f}",
            teacher_seconds=f"{teacher_s:.2f}")

        steps_per_epoch = CLI_TRAIN_FRAMES // BATCH
        common = ["-b", str(BATCH), "--num_workers", str(CLI_WORKERS), "--data_root", root,
                  "--exp_options", "data.use_cbgs=False", "train.eval_interval=2"]
        per_step = dict(sparse_conv_fwd=SPARSE_CONVS_PER_REQUEST * steps_per_epoch,
                        bev_pool_fwd=steps_per_epoch, bev_pool_bwd=steps_per_epoch)
        with contextlib.chdir(tmp):
            # ---- one epoch ------------------------------------------------------
            tr1, _, logged = cli_run(f"{phase} train", lambda argv: run_distill_cli("lidar", "camera", argv),
                                     common + ["--max_epochs", "1", "--teacher_ckpt", str(tmp / "teacher")],
                                     dict(per_step, rotated_iou_mask=0, nms_greedy_select=0))
            if [r["step"] for r in logged] != [steps_per_epoch]:
                raise RuntimeError(f"{phase}: one epoch logged steps {[r['step'] for r in logged]}")
            check_frozen(phase, tr1.teacher)
            for k, v in tr1.teacher.state_dict().items():
                if not torch.equal(v.cpu(), saved_teacher[k]):
                    raise RuntimeError(f"{phase}: the teacher's {k} changed")
            ckpt1 = ckpt_lib.restore_checkpoint_any(str(Path(tr1.output_dir) / "ckpt"))
            start = init_params(BEVFusionCenterHead(camera_exp().model), seed=0).state_dict()
            change = max((ckpt1["model"][k].float() - v.float()).abs().max().item()
                         for k, v in start.items() if v.is_floating_point())
            if not (ckpt1["step"] == steps_per_epoch and change > 0):
                raise RuntimeError(f"{phase}: step {ckpt1['step']}, parameter change {change}")

            # ---- resume to two epochs: only the second trains ---------------------
            tr2, _, logged = cli_run(
                f"{phase} resume", lambda argv: run_distill_cli("lidar", "camera", argv),
                common + ["--max_epochs", "2", "--teacher_ckpt", str(tmp / "teacher"),
                          "--ckpt_path", str(Path(tr1.output_dir) / "ckpt")],
                dict(per_step, bev_pool_fwd=None, rotated_iou_mask=None, nms_greedy_select=None))
            if [r["step"] for r in logged] != [2 * steps_per_epoch]:
                raise RuntimeError(f"{phase}: the resumed run logged steps {[r['step'] for r in logged]}, "
                                   f"expected [{2 * steps_per_epoch}]")
            ckpt2 = ckpt_lib.restore_checkpoint_any(str(Path(tr2.output_dir) / "ckpt"))
            if ckpt2["step"] != 2 * steps_per_epoch:
                raise RuntimeError(f"{phase}: the resumed run ended at step {ckpt2['step']}")
            for k, v in tr2.model.state_dict().items():
                if not torch.equal(v.cpu(), ckpt2["model"][k]):
                    raise RuntimeError(f"{phase}: the last checkpoint's {k} differs from the trained model's")
            with open(Path(tr2.output_dir) / "metrics.jsonl") as f:
                val_recs = [r for r in map(json.loads, f) if r.get("event") == "val"]
            if len(val_recs) != 1 or "eval_error" in val_recs[0]:
                raise RuntimeError(f"{phase}: validation records {val_recs}")

            # ---- -e with the camera launcher's CLI ------------------------------------
            tr3, _, _ = cli_run(f"{phase} evaluate", lambda argv: run_cli(camera_exp(), argv=argv),
                                ["-e", "--ckpt_path", str(Path(tr2.output_dir) / "ckpt"), "-b", str(BATCH),
                                 "--num_workers", str(CLI_WORKERS), "--data_root", root],
                                dict(bev_pool_fwd=None, rotated_iou_mask=None, nms_greedy_select=None,
                                     sparse_conv_fwd=0, bev_pool_bwd=0))
            with open(Path(tr3.output_dir) / "nuscenes" / "metrics_summary.json") as f:
                scores = json.load(f)
        numbers = dict(mAP=scores["mean_ap"], NDS=scores["nd_score"], **scores["tp_errors"])
        bad = [k for k, v in numbers.items() if not math.isfinite(v)]
        if bad or len(numbers) != 7:
            raise RuntimeError(f"{phase}: scores {numbers}")
        log(f"{phase} scores", **{k: f"{v:.6g}" for k, v in numbers.items()},
            val_mAP=f"{val_recs[0]['mean_ap']:.6g}")
    written = sorted(set(repo_files().items()) - set(before.items()))
    if written:
        raise RuntimeError(f"{phase}: files written under the repository: {written[:10]}")
    log(phase, wall_seconds=f"{time.time() - t_phase:.2f}", smi=repr(nvidia_smi_line()))


# ---- data parallelism -------------------------------------------------------


def rank_rows(batch, rank, b):
    """Rows [rank·b, (rank+1)·b) of a numpy batch: what the loader hands
    rank `rank` of each global batch."""
    return {k: rank_rows(v, rank, b) if isinstance(v, dict) else v[rank * b:(rank + 1) * b]
            for k, v in batch.items()}


def numpy_sd(sd):
    """A state dict as numpy arrays: what goes to a spawned rank (a tensor
    would go through a shared-memory file descriptor each)."""
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def tensor_sd(sd):
    return {k: torch.from_numpy(v) for k, v in sd.items()}


def ranks_hold_equal(model, group) -> bool:
    """Whether every rank of `group` holds rank 0's parameters, bit for bit
    (rank 0's broadcast and compared as int32 words)."""
    import torch.distributed as dist
    flat = torch.cat([p.detach().reshape(-1) for p in model.parameters()])
    ref = flat.clone()
    dist.broadcast(ref, src=0, group=group)
    same = torch.tensor([int(torch.equal(flat.view(torch.int32), ref.view(torch.int32)))])
    dist.all_reduce(same, op=dist.ReduceOp.MIN, group=group)
    return bool(same.item())


def tiny_distill(dev, tiny, group, n_steps=1):
    """`n_steps` tiny float32 camera<-LiDAR distill steps (student tamed)
    on `dev` over `group` (None: one process) on `tiny`'s batch (this
    rank's rows where `group` has two ranks). Returns the host metrics of
    each step, the last step's averaged gradients before the clip, and the
    parameters' change, on the CPU."""
    from unidistill_torch.configs.nuscenes import DISTILL_VARIANTS
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.training import steps
    from unidistill_torch.training.train_state import TrainState, make_optimizer
    s_cfg, t_cfg, s_sd, t_sd, batch, train_cfg = tiny
    student = BEVFusionCenterHead(s_cfg)
    student.load_state_dict(tensor_sd(s_sd))
    tame(student)
    start = {k: p.detach().clone() for k, p in student.named_parameters()}
    student.to(dev)
    teacher = BEVFusionCenterHead(t_cfg)
    teacher.load_state_dict(tensor_sd(t_sd))
    teacher.to(dev).requires_grad_(False)
    opt = make_optimizer(student, train_cfg)
    state = TrainState()
    batch = to_device(batch, dev)
    host = [steps.metrics_to_host(steps.distill_train_step(state, batch, student, teacher, opt, s_cfg, t_cfg,
                                                           DISTILL_VARIANTS[("lidar", "camera")], group))
            for _ in range(n_steps)]
    unclip = max(1.0, host[-1]["grad_norm"] / opt.grad_clip)  # .grad holds the clipped average
    grads = {k: (p.grad * unclip).cpu() for k, p in student.named_parameters()}
    change = {k: p.detach().cpu() - start[k] for k, p in student.named_parameters()}
    return host, grads, change


def card_vs_cpu_step(cpu, card, lr):
    """The worst disagreements of two tiny steps' (metrics, gradients,
    change): metrics relative; each gradient over its scale (max |g| of the
    tensor, at least 1e-3 of the largest |g|); the parameter change, over lr,
    where |g| exceeds 1e-3 of its scale (elsewhere the sign of Adam's first
    update may flip: that change is held to 2 lr)."""
    (m_c, g_c, d_c), (m_g, g_g, d_g) = cpu, card
    metric = max(abs(m_g[-1][k] - v) / max(abs(v), 1e-6) for k, v in m_c[-1].items())
    top = max(t.abs().max().item() for t in g_c.values())
    grad = change = flip = 0.0
    for k, ref in g_c.items():
        scale = max(ref.abs().max().item(), 1e-3 * top)
        grad = max(grad, (g_g[k] - ref).abs().max().item() / scale)
        sure = ref.abs() > 1e-3 * scale
        diff = (d_g[k] - d_c[k]).abs() / lr
        change = max(change, diff[sure].max().item() if sure.any() else 0.0)
        flip = max(flip, diff[~sure].max().item() if (~sure).any() else 0.0)
    return metric, grad, change, flip


def ddp_rank(rank, batch_np, teacher_sd, out_dir, tiny):
    """One rank of [ddp distill lidar->camera] and [ddp tiny], in a process
    of a gloo world on the one card (`parallel.launch.run_ranks`)."""
    import torch.distributed as dist
    from unidistill_torch.configs.nuscenes import DISTILL_VARIANTS, distill_exp, lidar_exp
    from unidistill_torch.kernels import build
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.training.loop import Trainer
    from unidistill_torch.training.steps import metrics_to_host
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    t_phase = time.time()

    # ---- the camera student at full width, through the Trainer's DP step ----
    pair = ("lidar", "camera")
    trainer = Trainer(distill_exp(*pair), output_dir=out_dir, device="cuda")  # joins the gloo world
    dev, group = trainer.device, trainer.group
    t_cfg = lidar_exp().model
    teacher = BEVFusionCenterHead(t_cfg)
    teacher.load_state_dict(tensor_sd(teacher_sd))
    teacher.to(dev).requires_grad_(False).eval()
    rows = to_device(rank_rows(batch_np, rank, DDP_RANK_BATCH), dev)
    state = trainer.init_state(steps_per_epoch=1)
    step = lambda: trainer.train_step(state, rows, (teacher, t_cfg, DISTILL_VARIANTS[pair]))  # noqa: E731
    metrics_to_host(step())  # warm-up
    equal = [ranks_hold_equal(trainer.model, group)]
    torch.cuda.synchronize()
    build.reset_launches()
    times, host, peaks = [], [], []
    for _ in range(TIMED_STEPS):
        dist.barrier(group=group)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        host.append(metrics_to_host(step()))  # the one read-back of a step
        times.append(time.perf_counter() - t0)
        peaks.append(torch.cuda.max_memory_allocated() / 2**30)
        equal.append(ranks_hold_equal(trainer.model, group))
    launches = dict(build.LAUNCHES)
    dcfg = DISTILL_VARIANTS[pair]
    totals = [h["loss_det"] + dcfg.w_feature * h["loss_feature"] + dcfg.w_rel * h["loss_bev_rel"]
              + dcfg.w_resp * (h["loss_resp_cls"] + h["loss_resp_reg"]) for h in host]
    all_totals = [None] * trainer.world_size
    dist.all_gather_object(all_totals, totals, group=group)
    if teacher.training or any(p.grad is not None for p in teacher.parameters()):
        raise RuntimeError(f"rank {rank}: the teacher was trained")
    trainer.close()
    del trainer, teacher, rows, state, step
    torch.cuda.empty_cache()
    full = dict(times=times, peak_gib=max(peaks), launches=launches, equal=equal, host=host,
                totals=all_totals, seconds=time.time() - t_phase)

    # ---- tiny: the same two-rank step on the card and on the CPU -------------
    t0 = time.time()
    tiny = dict(tiny, batch=rank_rows(tiny["batch"], rank, DDP_RANK_BATCH))
    args = tuple(tiny[k] for k in ("s_cfg", "t_cfg", "s_sd", "t_sd", "batch", "train_cfg"))
    cpu = tiny_distill(torch.device("cpu"), args, group)
    card = tiny_distill(dev, args, group)
    worst = card_vs_cpu_step(cpu, card, tiny["train_cfg"].lr)
    return dict(full=full, tiny=dict(worst=worst, loss_cpu=cpu[0][-1]["loss"], loss_card=card[0][-1]["loss"],
                                     seconds=time.time() - t0))


def ddp_phases(dev, batch_np, teacher_sd) -> None:
    """[ddp distill lidar->camera] and [ddp tiny] over two gloo ranks on the
    one card, then [ddp nccl]: world size 1 through `init_from_env`."""
    import dataclasses
    import tempfile
    from unidistill_torch.configs.nuscenes import camera_exp, distill_exp, tiny_model
    from unidistill_torch.parallel.launch import run_ranks
    from unidistill_torch.serving.synthetic import random_state_dict, train_batch

    s_tiny = dataclasses.replace(tiny_model(with_lidar=False), compute_dtype="float32")
    t_tiny = dataclasses.replace(tiny_model(with_camera=False), compute_dtype="float32")
    tiny = dict(s_cfg=s_tiny, t_cfg=t_tiny, s_sd=numpy_sd(random_state_dict(s_tiny, seed=2)),
                t_sd=numpy_sd(random_state_dict(t_tiny, seed=12)), batch=train_batch(s_tiny, t_tiny, BATCH, seed=25),
                train_cfg=distill_exp("lidar", "camera").train)
    phase = "ddp distill lidar->camera"
    t_phase = time.time()
    before = repo_files()
    with tempfile.TemporaryDirectory(prefix="unidistill_ddp_") as tmp:
        got = run_ranks(ddp_rank, DDP_RANKS, (batch_np, numpy_sd(teacher_sd), tmp, tiny),
                        ranks_per_card=DDP_RANKS, timeout_s=DDP_TIMEOUT_S)
    wall = time.time() - t_phase
    want = dict(bev_pool_fwd=1, bev_pool_bwd=1, sparse_conv_fwd=SPARSE_CONVS_PER_REQUEST)
    full = [g["full"] for g in got]
    for r, f in enumerate(full):
        for k, n in want.items():
            if f["launches"].get(k, 0) != n * TIMED_STEPS:
                raise RuntimeError(f"{phase}: rank {r} launched {k} {f['launches'].get(k, 0)} times in "
                                   f"{TIMED_STEPS} steps, expected {n} a step")
        if not all(f["equal"]):
            raise RuntimeError(f"{phase}: the ranks' parameters differ after steps {f['equal']}")
        for h in f["host"]:
            bad = [k for k, v in h.items() if not math.isfinite(v)]
            if bad:
                raise RuntimeError(f"{phase}: rank {r} non-finite metrics {bad}")
    loss_err = 0.0
    for i, h in enumerate(full[0]["host"]):
        mean = sum(t[i] for t in full[0]["totals"]) / DDP_RANKS
        loss_err = max(loss_err, abs(h["loss"] - mean) / abs(mean))
    if loss_err > DDP_LOSS_RTOL:
        raise RuntimeError(f"{phase}: rank 0's loss is {loss_err:.3e} from the mean of the ranks' totals")
    times = full[0]["times"]
    terms = {k: v for k, v in full[0]["host"][-1].items() if not k.startswith("task_")}
    log(phase, ranks=DDP_RANKS, backend="gloo", rank_batch=DDP_RANK_BATCH, global_batch=BATCH,
        steps=TIMED_STEPS, s_per_step=[round(t, 4) for t in times],
        global_frames_per_s=f"{BATCH * len(times) / sum(times):.3f}",
        peak_mem_gib_per_rank=[round(f["peak_gib"], 3) for f in full],
        launches_per_rank=json.dumps([f["launches"] for f in full], sort_keys=True),
        params_bit_equal_after_each_step="true", loss_vs_mean_of_rank_totals=f"{loss_err:.2e}",
        **{k: f"{v:.6g}" for k, v in sorted(terms.items())})
    log(phase, rank_totals=[[round(t, 4) for t in tt] for tt in full[0]["totals"]],
        rank_seconds=[round(f["seconds"], 2) for f in full], wall_seconds=f"{wall:.2f}",
        smi=repr(nvidia_smi_line()))

    # ---- [ddp tiny]: the two-rank step on the card against the CPU ------------
    worst = [max(w) for w in zip(*(g["tiny"]["worst"] for g in got))]
    log("ddp tiny", ranks=DDP_RANKS, loss_cpu=f"{got[0]['tiny']['loss_cpu']:.6g}",
        loss_card=f"{got[0]['tiny']['loss_card']:.6g}", metrics_rel_err=f"{worst[0]:.3e}",
        worst_grad_err_over_scale=f"{worst[1]:.3e}", change_err_over_lr=f"{worst[2]:.3e}",
        flip_change_over_lr=f"{worst[3]:.3e}", tol=(TRAIN_TINY_LOSS_RTOL, TRAIN_TINY_GRAD_TOL, 1e-2, 2.0),
        seconds=[round(g["tiny"]["seconds"], 2) for g in got])
    if (worst[0] > TRAIN_TINY_LOSS_RTOL or worst[1] > TRAIN_TINY_GRAD_TOL or worst[2] > 1e-2
            or worst[3] > 2.0):
        raise RuntimeError(f"ddp tiny: card vs CPU {worst} beyond the tolerances")

    # ---- [ddp nccl]: world size 1 through init_from_env -------------------------
    ddp_nccl_phase(dev, tiny)
    written = sorted(set(repo_files().items()) - set(before.items()))
    if written:
        raise RuntimeError(f"{phase}: files written under the repository: {written[:10]}")
    log("ddp", wall_seconds=f"{time.time() - t_phase:.2f}")


def ddp_nccl_phase(dev, tiny) -> None:
    """[ddp nccl]: two tiny distill steps through a `Trainer` that makes an
    NCCL group of one rank from `torchrun`'s environment, against the same
    steps with no group (twice: the card's own rerun spread)."""
    import os
    import tempfile
    from unidistill_torch.configs.nuscenes import DISTILL_VARIANTS, ExpConfig
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.parallel import mesh as parallel
    from unidistill_torch.parallel.launch import free_port
    from unidistill_torch.training.loop import Trainer
    from unidistill_torch.training.steps import metrics_to_host
    phase = "ddp nccl"
    t0 = time.time()
    args = tuple(tiny[k] for k in ("s_cfg", "t_cfg", "s_sd", "t_sd", "batch", "train_cfg"))
    plain = [tiny_distill(dev, args, None, n_steps=2) for _ in range(2)]
    env = dict(RANK="0", WORLD_SIZE="1", LOCAL_RANK="0", MASTER_ADDR="localhost", MASTER_PORT=str(free_port()),
               NCCL_SOCKET_IFNAME=os.environ.get("NCCL_SOCKET_IFNAME", "lo"))
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        with tempfile.TemporaryDirectory(prefix="unidistill_nccl_") as tmp:
            s_cfg, t_cfg, s_sd, t_sd, batch, train_cfg = args
            trainer = Trainer(ExpConfig(exp_name="ddp_nccl", model=s_cfg, train=train_cfg), output_dir=tmp,
                              device="cuda")
            try:
                if (trainer.group is None or torch.distributed.get_backend(trainer.group) != "nccl"
                        or trainer.world_size != 1):
                    raise RuntimeError(f"{phase}: the trainer made no NCCL group of one rank")
                state = trainer.init_state(steps_per_epoch=1)
                trainer.model.load_state_dict(tensor_sd(s_sd))
                tame(trainer.model)
                start = {k: p.detach().cpu().clone() for k, p in trainer.model.named_parameters()}
                teacher = BEVFusionCenterHead(t_cfg)
                teacher.load_state_dict(tensor_sd(t_sd))
                teacher.to(trainer.device).requires_grad_(False)
                tb = to_device(batch, trainer.device)
                host = [metrics_to_host(trainer.train_step(state, tb, (teacher, t_cfg, DISTILL_VARIANTS[
                    ("lidar", "camera")]))) for _ in range(2)]
                unclip = max(1.0, host[-1]["grad_norm"] / trainer.optimizer.grad_clip)
                nccl = (host, {k: (p.grad * unclip).cpu() for k, p in trainer.model.named_parameters()},
                        {k: p.detach().cpu() - start[k] for k, p in trainer.model.named_parameters()})
            finally:
                trainer.close()
        if parallel.is_initialized():
            raise RuntimeError(f"{phase}: the trainer left its group behind")
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v

    def diff(a, b):
        (ma, ga, da), (mb, gb, db) = a, b
        metric = max(abs(x[k] - y[k]) for x, y in zip(ma, mb) for k in x)
        tensors = max(max((ga[k] - gb[k]).abs().max().item(), (da[k] - db[k]).abs().max().item()) for k in ga)
        return max(metric, tensors)

    rerun, got = diff(plain[0], plain[1]), diff(nccl, plain[0])
    log(phase, backend="nccl", world_size=1, steps=2, max_abs_diff_vs_no_group=f"{got:.3e}",
        rerun_max_abs_diff=f"{rerun:.3e}", loss=f"{nccl[0][-1]['loss']:.6g}",
        bit_equal=str(got == 0.0).lower(), seconds=f"{time.time() - t0:.2f}")
    if got > DDP_NCCL_SPREAD * rerun:
        raise RuntimeError(f"{phase}: the NCCL steps differ from the steps with no group by {got:.3e}, "
                           f"beyond {DDP_NCCL_SPREAD} x the rerun spread {rerun:.3e}")


def microbench_phases(dev, table) -> None:
    """This slice's path: the sparse-conv microbenchmarks' entry points
    (smoke, the band gathers, the subm conv's prod and fused paths at the
    published stage sizes), then K7-K11 against their plain versions."""
    from unidistill_torch.configs.nuscenes import lidar_exp
    from unidistill_torch.experiments import mb_gather_pallas, mb_pallas_fused
    from unidistill_torch.experiments.harness import device_ms, kernel_geometry, poisoned_call
    from unidistill_torch.experiments.realistic import realistic_inputs
    from unidistill_torch.kernels import build
    from unidistill_torch.ops import band_gather as bg
    from unidistill_torch.ops import fused_offsets as fo
    from unidistill_torch.ops.sparse_conv_chunked import _OFFS8, _band_weight, _w_zyx, _window_table

    cfg = lidar_exp().model
    t0 = time.time()
    inputs, plan_s = realistic_inputs(cfg, MB_STAGES, device=dev)
    log("microbench inputs", frames=4, plan_seconds=f"{plan_s:.2f}",
        total_seconds=f"{time.time() - t0:.2f}",
        **{f"{st}_S_C_valid": f"{x.S},{x.C},{x.valid.sum(1).tolist()}" for st, x in inputs.items()})

    # ---- the entry points, launch counts from 0 ------------------------------
    torch.cuda.synchronize()
    build.reset_launches()
    mb_pallas_fused.main(["smoke"])
    mb_gather_pallas.main([])
    conv = {}
    for st in MB_STAGES:
        for variant in ("prod", "fused"):
            conv[st, variant] = mb_pallas_fused.run_one(st, variant, dev, cfg, x=inputs[st])
    torch.cuda.synchronize()
    launches = dict(build.LAUNCHES)
    log("microbench", launches=json.dumps(launches, sort_keys=True))
    for k in ("axpy2_bf16", "band_gather_fori", "band_gather_fori4", "band_gather_take",
              "band_gather_onehot", "fused_offsets"):
        if not launches.get(k):
            raise RuntimeError(f"microbench: kernel {k} was not launched")
    for st in MB_STAGES:
        ms_p, ms_f = conv[st, "prod"][0], conv[st, "fused"][0]
        _, derr, scale = conv[st, "fused"]
        log(f"subm prod vs fused {st}", prod_ms_per_conv=f"{ms_p:.4f}", fused_ms_per_conv=f"{ms_f:.4f}",
            max_abs_diff=f"{derr:.3e}", max_abs_prod=f"{scale:.3e}", tol=f"{FUSED_VS_PROD_TOL_OF_MAX}*max|prod|")
        if not derr <= FUSED_VS_PROD_TOL_OF_MAX * scale:
            raise RuntimeError(f"{st}: the fused conv differs from prod by {derr:.3e} (max |prod| {scale:.3e})")

    # ---- K8 smoke -------------------------------------------------------------
    # device time (profiler) beside CUDA events: at [256, 256] back-to-back
    # events time the wrappers' host work; the output in a NaN-filled block
    # (an earlier same-size result left in the pool would pass a K8 that
    # skips values)
    gen = torch.Generator().manual_seed(31)
    x = torch.randn(256, 256, generator=gen).mul(4).to(torch.bfloat16).to(dev)
    y = torch.randn(256, 256, generator=gen).to(torch.bfloat16).to(dev)
    ref = fo.smoke_plain(x, y)
    for attempt in ("first", "rerun"):
        got = poisoned_call(lambda: fo.axpy2_cuda(x, y), x.numel() * 2)
        if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
            raise RuntimeError(f"K8 ({attempt} call) differs from 2x + y rounded once")
    ms, source, events_ms = device_ms(lambda: fo.axpy2_cuda(x, y), "axpy2_kernel")
    plain_ms = cuda_ms(lambda: fo.smoke_plain(x, y), iters=50)
    library_ms, library_source, library_events_ms = device_ms(lambda: torch.add(y, x, alpha=2), None)
    bound = 3 * x.numel() * 2 / HBM_BYTES_PER_S * 1e3
    geometry = {}
    for who, fn, kname in (("", lambda: fo.axpy2_cuda(x, y), "axpy2_kernel"),
                           ("library_", lambda: torch.add(y, x, alpha=2), None)):
        found = kernel_geometry(fn, kname)
        if len(found) != 1:  # a profiler gap is no fault of the kernel's: say so and go on
            geometry[f"{who}kernel"] = f"'{len(found)} distinct launches recorded'"
            continue
        (g,) = found
        geometry.update({f"{who}kernel": repr(g["name"][:72]), f"{who}grid": g["grid"][0],
                         f"{who}block": g["block"][0], f"{who}registers": g["registers"],
                         f"{who}values_per_thread": x.numel() // g["threads"]})
    log("K8 smoke", shape=list(x.shape), bit_equal=True, bit_identical=True, ms=f"{ms:.5f}", ms_source=source,
        events_ms=f"{events_ms:.5f}", plain_ms=f"{plain_ms:.5f}", library_ms=f"{library_ms:.5f}",
        library_ms_source=library_source, library_events_ms=f"{library_events_ms:.5f}",
        bound_ms=f"{bound:.6f}", bound_share=f"{bound / ms:.3f}", ms_over_library=f"{ms / library_ms:.3f}",
        **geometry)
    table.append(dict(name="axpy2_bf16", route="cuda", source="unidistill_torch/csrc/fused_offsets.cu",
                      replaces="experiments/mb_pallas_fused.py:134", launches=launches["axpy2_bf16"],
                      max_abs_err=0.0, ms=ms, ms_source=source, plain_ms=plain_ms, bound_ms=bound,
                      bound_by="bytes", library_ms=library_ms, library_ms_source=library_source))
    del x, y, ref, got

    # ---- K9-K11: the band gathers ------------------------------------------------
    S, W, R, band = mb_gather_pallas.S, mb_gather_pallas.W, mb_gather_pallas.R, mb_gather_pallas.BAND
    tab, idx, w = mb_gather_pallas.make_inputs(0, S, W, R, band, device=dev)
    ref = bg.band_gather_plain(tab, idx, w, R, band)
    src = bg.band_source_rows(idx, w, R, band).long()
    # the bytes the gather needs: each distinct source row read once, the
    # output written once, the indices and band starts read once
    n_src = int(src.unique().numel())
    nbytes = (n_src + ref.shape[0]) * W * 2 + idx.numel() * 4 + w.numel() * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    library_ms, library_source, library_events_ms = device_ms(lambda: tab.index_select(0, src), None)
    # K11's products, per n8 tile of columns: the (m16 group, k16 slab) pairs
    # it runs (modelled), and the dense product's ceil(S / 16) x band / 16
    pairs = int(bg.onehot_slabs_plain(idx, w, R, band)[1].numel())
    dense_pairs = -(-S // 16) * (band // 16)
    nbytes_out = ref.numel() * ref.element_size()
    mma_ops = 2 * 16 * 8 * 16  # one m16n8k16
    for label, key, kname, fn, replaces in (
            ("K9 fori", "band_gather_fori", "band_gather_fori_kernel<1>",
             lambda: bg.band_gather_fori(tab, idx, w, R, band, unroll=1), "experiments/mb_gather_pallas.py:140"),
            ("K9 fori4", "band_gather_fori4", "band_gather_fori_kernel<4>",
             lambda: bg.band_gather_fori(tab, idx, w, R, band, unroll=4), "experiments/mb_gather_pallas.py:140"),
            ("K10 take", "band_gather_take", "band_gather_take_kernel",
             lambda: bg.band_gather_take(tab, idx, w, R, band), "experiments/mb_gather_pallas.py:160"),
            ("K11 onehot", "band_gather_onehot", "band_gather_onehot_kernel",
             lambda: bg.band_gather_onehot(tab, idx, w, R, band), "experiments/mb_gather_pallas.py:184")):
        # each output in a block just filled with NaN: index_select above
        # left the right answer in same-size blocks of the pool
        got = poisoned_call(fn, nbytes_out)
        if not torch.equal(got.view(torch.int16), ref.view(torch.int16)):
            bad = int((got.view(torch.int16) != ref.view(torch.int16)).any(1).sum().item())
            raise RuntimeError(f"{label}: {bad} rows differ from the plain gather")
        if not torch.equal(poisoned_call(fn, nbytes_out).view(torch.int16), got.view(torch.int16)):
            raise RuntimeError(f"{label}: two runs on the same inputs are not bit-identical")
        ms, source, events_ms = device_ms(fn, kname)
        plain_ms = cuda_ms(lambda: bg.band_gather_plain(tab, idx, w, R, band))
        extra = {}
        ops = 0
        if key == "band_gather_onehot":
            ops = pairs * (W // 8) * mma_ops
            extra = dict(products_per_n8_tile=pairs, dense_products_per_n8_tile=dense_pairs,
                         n8_tiles=W // 8, products_per_group=f"{pairs / -(-S // 16):.3f}",
                         dense_ops_ms=f"{2 * S * band * W / BF16_OPS_PER_S * 1e3:.4f}")
        ops_ms = ops / BF16_OPS_PER_S * 1e3
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        log(label, rows=S, W=W, R=R, band=band, distinct_source_rows=n_src, bit_equal=True, bit_identical=True,
            ms=f"{ms:.4f}", ms_source=source, events_ms=f"{events_ms:.4f}", ns_per_row=f"{ms / S * 1e6:.3f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}", library_ms_source=library_source,
            library_events_ms=f"{library_events_ms:.4f}", bound_ms=f"{max(bytes_ms, ops_ms):.4f}",
            bound_by=bound_by, bytes_ms=f"{bytes_ms:.4f}", ops_ms=f"{ops_ms:.4f}",
            bound_share=f"{max(bytes_ms, ops_ms) / ms:.3f}", ms_over_library=f"{ms / library_ms:.3f}", **extra)
        table.append(dict(name=key, route="cuda", source="unidistill_torch/csrc/band_gather.cu",
                          replaces=replaces, launches=launches[key], max_abs_err=0.0, ms=ms, ms_source=source,
                          plain_ms=plain_ms, bound_ms=max(bytes_ms, ops_ms), bound_by=bound_by,
                          library_ms=library_ms, library_ms_source=library_source))
    del tab, idx, w, ref, src, got
    torch.cuda.empty_cache()

    # ---- K7 on each stage's realistic inputs ------------------------------------
    # device time (profiler) beside CUDA events, the output in a NaN-filled
    # block (sites of a ragged last tile left unwritten would stay NaN), two
    # runs bit-identical
    for st in MB_STAGES:
        xs = inputs[st]
        C = xs.C
        tab = _window_table(xs.feats, xs.occ_bits, xs.colkey, xs.chunk, xs.valid, torch.bfloat16)
        W6 = _band_weight(_w_zyx(xs.weight), C, C, 6, 1, torch.bfloat16)
        g, oh = fo.offset_operands(tab, xs.tables, xs.S, C, torch.bfloat16)
        W8 = W6[list(_OFFS8)].contiguous()
        del tab, W6
        B, _, Sn, _ = g.shape
        co4 = W8.shape[2]
        k7 = lambda: fo.fused_offsets_cuda(g, oh, W8)  # noqa: E731
        got = poisoned_call(k7, B * Sn * co4 * 4)
        ref = fo.fused_offsets_plain(g, oh, W8)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        scale = ref.abs().max().item()
        if not err <= K7_TOL_OF_MAX * scale:
            raise RuntimeError(f"K7 at {st}: max |diff| {err:.3e} > {K7_TOL_OF_MAX} x max |ref| {scale:.3e}")
        if not torch.equal(poisoned_call(k7, B * Sn * co4 * 4), got):
            raise RuntimeError(f"K7 at {st}: two runs on the same inputs are not bit-identical")
        del ref
        ms, source, events_ms = device_ms(k7, "fused_offsets_kernel")
        plain_ms = cuda_ms(lambda: fo.fused_offsets_plain(g, oh, W8), iters=3)
        case = oh.argmax(-1, keepdim=True)
        g2 = torch.cat([torch.zeros_like(g[..., 0:4 * C]), g[..., 0:2 * C]], -1)

        def library():  # the separate path's select and products, in bf16
            win = torch.where(case == 0, g[..., 0:6 * C], torch.where(case == 1, g[..., 4 * C:], g2))
            return torch.einsum("bosw,owk->bsk", win, W8)
        library_ms = cuda_ms(library, iters=3)
        del g2, case
        # what this run's cases need (`k7_work`): the g lanes each case
        # reads (6C of a case-0 or case-1 row, 2C of a case-2 row), the
        # window lanes that can be nonzero times 4co for the products; W8's
        # L2 bytes when each block of K7_TILE_ROWS sites reads the stack
        rows = fo.K7_TILE_ROWS[co4]
        work = fo.k7_work(oh, C, co4, rows)
        n_case = oh.reshape(-1, 4).sum(0, dtype=torch.int64).tolist()
        bytes_ms, ops_ms = work["hbm_bytes"] / HBM_BYTES_PER_S * 1e3, work["ops"] / BF16_OPS_PER_S * 1e3
        bound = max(bytes_ms, ops_ms)
        bound_by = "bytes" if bytes_ms >= ops_ms else "operations"
        tiles = B * -(-Sn // rows)
        found = kernel_geometry(k7, "fused_offsets_kernel<")  # not the W8 tiling kernel before it
        if len(found) == 1:
            (geo,) = found
            if not 0 < geo["grid"][0] <= tiles:  # persistent blocks walk the tiles
                raise RuntimeError(f"K7 at {st}: grid {geo['grid']} for {tiles} tiles of {rows} sites")
            geometry = dict(grid=geo["grid"], block=geo["block"], registers=geo["registers"],
                            shared_bytes=geo["shared_bytes"])
        else:  # a profiler gap is no fault of the kernel's: say so and go on
            geometry = dict(kernel=f"'{len(found)} distinct launches recorded'")
        log(f"K7 fused_offsets {st}", B=B, S=Sn, C=C, co=C, rows_by_case=",".join(map(str, n_case)),
            max_abs_err=f"{err:.3e}", max_abs_ref=f"{scale:.3e}", tol=f"{K7_TOL_OF_MAX}*max|ref|",
            bit_identical=True, ms=f"{ms:.4f}", ms_source=source, events_ms=f"{events_ms:.4f}",
            plain_ms=f"{plain_ms:.4f}", library_ms=f"{library_ms:.4f}", bound_ms=f"{bound:.4f}", bound_by=bound_by,
            bytes_ms=f"{bytes_ms:.4f}", ops_ms=f"{ops_ms:.4f}", bound_share=f"{bound / ms:.3f}",
            ms_over_library=f"{ms / library_ms:.3f}", tile_rows=rows, tiles=tiles,
            w8_l2_mb=f"{work['w8_l2_bytes'] / 1e6:.1f}", hbm_mb=f"{work['hbm_bytes'] / 1e6:.1f}", **geometry)
        if st == "s2":
            table.append(dict(name="fused_offsets", route="cuda", source="unidistill_torch/csrc/fused_offsets.cu",
                              replaces="experiments/mb_pallas_fused.py:84", launches=launches["fused_offsets"],
                              max_abs_err=err, ms=ms, ms_source=source, plain_ms=plain_ms, bound_ms=bound,
                              bound_by=bound_by, library_ms=library_ms))
        del g, oh, W8, got
        torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    if not (ROOT / "unidistill_torch").is_dir():
        print("chip_smoke: run it from a checkout of the repository (unidistill_torch/ is missing)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from unidistill_torch.kernels import build

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
    if logs:  # a cached build keeps the report of the run that built it
        (build.BUILD_DIR / "nvcc.log").write_text("\n".join(f"== {k}\n{v}" for k, v in logs.items()))
    for name in build.SOURCES:
        build.library(name)
    log("build", seconds=f"{build_s:.2f}", built=",".join(sorted(logs)) or "cached")

    table = []
    camera_phases(dev, table)
    torch.cuda.empty_cache()
    lidar_phases(dev, table)
    torch.cuda.empty_cache()
    distill_inputs = train_phases(dev, table)
    torch.cuda.empty_cache()
    lidar_train_phases(dev, table)
    torch.cuda.empty_cache()
    swin_multisweep_phases(dev, distill_inputs[0])
    torch.cuda.empty_cache()
    components_phase(dev)
    torch.cuda.empty_cache()
    fusion_phases(dev)
    torch.cuda.empty_cache()
    launch_path_phase(export_phases(dev))
    torch.cuda.empty_cache()
    flops_phase(dev, *distill_inputs)
    torch.cuda.empty_cache()
    cli_phases(dev)
    torch.cuda.empty_cache()
    ddp_phases(dev, *distill_inputs)
    torch.cuda.empty_cache()
    microbench_phases(dev, table)

    log("done", seconds=f"{time.time() - t_start:.1f}")
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["load-artifacts"]:  # the export phases' loading process
        sys.exit(load_artifacts(*sys.argv[2:4]))
    sys.exit(main())
