"""Realistic inputs for the chunked sparse-conv microbenchmarks.

Counterparts of the JAX package's experiment helpers
`experiments/occupancy_profile.py::realistic_cloud` (a nuScenes-like 10-sweep
cloud: ~250k points, ground returns dominating, boxes of returns near the
ego vehicle, walls at the range boundary) and
`experiments/mb_subm_banded.py::realistic_stage_inputs` (planner tables for
B such clouds at one encoder stage, random features and weights), with the
same numpy seeds and RNG call order, so clouds, tables, features and weights
are bit-equal to the JAX harness's. Unlike the JAX harness, which plans every
frame again for each stage, `realistic_inputs` plans each frame once and
returns every stage asked for.
"""
from __future__ import annotations

import time
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from unidistill_torch.data.topology_host import plan_frame_topology, stage_shapes
from unidistill_torch.ops.sparse_conv_chunked import ChunkedTables, bits_of_occ, zmask
from unidistill_torch.ops.voxelize import voxelize

B = 4
STAGE_C = {"s0": 16, "s2": 32, "s3": 64}  # channels of the encoder's stages
_SFX = {"s0": "0", "s2": "2", "s3": "3"}


class StageInputs(NamedTuple):
    """One stage's conv inputs, in the chunked layout."""

    feats: torch.Tensor     # [B, S, 4·C] bf16, zero at absent z
    occ_bits: torch.Tensor  # [B, S] int32
    colkey: torch.Tensor    # [B, S] int32
    chunk: torch.Tensor     # [B, S] int32
    valid: torch.Tensor     # [B, S] bool
    tables: ChunkedTables   # nbr_idx, nbr_case [B, 9, S] int32
    weight: torch.Tensor    # [27, C, C] f32
    S: int
    C: int


def realistic_cloud(rng: np.random.RandomState, n: int = 250_000) -> np.ndarray:
    """[n, 5] f32 nuScenes-like point cloud drawn from `rng`."""
    pts = np.zeros((n, 5), np.float32)
    n_ground = int(n * 0.6)
    # radial density ~ 1/r (beam geometry)
    r = 2.0 + 52.0 * rng.power(0.45, n_ground)
    th = rng.uniform(0, 2 * np.pi, n_ground)
    pts[:n_ground, 0] = r * np.cos(th)
    pts[:n_ground, 1] = r * np.sin(th)
    pts[:n_ground, 2] = rng.normal(-1.8, 0.05, n_ground) + 0.01 * r
    k = n_ground
    # ~40 objects: boxes of returns
    n_obj = 40
    per = (n - n_ground) // (n_obj + 2)
    for _ in range(n_obj):
        cx, cy = rng.uniform(-40, 40, 2)
        w, l, h = rng.uniform(1.5, 3, 1)[0], rng.uniform(3, 8, 1)[0], rng.uniform(1.2, 3, 1)[0]
        pts[k:k + per, 0] = cx + rng.uniform(-l / 2, l / 2, per)
        pts[k:k + per, 1] = cy + rng.uniform(-w / 2, w / 2, per)
        pts[k:k + per, 2] = rng.uniform(-1.8, -1.8 + h, per)
        k += per
    # walls / buildings at the range boundary
    rest = n - k
    side = rng.uniform(30, 53, rest)
    ang = rng.uniform(0, 2 * np.pi, rest)
    pts[k:, 0] = side * np.cos(ang)
    pts[k:, 1] = side * np.sin(ang)
    pts[k:, 2] = rng.uniform(-1.8, 4.0, rest)
    pts[:, 3] = rng.uniform(0, 255, n)
    return pts


def voxelize_frame(points: np.ndarray, mask: np.ndarray, cfg, training: bool):
    """One frame [P, C] with its mask [P], voxelised on the host by
    `ops.voxelize.voxelize` at the config's train or eval voxel cap:
    (feats [V, C] f32, coords [V, 3] int32 (z, y, x), -1 on unused slots),
    as the JAX package's `data/voxelize_host.py::voxelize_frame`."""
    caps = cfg.caps
    feats, coords = voxelize(
        torch.from_numpy(points)[None], torch.from_numpy(mask)[None], cfg.point_cloud_range,
        cfg.voxel_size, cfg.grid_size, caps.max_voxels_train if training else caps.max_voxels_eval,
        caps.max_points_per_voxel)
    return feats[0].numpy(), coords[0].numpy()


def plan_frames(cfg, seed: int = 0, batch: int = B):
    """Voxelise `batch` realistic clouds (one RandomState(seed) stream) at the
    eval cap and plan each frame once: list of (topology dict, V)."""
    rng = np.random.RandomState(seed)
    frames = []
    for _ in range(batch):
        pts = realistic_cloud(rng)
        _, vc = voxelize_frame(pts, np.ones(len(pts), bool), cfg, training=False)
        topo = plan_frame_topology(vc, cfg.grid_size, cfg.lidar_encoder.stage_voxel_caps,
                                   s0_cap=cfg.lidar_encoder.s0_slot_cap)
        frames.append((topo, vc.shape[0]))
    return frames


def stage_inputs(frames, stage: str, grid_size, seed: int = 0, device="cpu") -> StageInputs:
    """One stage's inputs from planned frames: tables and occupancy from the
    planner, features and weights from numpy's default_rng(seed + 1)."""
    sfx = _SFX[stage]
    Bn = len(frames)
    if stage == "s0":
        occ = np.stack([bits_of_occ(torch.from_numpy(t["src0"] < V)).numpy() for t, V in frames])
    else:
        occ = np.stack([t[f"occ{sfx}"] for t, _ in frames])
    _, H, W = stage_shapes(grid_size)[("s0", "s2", "s3").index(stage)]
    C = STAGE_C[stage]
    ck = torch.from_numpy(np.stack([t[f"ck{sfx}"] for t, _ in frames])).to(device)
    ch = torch.from_numpy(np.stack([t[f"ch{sfx}"] for t, _ in frames])).to(device)
    pack = torch.from_numpy(np.stack([t[f"nbr{sfx}"] for t, _ in frames])).to(device)  # idx·4 + case
    occ_bits = torch.from_numpy(occ).to(device)
    S = ck.shape[1]
    nrng = np.random.default_rng(seed + 1)
    feats = torch.from_numpy(nrng.standard_normal((Bn, S, 4 * C)) * 0.1).to(torch.bfloat16)
    feats = zmask(occ_bits, C, feats.to(device))
    w = torch.from_numpy(nrng.standard_normal((27, C, C)) * 0.05).to(torch.float32).to(device)
    return StageInputs(feats, occ_bits, ck, ch, ck < H * W,
                       ChunkedTables(pack >> 2, pack & 3), w, S, C)


def realistic_inputs(cfg, stages: Sequence[str] = ("s0", "s2", "s3"), seed: int = 0,
                     batch: int = B, device="cpu") -> Tuple[Dict[str, StageInputs], float]:
    """The stages' inputs for `batch` realistic frames under model config
    `cfg` (`lidar_exp().model` for the published sizes), and the seconds
    that voxelising and planning the frames took."""
    t0 = time.time()
    frames = plan_frames(cfg, seed, batch)
    plan_s = time.time() - t0
    return {s: stage_inputs(frames, s, cfg.grid_size, seed, device) for s in stages}, plan_s
