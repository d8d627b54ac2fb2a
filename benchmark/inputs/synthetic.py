"""Seeded inputs of the benchmark, made on the device: weights, camera
batches, nuScenes-like LiDAR clouds and their GT boxes.

A frozen copy of the generators of the port's `serving/synthetic.py`
(`random_state_dict`, `calibrate_batchnorm`, `nuscenes_batch`,
`_lidar_scene`, `_cast_rays`, `_scene_sweeps`, `scene_gt_boxes`), reworked
so that set-up stays short: every draw comes from a `torch.Generator` on the
device, in a few large calls, and the ray casting runs on the device.
Each scene has a fixed number of cars, pedestrians and walls, so every seed
gives the same amount of work in another layout.

The weights follow the reference model's structure (`reference.model`):
He-scaled convolutions and linear layers, small biases, BatchNorm scales
near 0.3 and biases near 1; running statistics 0 and 1 until
`calibrate_batchnorm` sets them to those of one batch. With BatchNorm scales
near 1 and biases near 0 the random BN-ReLU network is chaotic: rounding to
bf16 moved its head maps by 83% and its BEV map by 18% against float32, so
that no comparison could tell bf16 from fp8. Scales near 0.3 and biases near
1 (the port's CPU tests tame their BatchNorms the same way) keep rounding
errors from growing with depth, as in a trained network.
"""
from __future__ import annotations

import math
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch import nn

CAR, PEDESTRIAN = 1, 9  # 1-based class ids of "car" and "pedestrian"

# nuScenes-like LiDAR: a 32-beam spinning sensor 1.84 m above the ground,
# 10 sweeps 0.05 s apart while the car drives 0.5 m per sweep
LIDAR_ELEVATION_DEG = (-30.67, 10.67)
LIDAR_BEAMS = 32
LIDAR_AZIMUTH_STEPS = 1080
LIDAR_HEIGHT = 1.84
LIDAR_SWEEPS = 10
LIDAR_SWEEP_DT = 0.05
LIDAR_EGO_STEP = 0.5
LIDAR_MAX_RANGE = 70.0
LIDAR_DROPOUT = 0.1
# BatchNorm affine parameters of the seeded weights: scales near BN_SCALE,
# biases near BN_SHIFT (see `random_state_dict`)
BN_SCALE, BN_SHIFT = 0.3, 1.0
# objects in every scene (the port's generator draws 15-29, 8-19 and 6-11)
SCENE_CARS, SCENE_PEDESTRIANS, SCENE_WALLS = 22, 14, 9


def generator(seed: int, stream: int, device) -> torch.Generator:
    """A generator on `device` for one stream of one seed (any integer seed)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 1_000_003 + stream) % (2**63 - 1))
    return g


def _uniform(g, lo, hi, shape, device) -> torch.Tensor:
    return lo + (hi - lo) * torch.rand(shape, generator=g, device=device)


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


def random_state_dict(model: nn.Module, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Seeded float32 weights for every entry of `model`'s state dict (a
    model of the reference's structure; on the meta device is enough), drawn
    in one `randn` call on `device`."""
    from benchmark.reference.common import ConvTranspose2d
    from benchmark.reference.lidar_encoder import SubMConv

    modules = dict(model.named_modules())
    state = model.state_dict()
    sizes = {k: t.numel() for k, t in state.items() if t.is_floating_point()}
    z = torch.randn(sum(sizes.values()), generator=g, device=device)
    out, at = {}, 0
    for key, t in state.items():
        mod_name, _, leaf = key.rpartition(".")
        mod = modules.get(mod_name)
        shape = tuple(t.shape)
        if leaf == "num_batches_tracked":
            out[key] = torch.zeros((), dtype=torch.int64, device=device)
            continue
        r = z[at: at + sizes[key]].view(shape)
        at += sizes[key]
        if key == "awl_params":
            v = torch.ones(shape, device=device)
        elif key == "det_head.out_bias":  # the head's init bias, -2.19 on the heatmap rows
            v = _head_bias(model, device) + 0.1 * r
        elif isinstance(mod, ConvTranspose2d) and leaf == "weight":
            v = r * (2.0 / shape[0]) ** 0.5
        elif isinstance(mod, nn.Conv2d) and leaf == "weight":
            v = r * (2.0 / (shape[1] * shape[2] * shape[3])) ** 0.5
        elif isinstance(mod, SubMConv) and leaf == "weight":  # [K, Cin, Cout]
            v = r * (2.0 / (shape[0] * shape[1])) ** 0.5
        elif isinstance(mod, nn.Linear) and leaf == "weight":
            v = r * (2.0 / shape[1]) ** 0.5
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm) and leaf == "weight":
            v = BN_SCALE * (1.0 + 0.1 * r)
        elif isinstance(mod, nn.modules.batchnorm._BatchNorm) and leaf == "bias":
            v = BN_SHIFT + 0.05 * r
        elif leaf == "running_var":
            v = torch.ones(shape, device=device)
        elif leaf == "running_mean":
            v = torch.zeros(shape, device=device)
        elif leaf == "bias":
            v = 0.05 * r
        else:
            raise KeyError(f"no rule for {key}")
        out[key] = v
    return out


def _head_bias(model: nn.Module, device) -> torch.Tensor:
    head = model.det_head
    bias = torch.zeros(len(head.branches), head.o_max, device=device)
    for i, (_tid, name, ch) in enumerate(head.branches):
        if name == "hm":
            bias[i, :ch] = -2.19
    return bias.reshape(-1)


@torch.no_grad()
def calibrate_batchnorm(model: nn.Module, inputs: Dict) -> None:
    """Every BatchNorm's running statistics set to those of one forward pass
    over `inputs` (keyword arguments of `model`); the model is left in eval
    mode and each BatchNorm with its own momentum."""
    bns = [m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
    momenta = [m.momentum for m in bns]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # cumulative average: one batch gives its own statistics
    model.train()
    model(**inputs)
    model.eval()
    for m, momentum in zip(bns, momenta):
        m.momentum = momentum
        m.num_batches_tracked.zero_()


# ---------------------------------------------------------------------------
# cameras
# ---------------------------------------------------------------------------


def camera_mats(num_cams: int, B: int, device) -> Dict[str, torch.Tensor]:
    """nuScenes-like camera matrices: six cameras around the ego car 1.6 m
    up, 1266 px focal length on the 1600×900 sensor, the image resized by
    0.44 and cropped 140 rows (the eval IDA), identity BDA."""
    yaws = np.deg2rad([0.0, -55.0, 55.0, 180.0, -110.0, 110.0])[:num_cams]
    s2e = np.zeros((B, num_cams, 4, 4), np.float32)
    for i, a in enumerate(yaws):
        fwd, right, down = [np.cos(a), np.sin(a), 0.0], [np.sin(a), -np.cos(a), 0.0], [0.0, 0.0, -1.0]
        s2e[:, i, :3, :3] = np.stack([right, down, fwd], axis=1)
        s2e[:, i, :3, 3] = [np.cos(a), np.sin(a), 1.6]
        s2e[:, i, 3, 3] = 1.0
    intrin = np.broadcast_to(np.eye(4, dtype=np.float32), (B, num_cams, 4, 4)).copy()
    intrin[..., 0, 0] = intrin[..., 1, 1] = 1266.0
    intrin[..., 0, 2], intrin[..., 1, 2] = 800.0, 450.0
    ida = np.broadcast_to(np.eye(4, dtype=np.float32), (B, num_cams, 4, 4)).copy()
    ida[..., 0, 0] = ida[..., 1, 1] = 0.44
    ida[..., 1, 3] = -140.0
    bda = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    mats = dict(sensor2ego_mats=s2e, intrin_mats=intrin, ida_mats=ida, bda_mat=bda)
    return {k: torch.from_numpy(v).to(device) for k, v in mats.items()}


def camera_batch(camera_cfg, B: int, g: torch.Generator, device) -> Dict:
    """Normalised random images [B, N, H, W, 3] and `camera_mats`."""
    H, W = camera_cfg.final_dim
    imgs = torch.randn(B, camera_cfg.num_cams, H, W, 3, generator=g, device=device)
    return dict(imgs=imgs, mats=camera_mats(camera_cfg.num_cams, B, device))


# ---------------------------------------------------------------------------
# LiDAR scenes and clouds
# ---------------------------------------------------------------------------


def lidar_scene(g: torch.Generator, device) -> torch.Tensor:
    """Boxes standing on the ground, [M, 7] (cx, cy, yaw, length, width,
    height, class id): cars and pedestrians within 45 m, walls (class 0) at
    30-50 m."""
    def ring(n, r_lo, r_hi):
        r, a = _uniform(g, r_lo, r_hi, n, device), _uniform(g, -math.pi, math.pi, n, device)
        return r * torch.cos(a), r * torch.sin(a), a
    u = lambda lo, hi, n: _uniform(g, lo, hi, n, device)
    nc, npd, nw = SCENE_CARS, SCENE_PEDESTRIANS, SCENE_WALLS
    x, y, _ = ring(nc, 5.0, 45.0)
    cars = torch.stack([x, y, u(-math.pi, math.pi, nc), u(4.0, 5.2, nc), u(1.7, 2.1, nc), u(1.4, 1.9, nc)], 1)
    x, y, _ = ring(npd, 4.0, 35.0)
    full = lambda v, n: torch.full((n,), v, device=device)
    peds = torch.stack([x, y, u(-math.pi, math.pi, npd), full(0.7, npd), full(0.7, npd), u(1.6, 1.9, npd)], 1)
    x, y, a = ring(nw, 30.0, 50.0)
    walls = torch.stack([x, y, a + math.pi / 2, u(10.0, 30.0, nw), full(0.5, nw), u(3.0, 9.0, nw)], 1)
    ids = torch.cat([full(CAR, nc), full(PEDESTRIAN, npd), full(0, nw)])
    return torch.cat([torch.cat([cars, peds, walls]), ids[:, None]], 1)


def cast_rays(origin: torch.Tensor, dirs: torch.Tensor, boxes: torch.Tensor) -> torch.Tensor:
    """Distance along each ray [R, 3] from its origin [R, 3] to the ground
    or the nearest box (inf where it hits nothing within range)."""
    inf = torch.tensor(float("inf"), device=dirs.device)
    t = torch.where(dirs[:, 2] < 0, -LIDAR_HEIGHT / dirs[:, 2], inf)
    cx, cy, yaw, length, width, height = boxes[:, :6].T
    c, s = torch.cos(yaw), torch.sin(yaw)
    px, py = origin[:, :1] - cx, origin[:, 1:2] - cy  # [R, M]
    pz = origin[:, 2:3] - (-LIDAR_HEIGHT + height / 2)
    p = (c * px + s * py, -s * px + c * py, pz.expand_as(px))
    d = (dirs[:, :1] * c + dirs[:, 1:2] * s, -dirs[:, :1] * s + dirs[:, 1:2] * c, dirs[:, 2:3].expand_as(px))
    t_near = torch.full_like(px, -float("inf"))
    t_far = torch.full_like(px, float("inf"))
    for pa, da, half in zip(p, d, (length / 2, width / 2, height / 2)):
        t1, t2 = (-half - pa) / da, (half - pa) / da
        t_near = torch.maximum(t_near, torch.nan_to_num(torch.minimum(t1, t2), nan=-float("inf")))
        t_far = torch.minimum(t_far, torch.nan_to_num(torch.maximum(t1, t2), nan=float("inf")))
    hit = (t_far >= t_near) & (t_near > 0)
    t = torch.minimum(t, torch.where(hit, t_near, inf).amin(1))
    return torch.where(t < LIDAR_MAX_RANGE, t, inf)


def scene_cloud(boxes: torch.Tensor, g: torch.Generator, device) -> torch.Tensor:
    """The 10 sweeps of a scene as one cloud [M, 5] (x, y, z, intensity, Δt)
    in the key frame's LiDAR frame: each sweep one turn of 32 beams at 1080
    azimuth steps, 10% of returns dropped, 2 cm range noise; sweep s taken
    0.05·s seconds earlier, 0.5·s metres behind."""
    S, n_az = LIDAR_SWEEPS, LIDAR_AZIMUTH_STEPS
    elev = torch.deg2rad(torch.linspace(*LIDAR_ELEVATION_DEG, LIDAR_BEAMS, device=device))
    az0 = _uniform(g, 0.0, 2 * math.pi, S, device)
    az = az0[:, None] + torch.arange(n_az, device=device) * (2 * math.pi / n_az)  # [S, n_az]
    e = elev[None, :, None].expand(S, LIDAR_BEAMS, n_az)
    a = az[:, None, :].expand(S, LIDAR_BEAMS, n_az)
    dirs = torch.stack([torch.cos(e) * torch.cos(a), torch.cos(e) * torch.sin(a), torch.sin(e)], -1).reshape(-1, 3)
    sweep = torch.arange(S, device=device).repeat_interleave(LIDAR_BEAMS * n_az)
    origin = torch.zeros(dirs.shape[0], 3, device=device)
    origin[:, 0] = -LIDAR_EGO_STEP * sweep
    t = cast_rays(origin, dirs, boxes)
    keep = torch.isfinite(t) & (torch.rand(t.shape, generator=g, device=device) >= LIDAR_DROPOUT)
    t = t + 0.02 * torch.randn(t.shape, generator=g, device=device)
    xyz = origin + t[:, None] * dirs
    intensity = _uniform(g, 0.0, 255.0, t.shape, device)
    cloud = torch.cat([xyz, intensity[:, None], (LIDAR_SWEEP_DT * sweep)[:, None].float()], 1)
    return cloud[keep]


def lidar_clouds(P: int, B: int, g: torch.Generator, device) -> Tuple[torch.Tensor, torch.Tensor, List[torch.Tensor]]:
    """B scenes' clouds padded to P points: points [B, P, 5], points_mask
    [B, P], and each scene's boxes. A cloud longer than P keeps P of its
    points, drawn at random and kept in order."""
    points = torch.zeros(B, P, 5, device=device)
    mask = torch.zeros(B, P, dtype=torch.bool, device=device)
    scenes = []
    for b in range(B):
        boxes = lidar_scene(g, device)
        scenes.append(boxes)
        cloud = scene_cloud(boxes, g, device)
        n = cloud.shape[0]
        if n > P:
            cloud = cloud[torch.randperm(n, generator=g, device=device)[:P].sort().values]
            n = P
        points[b, :n] = cloud
        mask[b, :n] = True
    return points, mask, scenes


def scene_gt_boxes(scenes: List[torch.Tensor], G: int, device) -> torch.Tensor:
    """The cars and pedestrians of each scene as gt_boxes [B, G, 10] (x, y,
    z, dx, dy, dz, rot, vx, vy, cls), standing on the ground, at rest; zero
    rows pad."""
    gt = torch.zeros(len(scenes), G, 10, device=device)
    for b, boxes in enumerate(scenes):
        obj = boxes[boxes[:, 6] > 0][:G]
        cx, cy, yaw, length, width, height, cls = obj.T
        zero = torch.zeros_like(cx)
        gt[b, : obj.shape[0]] = torch.stack(
            [cx, cy, -LIDAR_HEIGHT + height / 2, length, width, height, yaw, zero, zero, cls], 1)
    return gt


def train_batch(camera_cfg, max_points: int, max_gt_boxes: int, B: int, g: torch.Generator, device,
                with_points: bool) -> Dict:
    """A frame batch of a train or distill step: the camera batch, the
    boxes of B LiDAR scenes' cars and pedestrians and, `with_points`, the
    scenes' clouds (the LiDAR teacher's input)."""
    batch = camera_batch(camera_cfg, B, g, device)
    if with_points:
        points, mask, scenes = lidar_clouds(max_points, B, g, device)
        batch.update(points=points, points_mask=mask)
    else:
        scenes = [lidar_scene(g, device) for _ in range(B)]
    batch["gt_boxes"] = scene_gt_boxes(scenes, max_gt_boxes, device)
    return batch
