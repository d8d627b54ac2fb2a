"""Seeded stand-ins for a checkpoint and for camera and LiDAR batches, for
smoke runs and measurements on the card (no dataset and no trained weights
needed).

`random_state_dict(cfg, seed)` gives weights the detector (camera, LiDAR or
fusion) loads strictly;
`calibrate_batchnorm(model, inputs)` then sets every BatchNorm's running
statistics to those of one batch, so that activations keep a unit scale
through the random network (random statistics let them grow to ~1e5 at the
BEV map, where bf16 rounding hides every difference under test).
`nuscenes_batch(cfg, B, seed)` gives a batch with nuScenes-like camera
matrices: six cameras around the ego car 1.6 m up, 1266 px focal length on
the 1600×900 sensor, the image resized by 0.44 and cropped 140 rows (the IDA
of the eval pipeline), identity BDA, normalised random images.
`nuscenes_cells(cfg, B, seed)` are the flat BEV cells of the frustum points
under those cameras, as the camera encoder computes them; with a
`DataConfig`, under the training image augmentation (`train_ida_mats`:
random resize, crop, flip and rotation, drawn as the data pipeline draws
them), and with `pitch_deg`, under cameras tilted down by that angle.
`rich_mats(B, N, H, W)` are the small-image matrices of the JAX package's
full-model golden test, chosen so that frustum points land well inside BEV
cells (cell truncation is bitwise-sensitive at the edges).
`lidar_batch(cfg, B, seed)` gives nuScenes-like 10-sweep point clouds;
`train_batch(s_cfg, t_cfg, B, seed)` the frames of a train or distill step
of any detector or pair: camera images and matrices, LiDAR clouds and the
GT boxes of the clouds' scenes.
`nms_lanes(kind, seed)` gives score-sorted BEV candidate lanes for the NMS
kernels: candidates clustered around objects, or every box on one centre.
"""
from __future__ import annotations

import os
import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Tuple

import numpy as np
import torch
from PIL import Image
from torch import nn

from unidistill_torch.configs.nuscenes import CLASS_TO_IDX, DataConfig, ModelConfig
from unidistill_torch.data.evaluate import _rotmat_to_quat
from unidistill_torch.layers.lidar_encoder import SubMConv
from unidistill_torch.layers.lss import make_frustum, voxel_coords
from unidistill_torch.models.bevfusion import BEVFusionCenterHead
from unidistill_torch.ops.bev_pool import _linear_index

BatchNorm = nn.modules.batchnorm._BatchNorm


def random_state_dict(cfg: ModelConfig, seed: int = 0) -> Dict[str, torch.Tensor]:
    """Seeded random weights: He-scaled convs, BN scales near 1, small
    biases. The BN running statistics (0 and 1) are placeholders for
    `calibrate_batchnorm`."""
    g = torch.Generator().manual_seed(seed)
    model = BEVFusionCenterHead(cfg)
    modules = dict(model.named_modules())
    out = {}
    for key, t in model.state_dict().items():
        mod_name, _, leaf = key.rpartition(".")
        mod = modules.get(mod_name)
        randn = lambda: torch.randn(t.shape, generator=g)
        if leaf == "num_batches_tracked":
            v = torch.zeros((), dtype=torch.int64)
        elif key == "awl_params":
            v = torch.ones(t.shape)
        elif key == "det_head.out_bias":
            v = t.float() + 0.1 * randn()
        elif isinstance(mod, nn.ConvTranspose2d) and leaf == "weight":
            v = randn() * (2.0 / t.shape[0]) ** 0.5
        elif isinstance(mod, nn.Conv2d) and leaf == "weight":
            v = randn() * (2.0 / (t.shape[1] * t.shape[2] * t.shape[3])) ** 0.5
        elif isinstance(mod, SubMConv) and leaf == "weight":  # [K, Cin, Cout]
            v = randn() * (2.0 / (t.shape[0] * t.shape[1])) ** 0.5
        elif isinstance(mod, BatchNorm) and leaf == "weight":
            v = 1.0 + 0.1 * randn()
        elif leaf == "running_var":
            v = torch.ones(t.shape)
        elif leaf == "running_mean":
            v = torch.zeros(t.shape)
        elif leaf == "bias":
            v = 0.05 * randn()
        else:
            raise KeyError(f"no rule for {key}")
        out[key] = v
    return out


@torch.no_grad()
def calibrate_batchnorm(model: nn.Module, inputs: Dict) -> None:
    """Replace every BatchNorm's running statistics by the statistics of
    one forward pass over `inputs` (keyword arguments of `model`); leaves
    the model in eval mode and each BatchNorm with its own momentum. The
    LiDAR encoder's BatchNorms see its active voxels only: its feature rows
    are exactly those."""
    bns = [m for m in model.modules() if isinstance(m, BatchNorm)]
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


def _images(cfg: ModelConfig, B: int, rng: np.random.RandomState) -> np.ndarray:
    n = cfg.camera_encoder.num_cams
    H, W = cfg.camera_encoder.final_dim
    return rng.randn(B, n, H, W, 3).astype(np.float32)


def nuscenes_batch(cfg: ModelConfig, B: int, seed: int) -> Dict:
    rng = np.random.RandomState(seed)
    n = cfg.camera_encoder.num_cams
    yaws = np.deg2rad([0.0, -55.0, 55.0, 180.0, -110.0, 110.0])[:n]
    s2e = np.zeros((B, n, 4, 4), np.float32)
    for i, a in enumerate(yaws):
        fwd = [np.cos(a), np.sin(a), 0.0]
        right = [np.sin(a), -np.cos(a), 0.0]
        down = [0.0, 0.0, -1.0]
        s2e[:, i, :3, :3] = np.stack([right, down, fwd], axis=1)
        s2e[:, i, :3, 3] = [np.cos(a), np.sin(a), 1.6]
        s2e[:, i, 3, 3] = 1.0
    intrin = np.broadcast_to(np.eye(4, dtype=np.float32), (B, n, 4, 4)).copy()
    intrin[..., 0, 0] = intrin[..., 1, 1] = 1266.0
    intrin[..., 0, 2], intrin[..., 1, 2] = 800.0, 450.0
    ida = np.broadcast_to(np.eye(4, dtype=np.float32), (B, n, 4, 4)).copy()
    ida[..., 0, 0] = ida[..., 1, 1] = 0.44
    ida[..., 1, 3] = -140.0
    bda = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    return dict(imgs=_images(cfg, B, rng),
                mats=dict(sensor2ego_mats=s2e, intrin_mats=intrin, ida_mats=ida, bda_mat=bda))


def train_ida_mats(data: DataConfig, final_dim: Tuple[int, int], n: int,
                   rng: np.random.RandomState) -> np.ndarray:
    """IDA matrices [n, 4, 4] of the training image augmentation: for each
    image, a random resize, crop, horizontal flip and rotation within
    `data`'s limits, drawn in the data pipeline's order and composed as its
    pixel-space affine (scale, crop shift, mirror in the crop box, rotation
    about the crop's centre)."""
    H, W = data.src_h, data.src_w
    fH, fW = final_dim
    out = np.broadcast_to(np.eye(4), (n, 4, 4)).copy()
    for i in range(n):
        resize = rng.uniform(*data.ida_resize_lim)
        new_w, new_h = int(W * resize), int(H * resize)
        crop_h = int((1 - rng.uniform(*data.ida_bot_pct_lim)) * new_h) - fH
        crop_w = int(rng.uniform(0, max(0, new_w - fW)))
        flip = bool(data.ida_rand_flip and rng.choice([0, 1]))
        ang = np.deg2rad(rng.uniform(*data.ida_rot_lim))
        A, t = np.eye(2) * resize, -np.array([crop_w, crop_h], np.float64)
        if flip:
            A, t = np.diag([-1.0, 1.0]) @ A, np.array([fW - t[0], t[1]])
        R = np.array([[np.cos(ang), np.sin(ang)], [-np.sin(ang), np.cos(ang)]])
        ctr = np.array([fW, fH]) / 2.0
        out[i, :2, :2], out[i, :2, 3] = R @ A, R @ t + ctr - R @ ctr
    return out


def nuscenes_cells(cfg: ModelConfig, B: int, seed: int, data: Optional[DataConfig] = None,
                   pitch_deg: float = 0.0) -> torch.Tensor:
    """Flat BEV cells [B, N, D, fH, fW] int32 (nx·ny outside the grid) of the
    frustum points under `nuscenes_batch`'s cameras, on the CPU; under the
    training image augmentation of `data` (drawn from `seed`) if given, and
    with every camera tilted down by `pitch_deg`."""
    ce = cfg.camera_encoder
    mats = nuscenes_batch(cfg, B, seed)["mats"]
    if data is not None:
        rng = np.random.RandomState(seed)
        mats["ida_mats"] = train_ida_mats(data, ce.final_dim, B * ce.num_cams, rng).reshape(
            B, ce.num_cams, 4, 4).astype(np.float32)
    if pitch_deg:
        a = np.deg2rad(pitch_deg)  # about the camera's x axis (right): its z axis (forward) turns down
        tilt = np.array([[1, 0, 0], [0, np.cos(a), np.sin(a)], [0, -np.sin(a), np.cos(a)]], np.float32)
        mats["sensor2ego_mats"][..., :3, :3] = mats["sensor2ego_mats"][..., :3, :3] @ tilt
    mats = {k: torch.from_numpy(v) for k, v in mats.items()}
    ny, nx = ce.bev_hw
    return _linear_index(voxel_coords(ce, torch.from_numpy(make_frustum(ce)), mats), nx, ny, 1).int()


def rich_mats(B: int, N: int, H: int, W: int) -> Dict[str, np.ndarray]:
    cam2img = np.array(  # camera z -> ego x, x -> -y, y -> -z
        [[0, 0, 1, 0], [-1, 0, 0, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float32)
    s2e = np.zeros((B, N, 4, 4), np.float32)
    for n in range(N):
        a = 2 * np.pi * n / N + 0.37
        rz = np.array(
            [[np.cos(a), -np.sin(a), 0, 0.83], [np.sin(a), np.cos(a), 0, -0.29],
             [0, 0, 1, 0.41], [0, 0, 0, 1]], np.float32)
        s2e[:, n] = rz @ cam2img
    intrin = np.broadcast_to(np.eye(4, dtype=np.float32), (B, N, 4, 4)).copy()
    intrin[..., 0, 0] = intrin[..., 1, 1] = 17.0
    intrin[..., 0, 2] = W / 2 + 0.31
    intrin[..., 1, 2] = H / 2 - 0.17
    ida = np.broadcast_to(np.eye(4, dtype=np.float32), (B, N, 4, 4)).copy()
    ida[..., 0, 0] = 1.03
    ida[..., 1, 1] = 0.97
    ida[..., 0, 3] = 1.7
    ida[..., 1, 3] = -0.9
    th = 0.21
    bda = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    bda[:, 0, 0] = np.cos(th) * 1.05
    bda[:, 0, 1] = -np.sin(th) * 1.05
    bda[:, 1, 0] = np.sin(th) * 1.05
    bda[:, 1, 1] = np.cos(th) * 1.05
    return dict(sensor2ego_mats=s2e, intrin_mats=intrin, ida_mats=ida, bda_mat=bda)


def small_batch(cfg: ModelConfig, B: int, seed: int) -> Dict:
    """Random images with `rich_mats`, for small configurations."""
    H, W = cfg.camera_encoder.final_dim
    return dict(imgs=_images(cfg, B, np.random.RandomState(seed)),
                mats=rich_mats(B, cfg.camera_encoder.num_cams, H, W))


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


def _lidar_scene(rng: np.random.RandomState) -> np.ndarray:
    """Boxes standing on the ground, [M, 7] (cx, cy, yaw, length, width,
    height, class id): cars and pedestrians within 45 m, walls (class 0)
    at 30-50 m."""
    def ring(n, r_lo, r_hi):
        r, a = rng.uniform(r_lo, r_hi, n), rng.uniform(-np.pi, np.pi, n)
        return r * np.cos(a), r * np.sin(a), a
    n_car, n_ped, n_wall = rng.randint(15, 30), rng.randint(8, 20), rng.randint(6, 12)
    x, y, _ = ring(n_car, 5.0, 45.0)
    cars = np.stack([x, y, rng.uniform(-np.pi, np.pi, n_car), rng.uniform(4.0, 5.2, n_car),
                     rng.uniform(1.7, 2.1, n_car), rng.uniform(1.4, 1.9, n_car)], 1)
    x, y, _ = ring(n_ped, 4.0, 35.0)
    peds = np.stack([x, y, rng.uniform(-np.pi, np.pi, n_ped), np.full(n_ped, 0.7),
                     np.full(n_ped, 0.7), rng.uniform(1.6, 1.9, n_ped)], 1)
    x, y, a = ring(n_wall, 30.0, 50.0)
    walls = np.stack([x, y, a + np.pi / 2, rng.uniform(10.0, 30.0, n_wall), np.full(n_wall, 0.5),
                      rng.uniform(3.0, 9.0, n_wall)], 1)
    ids = np.concatenate([np.full(n_car, CLASS_TO_IDX["car"]), np.full(n_ped, CLASS_TO_IDX["pedestrian"]),
                          np.zeros(n_wall)])
    return np.concatenate([np.concatenate([cars, peds, walls]), ids[:, None]], 1)


def _cast_rays(origin: np.ndarray, dirs: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Distance along each ray [R, 3] to the ground or the nearest box (inf
    where it hits nothing within range)."""
    with np.errstate(divide="ignore", invalid="ignore"):
        t = np.where(dirs[:, 2] < 0, -LIDAR_HEIGHT / dirs[:, 2], np.inf)
        cx, cy, yaw, length, width, height = boxes[:, :6].T
        c, s = np.cos(yaw), np.sin(yaw)
        px, py = origin[0] - cx, origin[1] - cy  # [M]
        pz = origin[2] - (-LIDAR_HEIGHT + height / 2)
        # ray in each box's frame: [R, M] per axis
        p = (c * px + s * py, -s * px + c * py, pz)
        d = (dirs[:, :1] * c + dirs[:, 1:2] * s, -dirs[:, :1] * s + dirs[:, 1:2] * c,
             np.broadcast_to(dirs[:, 2:3], (dirs.shape[0], boxes.shape[0])))
        t_near = np.full(d[0].shape, -np.inf)
        t_far = np.full(d[0].shape, np.inf)
        for pa, da, half in zip(p, d, (length / 2, width / 2, height / 2)):
            t1, t2 = (-half - pa) / da, (half - pa) / da
            t_near = np.maximum(t_near, np.nan_to_num(np.minimum(t1, t2), nan=-np.inf))
            t_far = np.minimum(t_far, np.nan_to_num(np.maximum(t1, t2), nan=np.inf))
        hit = (t_far >= t_near) & (t_near > 0)
        t = np.minimum(t, np.where(hit, t_near, np.inf).min(1))
    return np.where(t < LIDAR_MAX_RANGE, t, np.inf)


def lidar_batch(cfg: ModelConfig, B: int, seed: int) -> Dict:
    """nuScenes-like 10-sweep point clouds in the key frame's LiDAR frame:
    points [B, P, 5] (x, y, z, intensity, Δt) f32 and points_mask [B, P],
    P = cfg.caps.max_points. Each sweep is one turn of 32 beams from
    -30.67° to +10.67° elevation at 1080 azimuth steps, 10% of returns
    dropped, 2 cm range noise; sweep s was taken 0.05·s seconds earlier,
    0.5·s metres behind. A cloud longer than P keeps P of its points, drawn
    at random and kept in order (a small configuration's P thins it)."""
    points, mask, _ = _lidar_clouds(cfg, B, seed)
    return dict(points=points, points_mask=mask)


def _scene_sweeps(rng: np.random.RandomState, n_sweeps: int):
    """A `_lidar_scene` and `n_sweeps` sweeps of it, each [M, 5] (x, y, z,
    intensity, Δt) in the key frame's LiDAR frame: sweep s taken 0.05·s
    seconds earlier, 0.5·s metres behind."""
    elev = np.deg2rad(np.linspace(*LIDAR_ELEVATION_DEG, LIDAR_BEAMS))
    boxes = _lidar_scene(rng)
    sweeps = []
    for s in range(n_sweeps):
        az = rng.uniform(0, 2 * np.pi) + np.linspace(0, 2 * np.pi, LIDAR_AZIMUTH_STEPS, endpoint=False)
        e, a = np.meshgrid(elev, az, indexing="ij")
        dirs = np.stack([np.cos(e) * np.cos(a), np.cos(e) * np.sin(a), np.sin(e)], -1).reshape(-1, 3)
        origin = np.array([-LIDAR_EGO_STEP * s, 0.0, 0.0])
        t = _cast_rays(origin, dirs, boxes)
        keep = np.isfinite(t) & (rng.rand(t.shape[0]) >= LIDAR_DROPOUT)
        t = t[keep] + rng.normal(0, 0.02, keep.sum())
        xyz = origin + t[:, None] * dirs[keep]
        sweeps.append(np.concatenate([xyz, rng.uniform(0, 255, (len(t), 1)),
                                      np.full((len(t), 1), LIDAR_SWEEP_DT * s)], 1))
    return boxes, sweeps


def _lidar_clouds(cfg: ModelConfig, B: int, seed: int):
    """`lidar_batch`'s clouds and the scene of each sample."""
    rng = np.random.RandomState(seed)
    P = cfg.caps.max_points
    points = np.zeros((B, P, 5), np.float32)
    mask = np.zeros((B, P), bool)
    scenes = []
    for b in range(B):
        boxes, sweeps = _scene_sweeps(rng, LIDAR_SWEEPS)
        scenes.append(boxes)
        cloud = np.concatenate(sweeps)
        if len(cloud) > P:
            cloud = cloud[np.sort(rng.choice(len(cloud), P, replace=False))]
        points[b, :len(cloud)] = cloud
        mask[b, :len(cloud)] = True
    return points, mask, scenes


def scene_gt_boxes(scenes, G: int) -> np.ndarray:
    """The cars and pedestrians of each scene as gt_boxes [B, G, 10] (x, y,
    z, dx, dy, dz, rot, vx, vy, cls), standing on the ground 1.84 m below
    the sensor, at rest; zero rows pad, boxes past G are dropped."""
    gt = np.zeros((len(scenes), G, 10), np.float32)
    for b, boxes in enumerate(scenes):
        obj = boxes[boxes[:, 6] > 0][:G]
        cx, cy, yaw, length, width, height, cls = obj.T
        gt[b, :len(obj)] = np.stack([cx, cy, -LIDAR_HEIGHT + height / 2, length, width, height, yaw,
                                     np.zeros_like(cx), np.zeros_like(cx), cls], 1)
    return gt


def train_batch(s_cfg: ModelConfig, t_cfg: ModelConfig, B: int, seed: int) -> Dict:
    """A frame batch for the distill step: the nuScenes-like camera batch
    of the student (`nuscenes_batch`), the LiDAR clouds of the teacher
    (`lidar_batch`) and the boxes of the LiDAR scenes' cars and pedestrians
    (`scene_gt_boxes`, up to the student's `caps.max_gt_boxes`)."""
    points, mask, scenes = _lidar_clouds(t_cfg, B, seed)
    return dict(nuscenes_batch(s_cfg, B, seed), points=points, points_mask=mask,
                gt_boxes=scene_gt_boxes(scenes, s_cfg.caps.max_gt_boxes))


def nms_lanes(kind: str, seed: int, L: int = 24, C: int = 512, objects: int = 40,
              per_object: int = 12) -> Tuple[np.ndarray, np.ndarray]:
    """BEV candidate lanes for the NMS kernels, in score order: bev [L, C, 5]
    (cx, cy, dx, dy, rot) float32 and valid [L, C] bool.

    `clustered`: `objects` cars of 4.6 x 1.9 m at uniform centres and yaws
    over +-54 m, `per_object` candidates each (centre sigma 0.25 m, dims
    +-3%, yaw sigma 0.05 rad) in random score order, then invalid rows (more
    candidates of the same objects, below the score threshold).
    `coincident`: every box on one centre with a uniform yaw and dims within
    3% of 4.6 x 1.9 m, so that every pair meets.
    `spread`: uniform centres over +-20 m, dims 1-5 m, uniform yaws.
    `touching`: pairs of rows (2k, 2k + 1) up to 61 m out; the second box
    lies beside the first along its x axis (a shared edge where the sides
    are equal) or off its corner, turned by a multiple of 90 degrees, with
    gaps of 0, 1e-6, 1e-4, 1e-3, 1e-2, 1.5e-2 or 3e-2 m (none near the
    clip's 1e-5 m boundary tolerance).
    `mixed_sizes`: boxes of 30 m x 0.5-30 m among 0.5 m ones over +-20 m.
    `tiny`: pairs of rows up to 61 m out: a 0.5-5 m box, then a box with a
    side at the decoders' 1 mm clamp (the other 1 mm to 5 m) within ~2 cm of
    one of the first box's corners.
    Every row is valid but in `clustered`.
    """
    rng = np.random.RandomState(seed)
    car = np.array([4.6, 1.9])
    yaws = lambda *shape: rng.uniform(-np.pi, np.pi, shape)
    valid = np.ones((L, C), bool)
    if kind == "coincident":
        bev = np.concatenate([rng.uniform(-54, 54, (L, 1, 2)).repeat(C, 1),
                              car * rng.uniform(0.97, 1.03, (L, C, 2)), yaws(L, C, 1)], -1)
    elif kind == "spread":
        bev = np.concatenate([rng.uniform(-20, 20, (L, C, 2)), rng.uniform(1, 5, (L, C, 2)),
                              yaws(L, C, 1)], -1)
    elif kind == "mixed_sizes":
        big = rng.rand(L, C, 1) < 0.3
        dims = np.where(big, np.stack([np.full((L, C), 30.0), rng.uniform(0.5, 30, (L, C))], -1),
                        rng.uniform(0.45, 0.55, (L, C, 2)))
        bev = np.concatenate([rng.uniform(-20, 20, (L, C, 2)), dims, yaws(L, C, 1)], -1)
    elif kind == "touching":
        n = C // 2
        a = np.concatenate([rng.uniform(-61, 61, (L, n, 2)), rng.uniform(0.5, 5, (L, n, 2)),
                            yaws(L, n, 1)], -1)
        gap = rng.choice([0.0, 1e-6, 1e-4, 1e-3, 1e-2, 1.5e-2, 3e-2], (L, n))
        quarter = rng.randint(0, 4, (L, n))
        b = a.copy()
        b[..., 4] += quarter * np.pi / 2
        b[..., 2:4] = np.where(rng.rand(L, n, 1) < 0.5, a[..., 2:4], rng.uniform(0.5, 5, (L, n, 2)))
        ext_x = np.where(quarter % 2 == 0, b[..., 2], b[..., 3]) / 2  # b's half-extents on a's axes
        ext_y = np.where(quarter % 2 == 0, b[..., 3], b[..., 2]) / 2
        off_x = a[..., 2] / 2 + ext_x + gap
        off_y = np.where(rng.rand(L, n) < 0.4, a[..., 3] / 2 + ext_y + gap, 0.0)
        c, s = np.cos(a[..., 4]), np.sin(a[..., 4])
        b[..., 0] = a[..., 0] + off_x * c - off_y * s
        b[..., 1] = a[..., 1] + off_x * s + off_y * c
        bev = np.stack([a, b], 2).reshape(L, C, 5)
    elif kind == "tiny":
        n = C // 2
        a = np.concatenate([rng.uniform(-61, 61, (L, n, 2)), rng.uniform(0.5, 5, (L, n, 2)),
                            yaws(L, n, 1)], -1)
        lx, ly = a[..., 2] / 2 * rng.choice([-1, 1], (L, n)), a[..., 3] / 2 * rng.choice([-1, 1], (L, n))
        c, s = np.cos(a[..., 4]), np.sin(a[..., 4])
        corner = a[..., :2] + np.stack([lx * c - ly * s, lx * s + ly * c], -1)
        dims = np.stack([np.full((L, n), 1e-3), rng.uniform(1e-3, 5, (L, n))], -1)
        dims = np.where(rng.rand(L, n, 1) < 0.5, dims, dims[..., ::-1])
        b = np.concatenate([corner + rng.normal(0, 0.02, (L, n, 2)), dims, yaws(L, n, 1)], -1)
        bev = np.stack([a, b], 2).reshape(L, C, 5)
    elif kind == "clustered":
        n_valid = min(C, objects * per_object)
        obj_c = rng.uniform(-54, 54, (L, objects, 2))
        obj_yaw = yaws(L, objects)
        which = np.stack([rng.permutation(np.arange(C) % objects) for _ in range(L)])
        which[:, :n_valid] = np.stack([rng.permutation(np.repeat(np.arange(objects), per_object))[:n_valid]
                                       for _ in range(L)])
        centre = np.take_along_axis(obj_c, which[..., None], 1) + rng.normal(0, 0.25, (L, C, 2))
        dims = car * rng.uniform(0.97, 1.03, (L, C, 2))
        yaw = np.take_along_axis(obj_yaw, which, 1) + rng.normal(0, 0.05, (L, C))
        bev = np.concatenate([centre, dims, yaw[..., None]], -1)
        valid[:, n_valid:] = False
    else:
        raise ValueError(f"unknown NMS layout {kind!r}")
    return bev.astype(np.float32), valid


# the six nuScenes cameras: yaw of the optical axis from the ego x axis
CAMERA_YAW_DEG = {"CAM_FRONT": 0.0, "CAM_FRONT_LEFT": 55.0, "CAM_FRONT_RIGHT": -55.0,
                  "CAM_BACK": 180.0, "CAM_BACK_LEFT": 110.0, "CAM_BACK_RIGHT": -110.0}
CAMERA_HEIGHT = -0.3  # metres, in the LiDAR frame (1.54 m above the ground)
SCENE_CATEGORY = {CLASS_TO_IDX["car"]: ("vehicle.car", "vehicle.parked"),
                  CLASS_TO_IDX["pedestrian"]: ("human.pedestrian.adult", "pedestrian.standing")}
WRITE_THREADS = 8  # `write_nuscenes` casts and encodes this many frames at once


def _points_in_boxes(xyz: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """Number of points inside each box [M, 9] (x, y, z, dx, dy, dz, yaw, ...)."""
    d = xyz[None, :, :3] - boxes[:, None, :3]
    c, s = np.cos(boxes[:, 6:7]), np.sin(boxes[:, 6:7])
    local = np.stack([c * d[..., 0] + s * d[..., 1], -s * d[..., 0] + c * d[..., 1], d[..., 2]], -1)
    return (np.abs(local) <= boxes[:, None, 3:6] / 2).all(-1).sum(1)


def _write_frame(root: str, token: str, seed: int) -> Dict:
    """One key frame on disk: 11 LiDAR turns of a `_lidar_scene` (the key
    frame and 10 sweeps, each in its own LiDAR frame), six 900×1600 JPEGs;
    returns its info record."""
    rng = np.random.RandomState(seed)
    boxes, turns = _scene_sweeps(rng, 1 + LIDAR_SWEEPS)
    key_ts = 1e6 * (1 + seed % 1000)
    lidar_file = f"samples/LIDAR_TOP/{token}.bin"
    np.concatenate([turns[0][:, :4], np.zeros((len(turns[0]), 1))], 1).astype(np.float32).tofile(
        os.path.join(root, lidar_file))
    sweeps = []
    for s, turn in enumerate(turns[1:], 1):
        origin = np.array([-LIDAR_EGO_STEP * s, 0.0, 0.0])
        f = f"sweeps/LIDAR_TOP/{token}_{s}.bin"
        np.concatenate([turn[:, :3] - origin, turn[:, 3:4], np.zeros((len(turn), 1))], 1).astype(
            np.float32).tofile(os.path.join(root, f))
        car_from_global = np.eye(4)
        car_from_global[:3, 3] = -origin  # the sweep's frame sits at `origin` in the key frame
        sweeps.append({"LIDAR_TOP": dict(filename=f, car_from_global=car_from_global,
                                         timestamp=key_ts - LIDAR_SWEEP_DT * s * 1e6)})

    objects = scene_gt_boxes([boxes], int((boxes[:, 6] > 0).sum()))[0]
    gt = objects[:, :9].astype(np.float64)
    names, attrs = zip(*(SCENE_CATEGORY[int(c)] for c in objects[:, 9])) if len(gt) else ((), ())

    cam_infos, rotations, translations = {}, {}, {}
    for cam, yaw_deg in CAMERA_YAW_DEG.items():
        a = np.deg2rad(yaw_deg)
        right, down, fwd = [np.sin(a), -np.cos(a), 0.0], [0.0, 0.0, -1.0], [np.cos(a), np.sin(a), 0.0]
        rotations[cam] = _rotmat_to_quat(np.stack([right, down, fwd], axis=1)).tolist()
        translations[cam] = [float(np.cos(a)), float(np.sin(a)), CAMERA_HEIGHT]
        f = f"samples/{cam}/{token}.jpg"
        small = rng.randint(0, 256, (9, 16, 3)).astype(np.uint8)
        Image.fromarray(small).resize((1600, 900), Image.BILINEAR).save(os.path.join(root, f), quality=90)
        intrinsic = np.array([[1266.0, 0.0, 800.0], [0.0, 1266.0, 450.0], [0.0, 0.0, 1.0]])
        cam_infos[cam] = dict(filename=f, calibrated_sensor=dict(camera_intrinsic=intrinsic))
    return dict(
        sample_token=token, timestamp=key_ts, gt_boxes=gt, gt_names=np.asarray(names),
        gt_attributes=np.asarray(attrs), num_lidar_pts=_points_in_boxes(turns[0], gt),
        num_radar_pts=np.zeros(len(gt), np.int64), car_from_global=np.eye(4), ref_from_car=np.eye(4),
        ego2global_translation=[0.0, 0.0, 0.0], ego2global_rotation=[1.0, 0.0, 0.0, 0.0],
        lidar_infos={"LIDAR_TOP": dict(filename=lidar_file)}, lidar_sweeps=sweeps,
        cam_infos=cam_infos, sensor2ego_rotations=rotations, sensor2ego_translations=translations)


def write_nuscenes(root: str, n_train: int, n_val: int, seed: int) -> str:
    """A synthetic nuScenes on disk under `root`, at full width, as
    `data.dataset.NuScenesDataset` reads it: `train_info.pkl` and
    `val_info.pkl` (n_train and n_val key frames, frame i drawn from
    RandomState(seed + i)) and their files. A frame is one `_lidar_scene`:
    the key LiDAR turn and 10 sweeps, ray-cast as `lidar_batch` casts them
    (32 beams × 1080 azimuth steps each, stored in each turn's own LiDAR
    frame with its pose), the scene's cars and pedestrians as GT boxes
    (`vehicle.car` / `human.pedestrian.adult`, with the key turn's points
    inside each), and six 900×1600 JPEGs of smooth random colour under
    nuScenes-like cameras (1266 px focal length, 55° / 110° apart). The
    LiDAR frame is the ego frame, the ego frame the global one. Frames are
    cast in `WRITE_THREADS` threads. Returns `root`."""
    for sub in ["samples/LIDAR_TOP", "sweeps/LIDAR_TOP", *(f"samples/{c}" for c in CAMERA_YAW_DEG)]:
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    tokens = [f"train{i:04d}" for i in range(n_train)] + [f"val{i:04d}" for i in range(n_val)]
    with ThreadPoolExecutor(WRITE_THREADS) as ex:
        infos = list(ex.map(lambda i: _write_frame(root, tokens[i], seed + i), range(len(tokens))))
    for split, part in (("train", infos[:n_train]), ("val", infos[n_train:])):
        with open(os.path.join(root, f"{split}_info.pkl"), "wb") as f:
            pickle.dump(part, f)
    return root
