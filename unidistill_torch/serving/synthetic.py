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
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from unidistill_torch.configs.nuscenes import CLASS_TO_IDX, DataConfig, ModelConfig
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


def _lidar_clouds(cfg: ModelConfig, B: int, seed: int):
    """`lidar_batch`'s clouds and the scene of each sample."""
    rng = np.random.RandomState(seed)
    P = cfg.caps.max_points
    elev = np.deg2rad(np.linspace(*LIDAR_ELEVATION_DEG, LIDAR_BEAMS))
    points = np.zeros((B, P, 5), np.float32)
    mask = np.zeros((B, P), bool)
    scenes = []
    for b in range(B):
        boxes = _lidar_scene(rng)
        scenes.append(boxes)
        sweeps = []
        for s in range(LIDAR_SWEEPS):
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
