"""Seeded stand-ins for a checkpoint and a camera batch, for smoke runs and
measurements on the card (no dataset and no trained weights needed).

`random_state_dict(cfg, seed)` gives weights the detector loads strictly;
`calibrate_batchnorm(model, inputs)` then sets every BatchNorm's running
statistics to those of one batch, so that activations keep a unit scale
through the random network (random statistics let them grow to ~1e5 at the
BEV map, where bf16 rounding hides every difference under test).
`nuscenes_batch(cfg, B, seed)` gives a batch with nuScenes-like camera
matrices: six cameras around the ego car 1.6 m up, 1266 px focal length on
the 1600×900 sensor, the image resized by 0.44 and cropped 140 rows (the IDA
of the eval pipeline), identity BDA, normalised random images.
`rich_mats(B, N, H, W)` are the small-image matrices of the JAX package's
full-model golden test, chosen so that frustum points land well inside BEV
cells (cell truncation is bitwise-sensitive at the edges).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
from torch import nn

from unidistill_torch.configs.nuscenes import ModelConfig
from unidistill_torch.models.bevfusion import BEVFusionCenterHead


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
        elif isinstance(mod, nn.BatchNorm2d) and leaf == "weight":
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
    the model in eval mode."""
    bns = [m for m in model.modules() if isinstance(m, nn.BatchNorm2d)]
    for m in bns:
        m.reset_running_stats()
        m.momentum = None  # cumulative average: one batch gives its own statistics
    model.train()
    model(**inputs)
    model.eval()
    for m in bns:
        m.momentum = 0.1
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
