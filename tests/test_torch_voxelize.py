"""The port's voxeliser against the JAX `ops/voxelize.py::voxelize_batched`.

The same numpy point clouds go through both. Voxel coords must be equal;
the mean features agree to 1e-6 (rtol and atol: the same sums, which torch
may add in another order than XLA).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unidistill_tpu.ops.voxelize import voxelize_batched

from unidistill_torch.configs.nuscenes import lidar_exp, tiny_model
from unidistill_torch.ops.voxelize import voxelize
from unidistill_torch.serving.synthetic import lidar_batch


def cloud(B, P, n, seed, spread=50.0):
    """Ground plane + vertical structures, some points out of range, some
    masked off, and a dense cluster that overfills its voxels."""
    rng = np.random.RandomState(seed)
    pts = np.zeros((B, P, 5), np.float32)
    pts[:, :n, 0:2] = rng.uniform(-spread, spread, (B, n, 2))
    pts[:, :n, 2] = rng.uniform(-3.5, -2.5, (B, n))
    pts[:, : n // 4, 2] = rng.uniform(-6, 4, (B, n // 4))
    pts[:, n // 2: n // 2 + 64, :3] = rng.normal([3.0, -2.0, -1.0], 0.05, (B, 64, 3))
    pts[:, :n, 3] = rng.uniform(0, 255, (B, n))
    pts[:, :n, 4] = rng.choice(np.arange(10) * 0.05, (B, n))
    mask = np.zeros((B, P), bool)
    mask[:, :n] = rng.rand(B, n) > 0.05
    return pts, mask


def both(pts, mask, mc, max_voxels):
    args = (mc.point_cloud_range, mc.voxel_size, mc.grid_size, max_voxels,
            mc.caps.max_points_per_voxel)
    jf, jc = voxelize_batched(jnp.asarray(pts), jnp.asarray(mask), *args)
    pf, pc = voxelize(torch.from_numpy(pts), torch.from_numpy(mask), *args)
    return (np.asarray(jf), np.asarray(jc)), (pf.numpy(), pc.numpy())


@pytest.mark.parametrize("max_voxels", [2048, 300], ids=["room", "cap_binds"])
def test_voxelize_matches_jax_tiny_grid(max_voxels):
    mc = tiny_model(with_camera=False)
    pts, mask = cloud(2, mc.caps.max_points, 1500, seed=0)
    (jf, jc), (pf, pc) = both(pts, mask, mc, max_voxels)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_allclose(pf, jf, rtol=1e-6, atol=1e-6)
    n_live = (pc[..., 0] >= 0).sum(1)
    assert (n_live > 100).all()
    if max_voxels == 300:
        assert (n_live == 300).all()  # the cap binds: the lowest keys are kept


def test_voxelize_matches_jax_nuscenes_grid():
    """The full 1440×1440×40 grid, on a cut of the synthetic 10-sweep cloud."""
    mc = lidar_exp().model
    b = lidar_batch(mc, 1, seed=4)
    pts, mask = b["points"][:, :20000], b["points_mask"][:, :20000]
    (jf, jc), (pf, pc) = both(pts, mask, mc, 16384)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_allclose(pf, jf, rtol=1e-6, atol=1e-6)
    counts = (pc[..., 0] >= 0).sum(1)
    assert counts[0] > 5000


def test_voxel_feature_is_the_mean_of_the_first_points():
    mc = tiny_model(with_camera=False)
    P = 32
    pts = np.zeros((1, P, 5), np.float32)
    pts[0, :, :3] = [1.0, 1.0, 0.1]  # all in one voxel
    pts[0, :, 3] = np.arange(P)
    mask = np.ones((1, P), bool)
    feats, coords = voxelize(torch.from_numpy(pts), torch.from_numpy(mask), mc.point_cloud_range,
                             mc.voxel_size, mc.grid_size, 8, 10)
    assert (coords[0, 0] >= 0).all() and (coords[0, 1:] == -1).all()
    assert feats[0, 0, 3].item() == pytest.approx(np.arange(10).mean())
    assert float(feats[0, 1:].abs().sum()) == 0.0
