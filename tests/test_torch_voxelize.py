"""The port's voxeliser against the JAX `ops/voxelize.py::voxelize_batched`.

The same numpy point clouds go through both. Voxel coords must be equal;
the mean features agree to 1e-6 (rtol and atol: the same sums, which torch
may add in another order than XLA). The port's per-rank sum equals one
sequential `index_add_` of the kept points on the CPU bit for bit.
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


def _voxelize_index_add(points, points_mask, point_cloud_range, voxel_size, grid_size, max_voxels,
                        max_points_per_voxel):
    """The voxeliser with its sums as one `index_add_` of the kept points
    into their slots (the dropped ones into a dump slot V), which the CPU
    adds in point order."""
    B, P, C = points.shape
    nx, ny, nz = grid_size
    V = max_voxels
    pcr = torch.tensor(point_cloud_range[:3], dtype=points.dtype)
    vsz = torch.tensor(voxel_size, dtype=points.dtype)
    vc = torch.floor((points[..., :3] - pcr) / vsz).clamp(-1, max(nx, ny, nz)).to(torch.int64)
    x, y, z = vc.unbind(-1)
    in_range = (x >= 0) & (x < nx) & (y >= 0) & (y < ny) & (z >= 0) & (z < nz) & points_mask
    big = nx * ny * nz
    skey, order = torch.sort(torch.where(in_range, (y * nx + x) * nz + z, big), dim=1, stable=True)
    spoints = torch.gather(points, 1, order[..., None].expand(B, P, C))
    svc = torch.gather(vc, 1, order[..., None].expand(B, P, 3))
    live = skey < big
    is_start = torch.ones_like(live)
    is_start[:, 1:] = skey[:, 1:] != skey[:, :-1]
    is_start &= live
    seg = torch.where(live, (torch.cumsum(is_start.long(), 1) - 1).clamp(max=V), V)
    pos = torch.arange(P).expand(B, P)
    runstart = torch.cummax(torch.where(is_start, pos, 0), 1).values
    keep = ((pos - runstart) < max_points_per_voxel) & (seg < V)
    gseg = (seg + torch.arange(B)[:, None] * (V + 1)).reshape(-1)
    sums = torch.zeros(B * (V + 1), C).index_add_(0, gseg, torch.where(keep[..., None], spoints, 0.0).reshape(-1, C))
    cnts = torch.zeros(B * (V + 1), dtype=torch.int64).index_add_(0, gseg, keep.reshape(-1).long())
    feats = sums.reshape(B, V + 1, C)[:, :V] / cnts.reshape(B, V + 1)[:, :V].clamp(min=1)[..., None]
    gdest = (torch.where(is_start, seg, V) + torch.arange(B)[:, None] * (V + 1)).reshape(-1)
    coords = torch.full((B * (V + 1), 3), -1, dtype=torch.int32)
    coords.index_copy_(0, gdest, svc.flip(-1).reshape(-1, 3).to(torch.int32))
    return feats, coords.reshape(B, V + 1, 3)[:, :V]


@pytest.mark.parametrize("grid", ["tiny", "tiny_cap_binds", "nuscenes"])
def test_per_rank_sum_equals_one_index_add(grid):
    """The per-rank sums (no atomics) against one `index_add_` on the CPU,
    bit for bit: at the tiny grid (room, and a cap that binds) and at the
    full nuScenes grid on two full-size 10-sweep clouds at the eval cap."""
    if grid == "nuscenes":
        mc = lidar_exp().model
        b = lidar_batch(mc, 2, seed=11)
        pts, mask, V = b["points"], b["points_mask"], mc.caps.max_voxels_eval
    else:
        mc = tiny_model(with_camera=False)
        pts, mask = cloud(2, mc.caps.max_points, 1500, seed=1)
        V = 300 if grid == "tiny_cap_binds" else 2048
    args = (mc.point_cloud_range, mc.voxel_size, mc.grid_size, V, mc.caps.max_points_per_voxel)
    pts, mask = torch.from_numpy(pts), torch.from_numpy(mask)
    feats, coords = voxelize(pts, mask, *args)
    ref_f, ref_c = _voxelize_index_add(pts, mask, *args)
    assert torch.equal(coords, ref_c)
    assert torch.equal(feats.view(torch.int32), ref_f.view(torch.int32))
    live = (coords[..., 0] >= 0).sum(1)
    assert (live > (50_000 if grid == "nuscenes" else 250)).all()
