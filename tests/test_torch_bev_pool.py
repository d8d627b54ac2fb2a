"""The port's BEV pool (the plain versions of kernels K1 and K5) against the
JAX package.

Same numpy inputs into JAX `bev_pool_outer`, the JAX Pallas scatter
`_bev_pool_scatter_pallas` in interpret mode, and the port's
`bev_pool_outer` on CPU tensors; for the backward, `jax.vjp` of
`bev_pool_outer` (what the JAX custom VJP's `_pool_bwd` runs) against the
port's `bev_pool_outer_bwd_plain` and against autograd of the plain
forward. Inputs include points outside the grid, negative coordinates and
z out of range. Tolerance rtol 1e-5, atol 1e-5: float32 sums of the same
products in another order.

K1's plan (`bev_pool_plan`, which runs as it is on the CPU) is held to its
invariants, and its plain reduce (`bev_pool_intervals_plain`) to the JAX
function, the Pallas scatter in interpret mode and `bev_pool_outer_plain`,
at the same tolerance. `bev_pool_bwd_reads`, the g rows K5 reads before and
after its redesign, is held to a count in numpy, and the training image
augmentation of the K5 geometries to the JAX data pipeline's.

The kernels themselves run only on the card: tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidistill_tpu.ops.bev_pool import (
    _POOL_CHUNK, _bev_pool_scatter_pallas, _linear_index as jax_linear_index,
    _rays_np, bev_pool_outer as jax_bev_pool_outer,
)

from unidistill_torch.ops import bev_pool as port

RTOL = ATOL = 1e-5


def _inputs(seed, B=2, NC=2, D=3, fH=4, fW=4, C=128, nx=8, ny=8):
    rng = np.random.RandomState(seed)
    geom = rng.randint(-3, 11, (B, NC, D, fH, fW, 3)).astype(np.int32)
    geom[..., 2] = rng.choice([-1, 0, 0, 0, 1], size=geom.shape[:-1])
    depth = rng.rand(B, NC, D, fH, fW).astype(np.float32)
    ctx = rng.randn(B, NC, fH, fW, C).astype(np.float32)
    return geom, depth, ctx, (nx, ny, 1)


@pytest.mark.parametrize("seed", [0, 1])
def test_linear_index_matches_jax(seed):
    geom, _, _, (nx, ny, nz) = _inputs(seed)
    ref = np.asarray(jax_linear_index(jnp.asarray(geom), nx, ny, nz))
    got = port._linear_index(torch.from_numpy(geom), nx, ny, nz).numpy()
    np.testing.assert_array_equal(got, ref)
    assert (ref == nx * ny).any() and (ref < nx * ny).any()


@pytest.mark.parametrize("seed,C", [(0, 128), (1, 32), (2, 300)])
def test_bev_pool_outer_matches_jax(seed, C):
    geom, depth, ctx, vn = _inputs(seed, C=C)
    ref = np.asarray(jax_bev_pool_outer(jnp.asarray(geom), jnp.asarray(depth),
                                        jnp.asarray(ctx), vn))
    got = port.bev_pool_outer(torch.from_numpy(geom), torch.from_numpy(depth),
                              torch.from_numpy(ctx), vn)
    assert got.shape == ref.shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def _pallas_interpret(geom, depth, ctx, voxel_num):
    """The JAX Pallas scatter `_bev_pool_scatter_pallas` in interpret mode."""
    nx, ny, nz = voxel_num
    B, NC, D, fH, fW = depth.shape
    C = ctx.shape[-1]
    ncells = nx * ny
    idx = jax_linear_index(jnp.asarray(geom), nx, ny, nz).reshape(B, -1)
    NP = idx.shape[1]
    pad = (-NP) % _POOL_CHUNK
    idx = jnp.pad(idx, ((0, 0), (0, pad)), constant_values=ncells)
    dflat = jnp.pad(jnp.asarray(depth).reshape(B, NP), ((0, 0), (0, pad)))
    rays = np.pad(np.broadcast_to(_rays_np(NC, D, fH, fW), (B, NP)), ((0, 0), (0, pad)))
    return np.asarray(_bev_pool_scatter_pallas(
        idx, jnp.asarray(rays), dflat,
        jnp.asarray(ctx).reshape(B, NC * fH * fW, C), ncells, interpret=True,
    )).reshape(B, ny, nx, C)


def test_bev_pool_outer_matches_pallas_interpret():
    geom, depth, ctx, (nx, ny, nz) = _inputs(0)
    ref = _pallas_interpret(geom, depth, ctx, (nx, ny, nz))
    got = port.bev_pool_outer(torch.from_numpy(geom), torch.from_numpy(depth),
                              torch.from_numpy(ctx), (nx, ny, nz))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_cuda_wrapper_rejects_cpu_tensors():
    geom, depth, ctx, (nx, ny, nz) = _inputs(0)
    cell = port._linear_index(torch.from_numpy(geom), nx, ny, nz).int()
    with pytest.raises(ValueError, match="CUDA"):
        port.bev_pool_cells_cuda(cell, torch.from_numpy(depth), torch.from_numpy(ctx), nx * ny)


@pytest.mark.parametrize("seed,C", [(0, 128), (3, 300)])
def test_bev_pool_backward_matches_jax_vjp(seed, C):
    geom, depth, ctx, (nx, ny, nz) = _inputs(seed, C=C)
    g = np.random.RandomState(seed + 10).randn(2, ny, nx, C).astype(np.float32)
    _, vjp = jax.vjp(lambda d, c: jax_bev_pool_outer(jnp.asarray(geom), d, c, (nx, ny, nz)),
                     jnp.asarray(depth), jnp.asarray(ctx))
    ref_d, ref_c = (np.asarray(x) for x in vjp(jnp.asarray(g)))
    cell = port._linear_index(torch.from_numpy(geom), nx, ny, nz).int()
    got_d, got_c = port.bev_pool_outer_bwd_plain(
        cell, torch.from_numpy(depth), torch.from_numpy(ctx), torch.from_numpy(g).reshape(2, nx * ny, C),
        nx * ny)
    np.testing.assert_allclose(got_d.numpy(), ref_d, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got_c.numpy(), ref_c, rtol=RTOL, atol=ATOL)
    assert (ref_d == 0).any() and (ref_d != 0).any()  # points outside the grid get 0
    d = torch.from_numpy(depth).requires_grad_(True)
    c = torch.from_numpy(ctx).requires_grad_(True)
    port.bev_pool_outer(torch.from_numpy(geom), d, c, (nx, ny, nz)).backward(torch.from_numpy(g))
    np.testing.assert_allclose(d.grad.numpy(), ref_d, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(c.grad.numpy(), ref_c, rtol=RTOL, atol=ATOL)


def test_backward_wrapper_rejects_cpu_tensors():
    geom, depth, ctx, (nx, ny, nz) = _inputs(0)
    cell = port._linear_index(torch.from_numpy(geom), nx, ny, nz).int()
    g = torch.zeros(2, nx * ny, ctx.shape[-1])
    with pytest.raises(ValueError, match="CUDA"):
        port.bev_pool_bwd_cuda(cell, torch.from_numpy(depth), torch.from_numpy(ctx), g, nx * ny)


# ---- K1's plan and its plain reduce -------------------------------------------


def _plan(geom, voxel_num):
    nx, ny, nz = voxel_num
    cell = port._linear_index(torch.from_numpy(geom), nx, ny, nz).int()
    order, offsets = port.bev_pool_plan(cell, nx * ny)
    return cell, order, offsets


def _check_plan(cell, order, offsets, ncells):
    """The plan's invariants, against the cells in the JAX layout: the
    intervals hold exactly the in-grid points, each point in the interval of
    its own (sample, cell), ray-major ascending inside an interval."""
    B, NC, D, fH, fW = cell.shape
    order, offsets = order.numpy(), offsets.numpy()
    cell_rm = cell.permute(0, 1, 3, 4, 2).reshape(-1).numpy().astype(np.int64)  # indexed by q
    valid = (cell_rm >= 0) & (cell_rm < ncells)
    assert order.dtype == np.int64 and offsets.dtype == np.int64
    assert offsets.shape == (B * ncells + 1,) and offsets[0] == 0
    assert (np.diff(offsets) >= 0).all()
    np.testing.assert_array_equal(np.sort(order), np.arange(cell.numel()))
    n_in = offsets[-1]
    assert n_in == valid.sum()
    np.testing.assert_array_equal(np.sort(order[:n_in]), np.flatnonzero(valid))
    sample = order // (NC * fH * fW * D)
    row = np.repeat(np.arange(B * ncells), np.diff(offsets))
    np.testing.assert_array_equal(sample[:n_in] * ncells + cell_rm[order[:n_in]], row)
    np.testing.assert_array_equal(sample[:n_in], row // ncells)  # no interval spans two samples
    inside = np.diff(row) == 0
    assert (np.diff(order[:n_in])[inside] > 0).all()  # ray, then depth bin, ascending
    return order, offsets


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_plan_partitions_the_in_grid_points(seed):
    geom, _, _, vn = _inputs(seed, B=3)
    cell, order, offsets = _plan(geom, vn)
    order, offsets = _check_plan(cell, order, offsets, vn[0] * vn[1])
    assert 0 < offsets[-1] < order.size and (np.diff(offsets) > 1).any()


def _edge_geom(case, seed=0, B=3, NC=2, D=3, fH=4, fW=4):
    rng = np.random.RandomState(seed)
    geom = np.zeros((B, NC, D, fH, fW, 3), np.int32)
    if case == "all_out_of_grid":
        geom[...] = rng.randint(-9, 20, geom.shape)
        geom[..., 2] = rng.choice([-1, 1, 5], size=geom.shape[:-1])
    elif case == "all_in_one_cell":
        geom[..., 0], geom[..., 1] = 5, 3
    elif case == "negative_coordinates":
        geom[...] = rng.randint(-8, 8, geom.shape)
        geom[..., 2] = 0
    return geom


@pytest.mark.parametrize("case", ["all_out_of_grid", "all_in_one_cell", "negative_coordinates"])
def test_plan_edge_cases(case):
    geom = _edge_geom(case)
    B, NC, D, fH, fW, _ = geom.shape
    vn = (8, 8, 1)
    ncells = vn[0] * vn[1]
    depth = np.random.RandomState(1).rand(B, NC, D, fH, fW).astype(np.float32)
    ctx = np.random.RandomState(2).randn(B, NC, fH, fW, 64).astype(np.float32)
    cell, order, offsets = _plan(geom, vn)
    order, offsets = _check_plan(cell, order, offsets, ncells)
    got = port.bev_pool_intervals_plain(torch.from_numpy(order), torch.from_numpy(offsets),
                                        torch.from_numpy(depth), torch.from_numpy(ctx))
    ref = port.bev_pool_outer_plain(torch.from_numpy(geom), torch.from_numpy(depth),
                                    torch.from_numpy(ctx), vn).reshape(B, ncells, -1)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=RTOL, atol=ATOL)
    sizes = np.diff(offsets)
    if case == "all_out_of_grid":
        assert (offsets == 0).all() and (got == 0).all()
    elif case == "all_in_one_cell":
        per_sample = NC * D * fH * fW
        assert sorted(np.flatnonzero(sizes)) == [b * ncells + 3 * 8 + 5 for b in range(B)]
        assert (sizes[sizes > 0] == per_sample).all()
        np.testing.assert_array_equal(order, np.arange(B * per_sample))
    else:
        assert 0 < offsets[-1] < order.size


@pytest.mark.parametrize("seed,C", [(0, 128), (1, 32), (2, 300)])
def test_intervals_plain_matches_jax(seed, C):
    geom, depth, ctx, vn = _inputs(seed, B=3, C=C)
    nx, ny, _ = vn
    _, order, offsets = _plan(geom, vn)
    got = port.bev_pool_intervals_plain(order, offsets, torch.from_numpy(depth),
                                        torch.from_numpy(ctx)).reshape(3, ny, nx, C)
    assert got.dtype == torch.float32
    ref = np.asarray(jax_bev_pool_outer(jnp.asarray(geom), jnp.asarray(depth), jnp.asarray(ctx), vn))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)
    plain = port.bev_pool_outer_plain(torch.from_numpy(geom), torch.from_numpy(depth),
                                      torch.from_numpy(ctx), vn)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=RTOL, atol=ATOL)


def test_intervals_plain_matches_pallas_interpret():
    geom, depth, ctx, vn = _inputs(4)
    _, order, offsets = _plan(geom, vn)
    got = port.bev_pool_intervals_plain(order, offsets, torch.from_numpy(depth), torch.from_numpy(ctx))
    ref = _pallas_interpret(geom, depth, ctx, vn)
    np.testing.assert_allclose(got.numpy().reshape(ref.shape), ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [0, 5])
def test_plan_is_reproducible(seed):
    geom, _, _, vn = _inputs(seed, B=3)
    _, o1, f1 = _plan(geom, vn)
    _, o2, f2 = _plan(geom.copy(), vn)
    assert torch.equal(o1, o2) and torch.equal(f1, f2)


def test_reduce_wrapper_rejects_cpu_tensors():
    geom, depth, ctx, vn = _inputs(0)
    _, order, offsets = _plan(geom, vn)
    with pytest.raises(ValueError, match="CUDA"):
        port.bev_pool_intervals_cuda(order, offsets, torch.from_numpy(depth), torch.from_numpy(ctx))


def _reads_numpy(cell, ncells, columns, rays_per_pass):
    """(ray runs, column reads) of `bev_pool_bwd_reads`, counted column
    group by column group in numpy."""
    q = np.where((cell >= 0) & (cell < ncells), cell, -1)
    B, NC, D, fH, fW = q.shape
    runs = reads = 0
    for b in range(B):
        for n in range(NC):
            for w in range(fW):
                for h in range(fH):
                    qv = q[b, n, :, h, w][q[b, n, :, h, w] >= 0]
                    runs += int(len(qv) > 0) + int((qv[1:] != qv[:-1]).sum())
            for w0 in range(0, fW, columns):
                for h0 in range(0, fH, rays_per_pass):
                    part = q[b, n, :, h0:h0 + rays_per_pass, w0:w0 + columns].reshape(D, -1)
                    for d in range(D):
                        if d == 0 or (part[d] != part[d - 1]).any():
                            reads += len(set(part[d][part[d] >= 0].tolist()))
    return runs, reads


@pytest.mark.parametrize("case", ["random_fH20", "nuscenes_full_width", "train_ida_pitch2_full_width"])
def test_bwd_reads_match_numpy(case):
    """K5's g-row reads: the counter against numpy, on random cells over
    two passes of a column (fH 20) and an odd number of columns, and on the
    nuScenes-like cameras at full width (B 4, six cameras, D 112, 16 x 44),
    where the column reads are at most a tenth of the ray runs; under the
    training image augmentation and a 2 degree pitch, where the rays of a
    column share fewer cells, at most a fifth."""
    if case == "random_fH20":
        rng = np.random.RandomState(0)
        ncells = 12
        cell = rng.choice([-1, 0, 3, 3, 5, 7, 11, 12], size=(2, 2, 9, 20, 3)).astype(np.int32)
        cell[:, :, 2:5] = cell[:, :, 2:3]  # bins whose cells repeat
    else:
        from unidistill_torch.configs.nuscenes import DataConfig, camera_exp
        from unidistill_torch.serving.synthetic import nuscenes_cells
        ncells = 180 * 180
        kw = dict(data=DataConfig(), pitch_deg=2.0) if case.startswith("train_ida") else {}
        cell = nuscenes_cells(camera_exp().model, 4, seed=21, **kw).numpy()
    runs, reads = port.bev_pool_bwd_reads(torch.from_numpy(cell), ncells)
    assert (runs, reads) == _reads_numpy(cell, ncells, port.K5_COLUMNS, port.K5_RAYS_PER_PASS)
    if case == "nuscenes_full_width":
        assert runs == 1_319_612 and reads <= runs / 10
    elif case.startswith("train_ida"):
        assert reads <= runs / 5


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_ida_mats_match_jax_pipeline(seed):
    """`serving.synthetic.train_ida_mats` (the K5 geometries' training image
    augmentation) equals the JAX data pipeline's IDA matrices for the same
    draws: `sample_ida_augs` then `img_transform`, image by image, at 1e-9."""
    from PIL import Image

    from unidistill_tpu.configs.nuscenes import DataConfig as JaxDataConfig
    from unidistill_tpu.data import transforms as T

    from unidistill_torch.configs.nuscenes import IMG_DIM, DataConfig
    from unidistill_torch.serving.synthetic import train_ida_mats
    jd = JaxDataConfig()
    got = train_ida_mats(DataConfig(), IMG_DIM, 6, np.random.RandomState(seed))
    rng = np.random.RandomState(seed)
    img = Image.new("RGB", (jd.src_w, jd.src_h))
    for i in range(6):
        aug = T.sample_ida_augs(rng, (jd.src_h, jd.src_w), IMG_DIM, jd.ida_resize_lim, jd.ida_rot_lim,
                                jd.ida_rand_flip, jd.ida_bot_pct_lim, True)
        np.testing.assert_allclose(got[i], T.img_transform(img, *aug)[1], rtol=1e-9, atol=1e-9)
