"""The port's BEV pool (kernel K1's plain version) against the JAX package.

Same numpy inputs into JAX `bev_pool_outer`, the JAX Pallas scatter
`_bev_pool_scatter_pallas` in interpret mode, and the port's
`bev_pool_outer` on CPU tensors. Inputs include points outside the grid,
negative coordinates and z out of range. Tolerance rtol 1e-5, atol 1e-5:
float32 sums of the same products in another order.

The kernel itself runs only on the card: tests/test_torch_kernels_cuda.py.
"""
import numpy as np
import pytest
import torch

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


def test_bev_pool_outer_matches_pallas_interpret():
    geom, depth, ctx, (nx, ny, nz) = _inputs(0)
    B, NC, D, fH, fW = depth.shape
    C = ctx.shape[-1]
    ncells = nx * ny
    idx = jax_linear_index(jnp.asarray(geom), nx, ny, nz).reshape(B, -1)
    NP = idx.shape[1]
    pad = (-NP) % _POOL_CHUNK
    idx = jnp.pad(idx, ((0, 0), (0, pad)), constant_values=ncells)
    dflat = jnp.pad(jnp.asarray(depth).reshape(B, NP), ((0, 0), (0, pad)))
    rays = np.pad(np.broadcast_to(_rays_np(NC, D, fH, fW), (B, NP)), ((0, 0), (0, pad)))
    ref = np.asarray(_bev_pool_scatter_pallas(
        idx, jnp.asarray(rays), dflat,
        jnp.asarray(ctx).reshape(B, NC * fH * fW, C), ncells, interpret=True,
    )).reshape(B, ny, nx, C)
    got = port.bev_pool_outer(torch.from_numpy(geom), torch.from_numpy(depth),
                              torch.from_numpy(ctx), (nx, ny, nz))
    np.testing.assert_allclose(got.numpy(), ref, rtol=RTOL, atol=ATOL)


def test_cuda_wrapper_rejects_cpu_tensors():
    geom, depth, ctx, (nx, ny, nz) = _inputs(0)
    cell = port._linear_index(torch.from_numpy(geom), nx, ny, nz).int()
    with pytest.raises(ValueError, match="CUDA"):
        port.bev_pool_cells_cuda(cell, torch.from_numpy(depth), torch.from_numpy(ctx), nx * ny)
