"""The port's sparse tensor, rulebooks and plain sparse conv against the JAX
package (`ops/sparse_conv.py`, `ops/sparse_conv_pallas.py`).

Inputs are drawn from numpy seeds: clustered voxel sets (a few consecutive
z per occupied column) in [B, V] slots sorted by key, as the JAX functions
take them, and the same voxels as the port's batch-folded SparseTensor.

Tolerances: site sets and neighbour maps exactly; the plain sparse conv
against the JAX gather-GEMM in float32 at rtol/atol 1e-5 (the same products
summed in another order); against T3, the Pallas key-match kernel in
interpret mode, at 2e-2, because T3 rounds features and weights to bf16.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from unidistill_tpu.ops import sparse_conv as jsc
from unidistill_tpu.ops.sparse_conv_pallas import subm_conv_keymatch, subm_window_overflow

from unidistill_torch.ops import sparse_conv as sc

TOL = dict(rtol=1e-5, atol=1e-5)
# the tiny model's stage shapes and its four strided convs
S0, S2, S3, S4, S5 = (41, 80, 80), (21, 40, 40), (11, 20, 20), (5, 10, 10), (2, 10, 10)
DOWNS = {
    "down2": ((3, 3, 3), (2, 2, 2), (1, 1, 1), S0, S2),
    "down3": ((3, 3, 3), (2, 2, 2), (1, 1, 1), S2, S3),
    "down4": ((3, 3, 3), (2, 2, 2), (0, 1, 1), S3, S4),
    "conv_out": ((3, 1, 1), (2, 1, 1), (0, 0, 0), S4, S5),
}


def voxel_set(shape, B=2, V=512, C=8, density=0.6, seed=0):
    """JAX SparseTensor fields [B, V, ·] (key-sorted, BIG padding) and the
    same voxels as the port's SparseTensor."""
    D, H, W = shape
    rng = np.random.RandomState(seed)
    keys = np.full((B, V), D * H * W, np.int64)
    n = int(V * density)
    for b in range(B):
        n = min(n, H * W // 2)
        cols = rng.choice(H * W, size=n, replace=False)
        z0 = rng.randint(0, D, n)
        ks = set()
        for c, z, dz in zip(cols, z0, rng.randint(1, 4, n)):
            ks.update(int(c) * D + zz for zz in range(z, min(z + dz, D)))
        ks = np.sort(np.fromiter(ks, np.int64))[: V - rng.randint(0, 40)]
        keys[b, : len(ks)] = ks
    valid = keys < D * H * W
    col = keys // D
    coords = np.where(valid[..., None], np.stack([keys % D, col // W, col % W], -1), -1)
    feats = np.where(valid[..., None], rng.randn(B, V, C), 0).astype(np.float32)
    jst = jsc.SparseTensor(jnp.asarray(feats), jnp.asarray(coords, jnp.int32),
                           jnp.asarray(keys, jnp.int32), jnp.asarray(valid))
    pst = sc.from_voxels(torch.from_numpy(feats), torch.from_numpy(coords.astype(np.int32)), shape)
    return jst, pst, valid


def rows_of(valid):
    """Per sample: the port's global row of each JAX slot (sample bands)."""
    n = valid.sum(1)
    return [int(o) + np.arange(c) for o, c in zip(np.concatenate([[0], np.cumsum(n)[:-1]]), n)]


def weights(K, cin, cout, seed):
    return (np.random.RandomState(seed).randn(K, cin, cout) * 0.3).astype(np.float32)


def test_from_voxels_folds_the_batch_in_key_order():
    _, pst, valid = voxel_set(S0, seed=1)
    assert pst.coords.shape[0] == valid.sum()
    assert bool((pst.keys[1:] > pst.keys[:-1]).all())
    assert pst.coords[:, 0].tolist() == sum(([b] * int(c) for b, c in enumerate(valid.sum(1))), [])
    D, H, W = S0
    b, z, y, x = pst.coords.numpy().T
    np.testing.assert_array_equal(pst.keys.numpy(), ((b * (H + 2) + y + 1) * (W + 2) + x + 1) * (D + 2) + z + 1)


@pytest.mark.parametrize("shape", [S0, S3])
def test_subm_rules_match_jax(shape):
    jst, pst, valid = voxel_set(shape, seed=2)
    idx, take = map(np.asarray, jsc.build_subm_rules_batched(jst, shape, 3))  # [B, K, V]
    nbr = sc.subm_rules(pst).numpy()
    rows = rows_of(valid)
    for b, r in enumerate(rows):
        # an out-of-grid neighbour's sentinel key also "finds" a JAX padding
        # slot (zero features); the port has no padding and says -1
        found = take[b] & (idx[b] < len(r))
        want = np.where(found, r[0] + idx[b], -1)[:, : len(r)].T
        np.testing.assert_array_equal(nbr[r], want)
    assert (nbr >= 0).sum() > 1.5 * len(nbr)  # neighbours beyond the centre tap


@pytest.mark.parametrize("name", list(DOWNS))
def test_downsample_sites_match_jax(name):
    k, s, p, shape, out_shape = DOWNS[name]
    jst, pst, _ = voxel_set(shape, seed=3)
    _, jkeys, jvalid = map(np.asarray, jsc.downsample_sites_batched(jst, k, s, p, out_shape, 4096))
    out = sc.downsample_sites(pst, k, s, p, out_shape)
    key, ok = sc.linear_key(out.coords[:, 1:], out_shape)
    assert bool(ok.all())
    for b in range(jkeys.shape[0]):
        np.testing.assert_array_equal(key[out.coords[:, 0] == b].numpy(), jkeys[b][jvalid[b]])


@pytest.mark.parametrize("shape,cout", [(S0, 16), (S2, 32)])
def test_subm_conv_plain_matches_jax(shape, cout):
    jst, pst, valid = voxel_set(shape, seed=4)
    w = weights(27, 8, cout, 5)
    bias = np.random.RandomState(6).randn(cout).astype(np.float32)
    rules = jsc.build_subm_rules_batched(jst, shape, 3)
    ref = np.asarray(jsc.subm_conv_batched(jst, jnp.asarray(w), rules, jnp.asarray(bias)).features)
    got = sc.sparse_conv(pst.features, sc.subm_rules(pst), torch.from_numpy(w), torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.concatenate([ref[b][valid[b]] for b in range(2)]), **TOL)


@pytest.mark.parametrize("name", list(DOWNS))
def test_down_conv_plain_matches_jax(name):
    k, s, p, shape, out_shape = DOWNS[name]
    jst, pst, _ = voxel_set(shape, seed=7)
    w = weights(int(np.prod(k)), 8, 16, 8)
    ref = jsc.sparse_conv_down_batched(jst, jnp.asarray(w), k, s, p, shape, out_shape, 4096)
    out = sc.downsample_sites(pst, k, s, p, out_shape)
    got = sc.sparse_conv(pst.features, sc.down_rules(pst, out, k, s, p), torch.from_numpy(w))
    rv = np.asarray(ref.valid)
    want = np.concatenate([np.asarray(ref.features)[b][rv[b]] for b in range(2)])
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert np.abs(want).max() > 1.0


@pytest.mark.parametrize("seed", [0, 1])
def test_subm_conv_plain_matches_t3_keymatch(seed):
    """T3 itself, the Pallas kernel K4 replaces, in interpret mode."""
    shape = (11, 40, 40)
    jst, pst, valid = voxel_set(shape, seed=10 + seed)
    w = weights(27, 8, 8, 11 + seed)
    assert int(subm_window_overflow(jst.keys, shape, 128, 512)) == 0
    ref = np.asarray(subm_conv_keymatch(jst.features, jst.keys, jnp.asarray(w), shape,
                                        block=128, window=512), np.float32)
    got = sc.sparse_conv(pst.features, sc.subm_rules(pst), torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), np.concatenate([ref[b][valid[b]] for b in range(2)]),
                               rtol=2e-2, atol=2e-2)


def test_to_dense_bev_folds_channels_c_major():
    coords = torch.tensor([[0, 1, 2, 3], [1, 0, 4, 1]])
    st = sc.SparseTensor(torch.tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]), coords,
                         torch.zeros(2, dtype=torch.int64), (2, 5, 6), 2)
    bev = sc.to_dense_bev(st)
    assert bev.shape == (2, 6, 5, 6)
    assert bev[0, :, 2, 3].tolist() == [0.0, 1.0, 0.0, 2.0, 0.0, 3.0]  # channel c·D + d, d = 1
    assert bev[1, :, 4, 1].tolist() == [4.0, 0.0, 5.0, 0.0, 6.0, 0.0]
    assert bev.abs().sum() == 21.0


def test_cuda_wrapper_refuses_cpu_tensors():
    _, pst, _ = voxel_set(S3, seed=12)
    w = torch.from_numpy(weights(27, 8, 16, 13))
    with pytest.raises(ValueError, match="CUDA"):
        sc.sparse_conv_cuda(pst.features, sc.subm_rules(pst), w)
