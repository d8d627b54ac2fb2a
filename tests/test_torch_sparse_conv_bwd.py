"""The sparse conv's backward: the port's path on the CPU (the custom op
`unidistill::sparse_conv` and its registered backward, which run the plain
versions of the kernels here) against `jax.vjp` of the JAX package's sparse
convs, its transposed maps, and the wiring of the op's backward (K4 over
the transposed map for the input gradient, K6 for the weight gradient; on
the card those kernels, here their plain versions, counted).

Inputs are the clustered voxel sets of tests/test_torch_sparse_conv.py.
Tolerances: against the per-voxel f32 `subm_conv_batched` and
`sparse_conv_down_batched` rtol 1e-5 and atol 1e-5 of the gradient's scale
(max |ref|, at least 1: dW sums ~1000 products in another order); against
T3 `subm_conv_keymatch` (Pallas, interpret mode, whose custom VJP
`_subm_bwd` re-runs the kernel with the taps reversed and W transposed)
2e-2 of each gradient's scale, because T3 rounds features, weights and g to
bf16; the plain backward kernels against autograd as against the per-voxel
JAX functions; transposed maps exactly.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidistill_tpu.ops import sparse_conv as jsc
from unidistill_tpu.ops.sparse_conv_pallas import subm_conv_keymatch, subm_window_overflow

from unidistill_torch.ops import sparse_conv as sc

from tests.test_torch_sparse_conv import DOWNS, S0, S2, S3, rows_of, voxel_set, weights


def assert_close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * max(1.0, float(np.abs(ref).max())))


def cotangent(n, cout, seed):
    return np.random.RandomState(seed).randn(n, cout).astype(np.float32)


# the plain versions as the module defines them (a fixture below wraps them)
PLAIN_FWD, PLAIN_DGRAD, PLAIN_WGRAD = sc.sparse_conv_plain, sc.sparse_conv_dgrad_plain, sc.sparse_conv_wgrad_plain


def port_grads(feats, nbr, w, bias, g, conv=sc.sparse_conv):
    """Autograd of the port's sparse conv (the op, or `conv`): (dfeat, dW,
    dbias)."""
    f = feats.clone().requires_grad_(True)
    wt = torch.from_numpy(w).requires_grad_(True)
    b = None if bias is None else torch.from_numpy(bias).requires_grad_(True)
    conv(f, nbr, wt, b).backward(torch.from_numpy(g))
    return f.grad.numpy(), wt.grad.numpy(), None if b is None else b.grad.numpy()


def slots_to_rows(a, valid):
    """[B, V, C] JAX slots -> the port's [N, C] rows (valid slots in order)."""
    return np.concatenate([np.asarray(a)[b][valid[b]] for b in range(a.shape[0])])


def rows_to_slots(x, valid):
    out = np.zeros(valid.shape + x.shape[1:], x.dtype)
    for b, r in enumerate(rows_of(valid)):
        out[b][valid[b]] = x[r]
    return out


@pytest.mark.parametrize("shape,cout", [(S0, 16), (S2, 32)])
def test_subm_conv_vjp_matches_jax(shape, cout):
    jst, pst, valid = voxel_set(shape, seed=20)
    w = weights(27, 8, cout, 21)
    bias = np.random.RandomState(22).randn(cout).astype(np.float32)
    g = cotangent(pst.keys.numel(), cout, 23)
    rules = jsc.build_subm_rules_batched(jst, shape, 3)
    fn = lambda f, wt, b: jsc.subm_conv_batched(jst._replace(features=f), wt, rules, b).features
    _, vjp = jax.vjp(fn, jst.features, jnp.asarray(w), jnp.asarray(bias))
    rdf, rdw, rdb = vjp(jnp.asarray(rows_to_slots(g, valid)))
    df, dw, db = port_grads(pst.features, sc.subm_rules(pst), w, bias, g)
    assert_close(df, slots_to_rows(rdf, valid))
    assert_close(dw, rdw)
    assert_close(db, rdb)
    assert np.abs(dw).max() > 1.0


@pytest.mark.parametrize("name", list(DOWNS))
def test_down_conv_vjp_matches_jax(name):
    """Every strided conv of the encoder (down2, down3, down4 with padding
    (0, 1, 1), conv_out (3, 1, 1) / (2, 1, 1))."""
    k, s, p, shape, out_shape = DOWNS[name]
    jst, pst, valid = voxel_set(shape, seed=24)
    w = weights(int(np.prod(k)), 8, 16, 25)
    fn = lambda f, wt: jsc.sparse_conv_down_batched(jst._replace(features=f), wt, k, s, p, shape,
                                                    out_shape, 4096)
    ref, vjp = jax.vjp(fn, jst.features, jnp.asarray(w))
    out = sc.downsample_sites(pst, k, s, p, out_shape)
    nbr = sc.down_rules(pst, out, k, s, p)
    out_valid = np.asarray(ref.valid)
    g = cotangent(nbr.shape[0], 16, 26)
    zero = jax.tree.map(jnp.zeros_like, ref)
    rdf, rdw = vjp(zero._replace(features=jnp.asarray(rows_to_slots(g, out_valid))))
    df, dw, _ = port_grads(pst.features, nbr, w, None, g)
    assert_close(df, slots_to_rows(rdf, valid))
    assert_close(dw, rdw)
    assert np.abs(df).max() > 0.1


@pytest.mark.parametrize("seed", [0, 1])
def test_subm_conv_vjp_matches_t3_keymatch(seed):
    """T3's own backward (`_subm_bwd`), the Pallas kernel in interpret mode."""
    shape = (11, 40, 40)
    jst, pst, valid = voxel_set(shape, seed=30 + seed)
    w = weights(27, 8, 8, 31 + seed)
    assert int(subm_window_overflow(jst.keys, shape, 128, 512)) == 0
    g = cotangent(pst.keys.numel(), 8, 32 + seed)
    fn = lambda f, wt: subm_conv_keymatch(f, jst.keys, wt, shape, 128, 512)
    _, vjp = jax.vjp(fn, jst.features, jnp.asarray(w))
    rdf, rdw = vjp(jnp.asarray(rows_to_slots(g, valid)))
    df, dw, _ = port_grads(pst.features, sc.subm_rules(pst), w, None, g)
    ref_df = slots_to_rows(np.asarray(rdf, np.float32), valid)
    for got, ref in ((df, ref_df), (dw, np.asarray(rdw, np.float32))):
        scale = np.abs(ref).max()
        np.testing.assert_allclose(got / scale, ref / scale, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("shape", [S0, S3])
def test_transposed_subm_map_is_the_tap_reversed_map(shape):
    _, pst, _ = voxel_set(shape, seed=40)
    nbr = sc.subm_rules(pst)
    assert torch.equal(sc.transpose_rules(nbr, nbr.shape[0]), nbr.flip(1))


@pytest.mark.parametrize("name", list(DOWNS))
def test_transposed_strided_map_inverts_the_map(name):
    """nbr_t[i, k] = o exactly where nbr[o, k] = i; -1 everywhere else."""
    k, s, p, shape, out_shape = DOWNS[name]
    _, pst, _ = voxel_set(shape, seed=41)
    out = sc.downsample_sites(pst, k, s, p, out_shape)
    nbr = sc.down_rules(pst, out, k, s, p)
    nbr_t = sc.transpose_rules(nbr, pst.keys.numel())
    assert nbr_t.shape == (pst.keys.numel(), nbr.shape[1]) and nbr_t.dtype == torch.int32
    o, tap = torch.nonzero(nbr >= 0, as_tuple=True)
    want = torch.full_like(nbr_t, -1)
    want[nbr[o, tap].long(), tap] = o.to(torch.int32)
    assert torch.equal(nbr_t, want)
    assert int((nbr_t >= 0).sum()) == int((nbr >= 0).sum())  # each (input, tap) read at most once


def test_transposed_map_of_an_empty_stage():
    nbr = torch.empty(0, 27, dtype=torch.int32)
    assert sc.transpose_rules(nbr, 0).shape == (0, 27)
    assert (sc.transpose_rules(nbr, 5) == -1).all()


@pytest.mark.parametrize("name", ["subm"] + list(DOWNS))
def test_plain_backward_kernels_match_autograd(name):
    """`sparse_conv_dgrad_plain` over the transposed map and
    `sparse_conv_wgrad_plain` equal autograd of the plain forward."""
    if name == "subm":
        _, pst, _ = voxel_set(S2, seed=42)
        nbr, n_in = sc.subm_rules(pst), pst.keys.numel()
    else:
        k, s, p, shape, out_shape = DOWNS[name]
        _, pst, _ = voxel_set(shape, seed=42)
        nbr = sc.down_rules(pst, sc.downsample_sites(pst, k, s, p, out_shape), k, s, p)
        n_in = pst.keys.numel()
    w = weights(nbr.shape[1], 8, 16, 43)
    g = cotangent(nbr.shape[0], 16, 44)
    df, dw, _ = port_grads(pst.features, nbr, w, None, g, conv=PLAIN_FWD)
    gt, wt = torch.from_numpy(g), torch.from_numpy(w)
    assert_close(sc.sparse_conv_dgrad_plain(gt, sc.transpose_rules(nbr, n_in), wt).numpy(), df)
    assert_close(sc.sparse_conv_wgrad_plain(pst.features, gt, nbr).numpy(), dw)


@pytest.fixture
def plain_kernels(monkeypatch):
    """The plain versions that the ops' CPU bodies look up at each call,
    wrapped to count the calls (the outermost only: the input gradient's
    plain version is the forward's on the transposed map)."""
    calls, inside = [], []

    def counted(name, fn):
        def wrapped(*args):
            if not inside:
                calls.append(name)
            inside.append(name)
            try:
                return fn(*args)
            finally:
                inside.pop()
        return wrapped
    monkeypatch.setattr(sc, "sparse_conv_plain", counted("fwd", PLAIN_FWD))
    monkeypatch.setattr(sc, "sparse_conv_dgrad_plain", counted("dgrad", PLAIN_DGRAD))
    monkeypatch.setattr(sc, "sparse_conv_wgrad_plain", counted("wgrad", PLAIN_WGRAD))
    return calls


@pytest.mark.parametrize("given_nbr_t", [True, False], ids=["shared_map", "built_in_backward"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sparse_conv_function_wiring(plain_kernels, given_nbr_t, dtype):
    """Gradients through `unidistill::sparse_conv` equal autograd of the
    plain version; g is cast to the features' dtype before the input
    gradient, dW and dbias come back in the dtype of their inputs."""
    k, s, p, shape, out_shape = DOWNS["down4"]
    _, pst, _ = voxel_set(shape, seed=45)
    nbr = sc.down_rules(pst, sc.downsample_sites(pst, k, s, p, out_shape), k, s, p)
    nbr_t = sc.transpose_rules(nbr, pst.keys.numel()) if given_nbr_t else None
    x = torch.nn.functional.pad(pst.features, (0, 8)).to(dtype)  # Cin 16
    w = torch.from_numpy(weights(27, 16, 32, 46)).to(dtype)
    b = torch.randn(32, generator=torch.Generator().manual_seed(47)).to(dtype)
    g = torch.from_numpy(cotangent(nbr.shape[0], 32, 48)).to(dtype)
    got, ref = [], []
    for out, leaves in ((got, "function"), (ref, "plain")):
        xx, ww, bb = (t.clone().requires_grad_(True) for t in (x, w, b))
        if leaves == "function":
            y = sc.sparse_conv(xx, nbr, ww, bb, nbr_t)
        else:
            y = PLAIN_FWD(xx, nbr, ww, bb)
        y.backward(g)
        out += [xx.grad, ww.grad, bb.grad]
    assert plain_kernels == ["fwd", "dgrad", "wgrad"]
    for a, r in zip(got, ref):
        assert a.dtype == r.dtype == dtype
        torch.testing.assert_close(a.float(), r.float(), rtol=1e-5 if dtype == torch.float32 else 1e-2,
                                   atol=1e-5 * r.float().abs().max().item())


def test_sparse_conv_function_skips_the_input_gradient(plain_kernels):
    """conv_input's input, the voxel features, needs no gradient: no dgrad."""
    _, pst, _ = voxel_set(S3, seed=49)
    nbr = sc.subm_rules(pst)
    w = torch.from_numpy(weights(27, 8, 16, 50)).requires_grad_(True)
    sc.sparse_conv(pst.features, nbr, w).sum().backward()
    assert plain_kernels == ["fwd", "wgrad"] and w.grad is not None


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_dgrad_wrapper_refuses_cpu_tensors(dtype):
    """The input gradient's wrapper launches K4 or raises: it has no plain
    fallback for tensors off the card, in either dtype's weight layout."""
    _, pst, _ = voxel_set(S3, seed=51)
    nbr_t = sc.transpose_rules(sc.subm_rules(pst), pst.keys.numel())
    g = torch.from_numpy(cotangent(nbr_t.shape[0], 16, 52)).to(dtype)
    w = torch.from_numpy(weights(27, 16, 16, 53)).to(dtype)
    with pytest.raises(ValueError, match="CUDA"):
        sc.sparse_conv_dgrad_cuda(g, nbr_t, w)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_wgrad_wrapper_refuses_cpu_tensors(dtype):
    """The weight gradient's wrapper launches K6 or raises: it has no plain
    fallback for tensors off the card, in either dtype."""
    _, pst, _ = voxel_set(S3, seed=54)
    nbr = sc.subm_rules(pst)
    x = pst.features.to(dtype)
    g = torch.from_numpy(cotangent(nbr.shape[0], 16, 55)).to(dtype)
    with pytest.raises(ValueError, match="CUDA"):
        sc.sparse_conv_wgrad_cuda(x, g, nbr)


# (rows, K, Cin, Cout) of K6 launches: stage sizes of a LiDAR train step at
# the encoder's widths, and edges (one row, a tile, a tile and a row)
K6_PLAN_CASES = [(348439, 27, 16, 16), (444729, 27, 32, 32), (171279, 27, 64, 64),
                 (54064, 27, 128, 128), (48919, 3, 128, 128), (171279, 27, 32, 64),
                 (1, 27, 16, 16), (128, 27, 16, 32), (129, 27, 64, 128), (65, 3, 128, 128)]


@pytest.mark.parametrize("n_out,K,cin,cout", K6_PLAN_CASES)
@pytest.mark.parametrize("sms,blocks_per_sm", [(132, 2), (132, 9), (1, 1)])
def test_k6_plan_covers_every_row_in_whole_tiles(n_out, K, cin, cout, sms, blocks_per_sm):
    """K6's bf16 row split is a function of the shapes and the SM count: whole
    tiles per chunk, every row in exactly one chunk, no empty chunk, about two
    waves of (tap, chunk) blocks, within the chunk cap."""
    tile = sc.k6_tile_rows(cin, cout)
    assert tile == (64 if cin + cout > 128 else 128)
    want = sc.k6_chunks_wanted(K, sms, blocks_per_sm)
    assert (want - 1) * K < sc.K6_WAVES * sms * blocks_per_sm <= want * K
    chunks, rows = sc.k6_plan(n_out, tile, want)
    assert (chunks, rows) == sc.k6_plan(n_out, tile, want)
    tiles = -(-n_out // tile)
    cap = min(want, tiles, sc.K6_MAX_CHUNKS)
    assert rows % tile == 0 and rows >= tile
    assert (chunks - 1) * rows < n_out <= chunks * rows
    assert 2 * chunks > cap and chunks <= cap


@pytest.mark.parametrize("n_out", [1, 31, 33, 2048, 2049, 348439])
def test_k6_f32_plan_keeps_the_cuda_core_split(n_out):
    """The f32 kernel's split needs no card: 32-row tiles in at most 64
    chunks, none empty, every row in one."""
    chunks, rows = sc.k6_launch_plan(n_out, 27, 16, 16, torch.float32, torch.device("cpu"))
    assert (chunks, rows) == sc.k6_plan(n_out, sc.K6_F32_ROWS, sc.K6_F32_CHUNKS)
    assert rows % 32 == 0 and chunks <= 64
    assert (chunks - 1) * rows < n_out <= chunks * rows
