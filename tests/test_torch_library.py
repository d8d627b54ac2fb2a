"""The kernels' custom ops (`unidistill::*`) on the CPU, where each runs its
kernel's plain version.

`torch.library.opcheck` on each of the seven ops at small shapes: the
schema (no mutation, no aliasing), the autograd registration, the fake
(meta) implementation against the real one, and AOT dispatch with dynamic
shapes. The model path's ops then against the plain versions they stand
for: the forward bit for bit, and the gradients through
`unidistill::sparse_conv` and `unidistill::bev_pool` (their registered
backwards: the input gradient over the transposed map and K6, and K5)
against autograd of the plain forwards, rtol 1e-5 and atol 1e-5 of the
gradient's scale (float32 sums of the same products in another order).
"""
import numpy as np
import pytest
import torch

from unidistill_torch.ops import bev_pool, nms, sparse_conv as sc
from unidistill_torch.serving.synthetic import nms_lanes

from tests.test_torch_sparse_conv import DOWNS, S3, voxel_set, weights

torch.set_num_threads(2)
ops = torch.ops.unidistill


def _conv_case(seed, cin=8, cout=16, down=False):
    if down:
        k, s, p, shape, out_shape = DOWNS["down2"]
        _, pst, _ = voxel_set(shape, seed=seed)
        nbr = sc.down_rules(pst, sc.downsample_sites(pst, k, s, p, out_shape), k, s, p)
    else:
        _, pst, _ = voxel_set(S3, seed=seed)
        nbr = sc.subm_rules(pst)
    x = torch.nn.functional.pad(pst.features, (0, cin - pst.features.shape[1]))
    w = torch.from_numpy(weights(nbr.shape[1], cin, cout, seed + 1))
    return x, nbr, w


def _pool_case(seed, B=2, NC=2, D=3, fH=4, fW=4, C=16, nx=8, ny=8):
    rng = np.random.RandomState(seed)
    geom = torch.from_numpy(rng.randint(-3, 11, (B, NC, D, fH, fW, 3)).astype(np.int32))
    cell = bev_pool._linear_index(geom, nx, ny, 1).int()
    depth = torch.from_numpy(rng.rand(B, NC, D, fH, fW).astype(np.float32))
    ctx = torch.from_numpy(rng.randn(B, NC, fH, fW, C).astype(np.float32))
    return geom, cell, depth, ctx, (nx, ny, 1)


def _nms_case(seed, post=16):
    bev, valid = nms_lanes("clustered", seed, L=3, C=64, objects=4, per_object=6)
    return torch.from_numpy(bev), torch.from_numpy(valid), post


def _op_cases():
    x, nbr, w = _conv_case(70)
    b = torch.randn(16, generator=torch.Generator().manual_seed(71))
    nbr_t = sc.transpose_rules(nbr, x.shape[0])
    g = torch.randn(nbr.shape[0], 16, generator=torch.Generator().manual_seed(72))
    xd, nbrd, wd = _conv_case(73, down=True)
    _, cell, depth, ctx, (nx, ny, _) = _pool_case(74)
    gp = torch.randn(2, nx * ny, 16, generator=torch.Generator().manual_seed(75))
    bev, valid, post = _nms_case(76)
    words = nms.pack_mask_bits(nms.iou_over_plain(bev, valid, 0.2))
    return {
        "sparse_conv": (ops.sparse_conv, (x.requires_grad_(True), nbr, w.requires_grad_(True), b.requires_grad_(True), nbr_t)),
        "sparse_conv_down": (ops.sparse_conv, (xd.requires_grad_(True), nbrd, wd.requires_grad_(True), None, None)),
        "sparse_conv_dgrad": (ops.sparse_conv_dgrad, (g, nbr_t, w.detach())),
        "sparse_conv_wgrad": (ops.sparse_conv_wgrad, (x.detach(), g, nbr)),
        "bev_pool": (ops.bev_pool, (cell, depth.requires_grad_(True), ctx.requires_grad_(True), nx * ny)),
        "bev_pool_bwd": (ops.bev_pool_bwd, (cell, depth.detach(), ctx.detach(), gp, nx * ny)),
        "rotated_iou_mask": (ops.rotated_iou_mask, (bev, valid, 0.2)),
        "nms_greedy_select": (ops.nms_greedy_select, (words, valid, post)),
    }


@pytest.mark.parametrize("case", ["sparse_conv", "sparse_conv_down", "sparse_conv_dgrad", "sparse_conv_wgrad",
                                  "bev_pool", "bev_pool_bwd", "rotated_iou_mask", "nms_greedy_select"])
def test_opcheck(case):
    op, args = _op_cases()[case]
    torch.library.opcheck(op, args)


def test_ops_forward_equal_their_plain_versions():
    cases = _op_cases()
    with torch.no_grad():
        op, (x, nbr, w, b, _) = cases["sparse_conv"]
        assert torch.equal(op(x, nbr, w, b), sc.sparse_conv_plain(x, nbr, w, b))
        op, (cell, depth, ctx, ncells) = cases["bev_pool"]
        assert torch.equal(op(cell, depth, ctx, ncells), bev_pool.bev_pool_cells_plain(cell, depth, ctx, ncells))
        bev, valid, post = _nms_case(76)
        over = nms.iou_over_plain(bev, valid, 0.2)
        words = ops.rotated_iou_mask(bev, valid, 0.2)
        assert torch.equal(nms.unpack_mask_bits(words), over)
        for a, r in zip(ops.nms_greedy_select(words, valid, post), nms.greedy_select_plain(over, valid, post)):
            assert torch.equal(a, r)


def _close(got, ref):
    scale = max(1.0, ref.abs().max().item())
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5 * scale)


@pytest.mark.parametrize("down", [False, True], ids=["subm", "down2"])
def test_sparse_conv_gradients_match_autograd_of_plain(down):
    x, nbr, w = _conv_case(80, down=down)
    b = torch.randn(16, generator=torch.Generator().manual_seed(81))
    g = torch.randn(nbr.shape[0], 16, generator=torch.Generator().manual_seed(82))
    grads = []
    for conv in (sc.sparse_conv, sc.sparse_conv_plain):
        leaves = [t.clone().requires_grad_(True) for t in (x, w, b)]
        conv(leaves[0], nbr, leaves[1], leaves[2]).backward(g)
        grads.append([t.grad for t in leaves])
    for got, ref in zip(*grads):
        _close(got, ref)


def test_bev_pool_gradients_match_autograd_of_plain():
    geom, _, depth, ctx, vn = _pool_case(83)
    g = torch.randn(2, vn[1], vn[0], 16, generator=torch.Generator().manual_seed(84))
    grads = []
    for pool in (bev_pool.bev_pool_outer, bev_pool.bev_pool_outer_plain):
        d, c = depth.clone().requires_grad_(True), ctx.clone().requires_grad_(True)
        pool(geom, d, c, vn).backward(g)
        grads.append((d.grad, c.grad))
    for got, ref in zip(*grads):
        _close(got, ref)
