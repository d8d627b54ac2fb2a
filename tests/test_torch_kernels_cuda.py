"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: every test skips without an NVIDIA GPU. This file imports no
JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda

Tolerances: K1 rtol/atol 1e-5 (float32 atomics sum in another order); K5
rtol/atol 1e-5 (no atomics; the channel dot products sum in another order);
the K1/K5 gradient against float64 central differences of the plain forward
rtol 1e-5 (the forward is bilinear, so the differences are exact up to
float64 round-off; the kernels sum in float32); K2
float mode rtol 1e-4, atol 1e-5 (same float math, libm cos/sin may differ
by an ulp); K2 mask bits and K3 keep sets exactly (no IoU within 1e-4 of
the threshold in these inputs); K4 in float32 rtol/atol 1e-4 (up to 27·128
products summed in another order), in bfloat16 rtol 1e-2 (kernel and plain
version both sum in f32 and round once; the other order may flip that
rounding by one bf16 ulp, at most 2^-7 of the value). The sparse conv's
backward: K6 (dW) against its plain version at 1e-4 of max |ref| in float32
and in bfloat16 (bf16 products are exact in f32, so only the summation order
differs; empty tiles and taps give exact zeros); K4 as the input gradient on
strided maps as K4 forward; `SparseConv`'s gradients against autograd of the
plain version (f32 rtol/atol 1e-4 of the scale; bf16 2e-2 of the scale: dfeat
rounds once to bf16, dW is summed over bf16-rounded g in another order)
and against float64 central differences of the conv (f32, rtol 1e-3: the
conv is linear, so the difference is exact up to float64 round-off; the
kernels sum in float32).
"""
import numpy as np
import pytest
import torch

from unidistill_torch.layers.lidar_encoder import DOWN_CONVS
from unidistill_torch.ops import bev_pool, nms, sparse_conv

THR = 0.2


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels run only on the card)")
    return torch.device("cuda")


def _pool_inputs(seed, B=2, NC=3, D=7, fH=4, fW=6, C=256, nx=16, ny=12):
    rng = np.random.RandomState(seed)
    geom = rng.randint(-3, 19, (B, NC, D, fH, fW, 3)).astype(np.int32)
    geom[..., 2] = rng.choice([-1, 0, 0, 0, 1], size=geom.shape[:-1])
    depth = rng.rand(B, NC, D, fH, fW).astype(np.float32)
    ctx = rng.randn(B, NC, fH, fW, C).astype(np.float32)
    return geom, depth, ctx, (nx, ny, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [256, 64, 300])
def test_bev_pool_kernel_matches_plain(cuda_device, C):
    geom, depth, ctx, vn = _pool_inputs(0, C=C)
    args = [torch.from_numpy(a).to(cuda_device) for a in (geom, depth, ctx)]
    from unidistill_torch.kernels import build
    before = build.LAUNCHES["bev_pool_fwd"]
    got = bev_pool.bev_pool_outer(*args, vn)
    assert build.LAUNCHES["bev_pool_fwd"] == before + 1
    ref = bev_pool.bev_pool_outer_plain(*args, vn)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
@pytest.mark.parametrize("C,fH,fW", [(256, 4, 6), (300, 3, 5)], ids=["C256", "C300_ragged"])
def test_bev_pool_backward_kernel_matches_plain(cuda_device, C, fH, fW):
    """K5 against its plain version; points outside the grid get 0."""
    geom, depth, ctx, (nx, ny, nz) = _pool_inputs(1, C=C, fH=fH, fW=fW)
    cell = bev_pool._linear_index(torch.from_numpy(geom), nx, ny, nz).int().to(cuda_device)
    depth, ctx = torch.from_numpy(depth).to(cuda_device), torch.from_numpy(ctx).to(cuda_device)
    g = torch.randn(depth.shape[0], nx * ny, C, generator=torch.Generator().manual_seed(2)).to(cuda_device)
    from unidistill_torch.kernels import build
    before = build.LAUNCHES["bev_pool_bwd"]
    gd, gc = bev_pool.bev_pool_bwd_cuda(cell, depth, ctx, g, nx * ny)
    assert build.LAUNCHES["bev_pool_bwd"] == before + 1
    rd, rc = bev_pool.bev_pool_outer_bwd_plain(cell, depth, ctx, g, nx * ny)
    torch.cuda.synchronize()
    outside = (cell < 0) | (cell >= nx * ny)
    assert outside.any() and (gd[outside] == 0).all()
    torch.testing.assert_close(gd, rd, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gc, rc, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_bev_pool_gives_gradients_on_the_card(cuda_device):
    """bev_pool_outer on CUDA tensors is differentiable (K1 forward, K5
    backward) and its gradients equal autograd of the plain version."""
    geom, depth, ctx, vn = _pool_inputs(2, C=64)
    from unidistill_torch.kernels import build
    before = build.LAUNCHES["bev_pool_bwd"]
    args = [torch.from_numpy(a).to(cuda_device) for a in (geom, depth, ctx)]
    d, c = args[1].requires_grad_(True), args[2].requires_grad_(True)
    out = bev_pool.bev_pool_outer(args[0], d, c, vn)
    g = torch.randn_like(out)
    out.backward(g)
    assert build.LAUNCHES["bev_pool_bwd"] == before + 1
    d2, c2 = args[1].detach().clone().requires_grad_(True), args[2].detach().clone().requires_grad_(True)
    bev_pool.bev_pool_outer_plain(args[0], d2, c2, vn).backward(g)
    torch.testing.assert_close(d.grad, d2.grad, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(c.grad, c2.grad, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_bev_pool_function_against_finite_differences(cuda_device):
    """gradcheck-style: <K5(g), v> against the float64 central difference
    of <g, plain forward> along random directions v of depth and context."""
    geom, depth, ctx, vn = _pool_inputs(3, B=1, NC=2, D=5, fH=3, fW=4, C=40, nx=8, ny=6)
    geom = torch.from_numpy(geom).to(cuda_device)
    d = torch.from_numpy(depth).to(cuda_device).requires_grad_(True)
    c = torch.from_numpy(ctx).to(cuda_device).requires_grad_(True)
    out = bev_pool.bev_pool_outer(geom, d, c, vn)
    gen = torch.Generator().manual_seed(4)
    g = torch.randn(out.shape, generator=gen, dtype=torch.float64).to(cuda_device)
    out.backward(g.float())
    d64, c64 = d.detach().double(), c.detach().double()
    f = lambda dd, cc: (g * bev_pool.bev_pool_outer_plain(geom, dd, cc, vn)).sum()
    eps = 1e-3
    for _ in range(4):
        vd = torch.randn(d64.shape, generator=gen, dtype=torch.float64).to(cuda_device)
        vc = torch.randn(c64.shape, generator=gen, dtype=torch.float64).to(cuda_device)
        fd = (f(d64 + eps * vd, c64 + eps * vc) - f(d64 - eps * vd, c64 - eps * vc)) / (2 * eps)
        an = (d.grad.double() * vd).sum() + (c.grad.double() * vc).sum()
        torch.testing.assert_close(an, fd, rtol=1e-5, atol=1e-6)


def _lanes(device, L=3, K=128):
    """Clustered score-sorted lanes whose pairwise IoUs all stay 1e-4 away
    from THR (the first such seed)."""
    for seed in range(100):
        boxes, valid = _draw_lanes(seed, L, K)
        bev = nms.bev_boxes(boxes)
        if ((nms.rotated_iou_bev_plain(bev, bev) - THR).abs() > 1e-4).all():
            return boxes.to(device), valid.to(device)
    raise AssertionError("no seed keeps the IoUs off the threshold")


def _draw_lanes(seed, L, K):
    g = torch.Generator().manual_seed(seed)
    u = lambda lo, hi, *s: lo + (hi - lo) * torch.rand(*s, generator=g)
    centers = u(-15, 15, L, K // 4, 2)
    pick = torch.randint(0, K // 4, (L, K), generator=g)
    boxes = torch.zeros(L, K, 7)
    boxes[..., 0:2] = torch.gather(centers, 1, pick[..., None].expand(L, K, 2)) + 0.6 * torch.randn(L, K, 2, generator=g)
    boxes[..., 3:5] = u(1.5, 4, L, K, 2)
    boxes[..., 6] = u(-np.pi, np.pi, L, K)
    boxes[:, 1] = boxes[:, 0]
    valid = torch.ones(L, K, dtype=torch.bool)
    valid[:, -7:] = False
    return boxes, valid


@pytest.mark.cuda
def test_iou_kernel_matches_plain(cuda_device):
    boxes, _ = _lanes(cuda_device)
    bev = nms.bev_boxes(boxes).contiguous()
    got = nms.rotated_iou_bev(bev, bev[:, :50].contiguous())
    torch.testing.assert_close(got, nms.rotated_iou_bev_plain(bev, bev[:, :50]), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_nms_kernels_match_plain(cuda_device):
    boxes, valid = _lanes(cuda_device)
    bev, v = nms._candidate_lanes(boxes, valid, 40, 512)
    words = nms.rotated_iou_mask_cuda(bev, v, THR)
    assert torch.equal(words, nms.pack_mask_bits(nms.iou_over_plain(bev, v, THR)))
    idx, mask = nms.nms_greedy_select_cuda(words, v, 40)
    ridx, rmask = nms.greedy_select_plain(nms.unpack_mask_bits(words), v, 40)
    assert torch.equal(idx, ridx) and torch.equal(mask, rmask)
    bidx, bmask = nms.nms_bev_batched(boxes, valid, THR, 40)
    pidx, pmask = nms.nms_bev_batched_plain(boxes, valid, THR, 40)
    assert torch.equal(bidx, pidx) and torch.equal(bmask, pmask)


def _sparse_inputs(device, dtype, n_in, n_out, K, cin, cout, seed, missing=0.6):
    g = torch.Generator().manual_seed(seed)
    feats = torch.randn(n_in, cin, generator=g)
    nbr = torch.randint(0, n_in, (n_out, K), generator=g, dtype=torch.int32)
    nbr[torch.rand(n_out, K, generator=g) < missing] = -1
    nbr[64:128] = -1                     # a tile with no neighbour at all
    nbr[128:192, : K // 2] = -1          # a tile whose first taps are all missing
    w = torch.randn(K, cin, cout, generator=g) * (1.0 / (K * cin)) ** 0.5
    bias = torch.randn(cout, generator=g)
    return (feats.to(device, dtype), nbr.to(device), w.to(device, dtype), bias.to(device, dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K,cin,cout", [(27, 5, 16), (27, 16, 16), (27, 16, 32), (27, 48, 64),
                                        (27, 128, 128), (3, 128, 128)])
def test_sparse_conv_kernel_matches_plain(cuda_device, dtype, K, cin, cout):
    from unidistill_torch.kernels import build
    feats, nbr, w, bias = _sparse_inputs(cuda_device, dtype, 3001, 2777, K, cin, cout, seed=cin + K)
    before = build.LAUNCHES["sparse_conv_fwd"]
    got = sparse_conv.sparse_conv(feats, nbr, w, bias)
    assert build.LAUNCHES["sparse_conv_fwd"] == before + 1
    ref = sparse_conv.sparse_conv_plain(feats, nbr, w, bias)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (2777, cout)
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-5)
    torch.testing.assert_close(got.float(), ref.float(), **tol)
    assert torch.equal(got[64:128].float(), bias.float().expand(64, cout).to(dtype).float())


@pytest.mark.cuda
def test_sparse_conv_kernel_on_rulebooks(cuda_device):
    """A SubM map from the rulebook code, without bias, in float32."""
    g = torch.Generator().manual_seed(3)
    shape = (9, 30, 30)
    D, H, W = shape
    keys = torch.unique(torch.randint(0, D * H * W, (3000,), generator=g))
    col = keys // D
    coords = torch.stack([keys % D, col // W, col % W], 1).to(torch.int32)
    feats = torch.randn(1, len(keys), 16, generator=g)
    st = sparse_conv.from_voxels(feats, coords[None], shape)
    st = sparse_conv.SparseTensor(st.features.to(cuda_device), st.coords.to(cuda_device),
                                  st.keys.to(cuda_device), shape, 1)
    nbr = sparse_conv.subm_rules(st)
    w = (torch.randn(27, 16, 32, generator=g) * 0.1).to(cuda_device)
    got = sparse_conv.sparse_conv(st.features, nbr, w)
    torch.testing.assert_close(got, sparse_conv.sparse_conv_plain(st.features, nbr, w), rtol=1e-4, atol=1e-4)


# (K, Cin, Cout) of the encoder's sparse convs: conv_input, the four residual
# widths, down2, down3, down4, conv_out
ENCODER_CONVS = [(27, 5, 16), (27, 16, 16), (27, 32, 32), (27, 64, 64), (27, 128, 128),
                 (27, 16, 32), (27, 32, 64), (27, 64, 128), (3, 128, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("K,cin,cout", ENCODER_CONVS)
def test_sparse_conv_wgrad_kernel_matches_plain(cuda_device, dtype, K, cin, cout):
    """K6 at each conv shape; rows 64-127 have no neighbour (empty tiles)
    and tap 1 none anywhere (an all -1 tap gives an exact 0)."""
    from unidistill_torch.kernels import build
    feats, nbr, _, _ = _sparse_inputs(cuda_device, dtype, 3001, 2777, K, cin, cout, seed=cin + cout + K)
    nbr[:, 1] = -1
    g = torch.randn(2777, cout, generator=torch.Generator().manual_seed(K)).to(cuda_device, dtype)
    before = build.LAUNCHES["sparse_conv_wgrad"]
    got = sparse_conv.sparse_conv_wgrad_cuda(feats, g, nbr)
    assert build.LAUNCHES["sparse_conv_wgrad"] == before + 1
    ref = sparse_conv.sparse_conv_wgrad_plain(feats, g, nbr)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (K, cin, cout)
    assert (got[1] == 0).all()
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())
    assert torch.equal(got, sparse_conv.sparse_conv_wgrad_cuda(feats, g, nbr))  # deterministic


@pytest.mark.cuda
def test_sparse_conv_wgrad_kernel_is_deterministic(cuda_device):
    """Two K6 runs over 300 000 rows (64 chunks per tap) are bit-equal."""
    feats, nbr, _, _ = _sparse_inputs(cuda_device, torch.bfloat16, 320000, 300000, 27, 16, 16, seed=5)
    g = torch.randn(300000, 16, generator=torch.Generator().manual_seed(6)).to(cuda_device, torch.bfloat16)
    a = sparse_conv.sparse_conv_wgrad_cuda(feats, g, nbr)
    b = sparse_conv.sparse_conv_wgrad_cuda(feats, g, nbr)
    assert torch.equal(a, b)
    ref = sparse_conv.sparse_conv_wgrad_plain(feats, g, nbr)
    torch.testing.assert_close(a, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())


def _stage(device, shape, n, seed, C):
    """n random sites of a (D, H, W) grid with C random features, on the card."""
    g = torch.Generator().manual_seed(seed)
    D, H, W = shape
    keys = torch.unique(torch.randint(0, D * H * W, (n,), generator=g))
    col = keys // D
    coords = torch.stack([keys % D, col // W, col % W], 1).to(torch.int32)
    st = sparse_conv.from_voxels(torch.randn(1, len(keys), C, generator=g), coords[None], shape)
    return sparse_conv.SparseTensor(st.features.to(device), st.coords.to(device), st.keys.to(device), shape, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("conv", DOWN_CONVS, ids=[c[0] for c in DOWN_CONVS])
def test_sparse_conv_dgrad_on_strided_maps(cuda_device, dtype, conv):
    """K4 over the transposed map of each strided conv of the encoder (input
    sites no output reads get 0) against its plain version."""
    from unidistill_torch.kernels import build
    _, cin, cout, k, s, p = conv
    shape = (5, 30, 30) if k == (3, 1, 1) else (11, 30, 30)
    st = _stage(cuda_device, shape, 4000, seed=cin, C=cin)
    out_shape = tuple((d + 2 * pd - kd) // sd + 1 for d, kd, sd, pd in zip(shape, k, s, p))
    out = sparse_conv.downsample_sites(st, k, s, p, out_shape)
    nbr = sparse_conv.down_rules(st, out, k, s, p)
    nbr_t = sparse_conv.transpose_rules(nbr, st.keys.numel())
    gen = torch.Generator().manual_seed(cout)
    g = torch.randn(nbr.shape[0], cout, generator=gen).to(cuda_device, dtype)
    w = (torch.randn(nbr.shape[1], cin, cout, generator=gen) * 0.1).to(cuda_device, dtype)
    before = build.LAUNCHES["sparse_conv_dgrad"]
    got = sparse_conv.sparse_conv_dgrad_cuda(g, nbr_t, w)
    assert build.LAUNCHES["sparse_conv_dgrad"] == before + 1
    ref = sparse_conv.sparse_conv_dgrad_plain(g, nbr_t, w)
    torch.cuda.synchronize()
    assert got.shape == (st.keys.numel(), cin) and got.dtype == dtype
    unread = (nbr_t < 0).all(1)
    assert (got[unread] == 0).all()
    tol = dict(rtol=1e-4, atol=1e-4) if dtype == torch.float32 else dict(rtol=1e-2, atol=1e-5)
    torch.testing.assert_close(got.float(), ref.float(), **tol)


def _conv_case(device, dtype, n, cin, cout, seed):
    st = _stage(device, (9, 24, 24), n, seed, cin)
    nbr = sparse_conv.subm_rules(st)
    gen = torch.Generator().manual_seed(seed + 1)
    w = (torch.randn(27, cin, cout, generator=gen) * (1.0 / (27 * cin)) ** 0.5).to(device)
    b = torch.randn(cout, generator=gen).to(device)
    g = torch.randn(nbr.shape[0], cout, generator=gen).to(device)
    return st.features.to(dtype), nbr, w, b, g


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_sparse_conv_function_gradients_match_plain(cuda_device, dtype):
    """`sparse_conv` with gradients on the card (K4, K4 dgrad, K6) against
    autograd of the plain version on the same inputs; the f32 masters are
    cast to the compute dtype at the call, as the encoder does."""
    from unidistill_torch.kernels import build
    x, nbr, w, b, g = _conv_case(cuda_device, dtype, 3000, 32, 64, seed=7)
    grads = []
    for fn in (sparse_conv.sparse_conv, sparse_conv.sparse_conv_plain):
        xx = x.detach().clone().requires_grad_(True)
        ww, bb = w.detach().clone().requires_grad_(True), b.detach().clone().requires_grad_(True)
        before = dict(build.LAUNCHES)
        out = fn(xx, nbr, ww.to(dtype), bb.to(dtype))
        out.backward(g.to(dtype))
        grads.append((xx.grad, ww.grad, bb.grad))
        if fn is sparse_conv.sparse_conv:
            for name in ("sparse_conv_fwd", "sparse_conv_dgrad", "sparse_conv_wgrad"):
                assert build.LAUNCHES[name] == before.get(name, 0) + 1, name
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, ref, name in zip(grads[0], grads[1], ("features", "weight", "bias")):
        scale = ref.float().abs().max().item()
        assert scale > 0, name
        torch.testing.assert_close(got.float() / scale, ref.float() / scale, rtol=tol, atol=tol, msg=name)


@pytest.mark.cuda
def test_sparse_conv_function_against_finite_differences(cuda_device):
    """<gradients, v> against the float64 central difference of <g, plain
    forward> along random directions v of the features, weight and bias."""
    x, nbr, w, b, g = _conv_case(cuda_device, torch.float32, 600, 16, 16, seed=11)
    xx, ww, bb = (t.detach().clone().requires_grad_(True) for t in (x, w, b))
    sparse_conv.sparse_conv(xx, nbr, ww, bb).backward(g)
    idx = torch.where(nbr < 0, x.shape[0], nbr).long()

    def f(a, c, d):  # <g, the conv> in float64
        az = torch.cat([a, a.new_zeros(1, a.shape[1])])
        return (g.double() * (sum(az[idx[:, k]] @ c[k] for k in range(nbr.shape[1])) + d)).sum()

    gen = torch.Generator().manual_seed(12)
    eps = 1e-3
    for _ in range(3):
        v = [torch.randn(t.shape, generator=gen, dtype=torch.float64).to(cuda_device) for t in (x, w, b)]
        p64 = [t.detach().double() for t in (x, w, b)]
        fd = (f(*[p + eps * d for p, d in zip(p64, v)]) - f(*[p - eps * d for p, d in zip(p64, v)])) / (2 * eps)
        an = sum((t.grad.double() * d).sum() for t, d in zip((xx, ww, bb), v))
        torch.testing.assert_close(an, fd, rtol=1e-3, atol=1e-6)
