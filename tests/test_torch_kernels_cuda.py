"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: every test skips without an NVIDIA GPU. This file imports no
JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda

Tolerances: K1 rtol/atol 1e-5 (it sums (sum of a ray's depths) x context
per (cell, ray) run where the plain version sums depth x context with
`index_add_`'s atomics: float32 sums in another order), and bit-identical
on a rerun (no atomics); where a cell sums hundreds of points (the reruns,
all points in one cell) K1 against the plain version in float64 at rtol/atol
1e-5, because float32 sums of 500 products in two orders differ by about
1e-5 near a cancellation; K1's plan on the card equal to the CPU's; K5
rtol/atol 1e-5 (no atomics; the channel dot products sum in another order),
bit-identical on a rerun, and at full width against the plain version in
float64 at 1e-5; the voxeliser's features bit-identical on a rerun and
equal to the CPU's (each voxel sums its points in point order, no atomics);
the K1/K5 gradient against float64 central differences of the plain forward
rtol 1e-5 (the forward is bilinear, so the differences are exact up to
float64 round-off; the kernels sum in float32); K2
float mode rtol 1e-4, atol 1e-5 (same float math, libm cos/sin may differ
by an ulp); K2 mask bits and K3 keep sets exactly (no IoU within 1e-4 of
the threshold in these inputs); K2's mask on the layouts of
`synthetic.nms_lanes` bit for bit where the IoU lies outside `K2_THR_BAND`
of the threshold (and exactly where no IoU comes within 1e-4 of it), zero
below the diagonal, bit-identical on a rerun; K3 equal to the plain greedy
on random, empty, row-0-suppresses-all and all-invalid masks at C 64 to 4096
(above 32 words a row) and post 1, 100 and C, bit-identical on a rerun; K4 in float32 rtol/atol 1e-4 (up to 27·128
products summed in another order), in bfloat16 rtol 1e-2 (kernel and plain
version both sum in f32 and round once; the other order may flip that
rounding by one bf16 ulp, at most 2^-7 of the value; the bf16 instance
multiplies on the tensor cores, whose bf16 products are exact in f32 as
the plain version's are). The sparse conv's
backward: K6 (dW) against its plain version at 1e-4 of max |ref| in float32
and in bfloat16 (bf16 products are exact in f32, so only the summation order
differs; empty tiles and taps give exact zeros; the bf16 instance runs on
the tensor cores, whose bf16 products are exact in f32 as the plain
version's are); K4 as the input gradient on
strided maps as K4 forward; `unidistill::sparse_conv`'s gradients against autograd of the
plain version (f32 rtol/atol 1e-4 of the scale; bf16 2e-2 of the scale: dfeat
rounds once to bf16, dW is summed over bf16-rounded g in another order)
and against float64 central differences of the conv (f32, rtol 1e-3: the
conv is linear, so the difference is exact up to float64 round-off; the
kernels sum in float32). The microbenchmark kernels: K7 (fused select +
products) at 1e-5 of max |ref| (exact bf16 products summed in f32 in
another order; rows whose one-hot is not a single 1.0 take the Pallas
select's bf16 multiply-adds in both, so their windows agree bit for bit)
and bit-equal on a rerun, on ragged tiles, at B 3, at each C class of its
k-step and each 4co, with its output in a block just filled with NaN; K8 (2x + y in bf16) and the band
gathers K9 (unroll 1 and 4), K10 and K11 bit-equal to their plain versions
(each output of K11 is a sum with one nonzero term), K11 also on the
layouts of `mb_gather_pallas.band_layout` and bit-identical on a rerun;
K8 at sizes around its 8-value vectors and on views off the 16-byte grid,
K9 and K10 on the edges of K10's tile and past 2 GB of table, each output
in a block just filled with NaN.
"""
import numpy as np
import pytest
import torch

from unidistill_torch.layers.lidar_encoder import DOWN_CONVS
from unidistill_torch.ops import band_gather, bev_pool, fused_offsets, nms, sparse_conv
from unidistill_torch.serving.synthetic import nms_lanes

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


def _large_pool_inputs(device, seed=5, C=256):
    """Up to 72 points a cell, in runs along the rays."""
    geom, depth, ctx, vn = _pool_inputs(seed, B=2, NC=6, D=40, fH=8, fW=22, C=C, nx=24, ny=24)
    geom[..., 0] = (geom[..., 0] + np.arange(40)[:, None, None] // 4) % 30 - 3  # 4 bins a cell along a ray
    return [torch.from_numpy(a).to(device) for a in (geom, depth, ctx)], vn


@pytest.mark.cuda
@pytest.mark.parametrize("C", [256, 300])
def test_bev_pool_kernel_is_bit_identical_on_reruns(cuda_device, C):
    args, vn = _large_pool_inputs(cuda_device, C=C)
    first = bev_pool.bev_pool_outer(*args, vn)
    for _ in range(3):
        assert torch.equal(bev_pool.bev_pool_outer(*args, vn), first)
    ref = bev_pool.bev_pool_outer_plain(args[0], args[1].double(), args[2].double(), vn)
    torch.testing.assert_close(first.double(), ref, rtol=1e-5, atol=1e-5)


@pytest.mark.cuda
def test_bev_pool_plan_on_the_card_equals_the_cpu(cuda_device):
    args, (nx, ny, nz) = _large_pool_inputs(cuda_device)
    cell = bev_pool._linear_index(args[0], nx, ny, nz).int()
    order, offsets = bev_pool.bev_pool_plan(cell, nx * ny)
    order_c, offsets_c = bev_pool.bev_pool_plan(cell.cpu(), nx * ny)
    assert torch.equal(order.cpu(), order_c) and torch.equal(offsets.cpu(), offsets_c)
    assert (offsets.diff() > 32).any()  # a cell takes more than one 32-point batch


@pytest.mark.cuda
def test_bev_pool_forward_makes_no_host_sync(cuda_device):
    """The K1 path (cells, plan, reduce) under the sync debug mode "error"."""
    args, vn = _large_pool_inputs(cuda_device)
    ref = bev_pool.bev_pool_outer(*args, vn)  # builds and loads the library
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        with pytest.raises(RuntimeError):  # the mode catches a sync (a control)
            args[1].nonzero()
        out = bev_pool.bev_pool_outer(*args, vn)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.equal(out, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [64, 300])
def test_bev_pool_kernel_all_points_in_one_cell(cuda_device, C):
    geom, depth, ctx, vn = _pool_inputs(6, C=C)
    geom[..., 0], geom[..., 1], geom[..., 2] = 7, 4, 0
    args = [torch.from_numpy(a).to(cuda_device) for a in (geom, depth, ctx)]
    from unidistill_torch.kernels import build
    before = build.LAUNCHES["bev_pool_fwd"]
    got = bev_pool.bev_pool_outer(*args, vn)
    assert build.LAUNCHES["bev_pool_fwd"] == before + 1
    ref = bev_pool.bev_pool_outer_plain(args[0], args[1].double(), args[2].double(), vn)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.double(), ref, rtol=1e-5, atol=1e-5)
    assert (got[:, 4, 7] != 0).all() and (got.sum(-1) != 0).sum() == 2


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


def _bwd_case(device, cell, C, seed):
    """Random depth, context and g for the flat cells `cell` (180 x 180 grid)."""
    B, NC, D, fH, fW = cell.shape
    rng = np.random.RandomState(seed)
    depth = torch.from_numpy(rng.rand(B, NC, D, fH, fW).astype(np.float32))
    ctx = torch.from_numpy(rng.randn(B, NC, fH, fW, C).astype(np.float32))
    g = torch.from_numpy(rng.randn(B, 180 * 180, C).astype(np.float32))
    return [t.to(device) for t in (cell.contiguous(), depth, ctx, g)]


def _bwd_plain_f64(cell, depth, ctx, g, ncells):
    """K5's function in float64, one sample at a time."""
    gd, gc = [], []
    for b in range(cell.shape[0]):
        valid = (cell[b] >= 0) & (cell[b] < ncells)
        rows = torch.cat([g[b].double(), g.new_zeros(1, g.shape[-1], dtype=torch.float64)])
        rows = rows[torch.where(valid, cell[b], ncells).long()]  # [NC, D, fH, fW, C]
        gd.append((rows * ctx[b].double()[:, None]).sum(-1))
        gc.append((rows * depth[b].double()[..., None]).sum(1))
    return torch.stack(gd), torch.stack(gc)


def _nuscenes_cells(B, fH, fW, **kw):
    """The level nuScenes-like cameras at a feature map of fH x fW: the rays
    of a column share their cell at every depth bin, where it is in the
    grid (the z range drops the far points of the upper rows); `kw` as
    `nuscenes_cells` (the training image augmentation, a pitch)."""
    import dataclasses
    from unidistill_torch.configs.nuscenes import camera_exp
    from unidistill_torch.serving.synthetic import nuscenes_cells
    cfg = camera_exp().model
    ce = cfg.camera_encoder
    ce = dataclasses.replace(ce, final_dim=(fH * ce.downsample_factor, fW * ce.downsample_factor))
    return nuscenes_cells(dataclasses.replace(cfg, camera_encoder=ce), B, seed=0, **kw)


def _mixed_cells(B=2, NC=2, D=24, fH=16, fW=5, ncells=180 * 180, seed=7):
    """Columns whose rays disagree: per column, rays in 1-3 cells that
    change every few bins, rays out of the grid (both ends of the range),
    a ray that keeps its cell while the others change, and column w = 0
    wholly outside the grid."""
    rng = np.random.RandomState(seed)
    h, d = np.arange(fH)[:, None], np.arange(D)[None, :]
    cell = np.empty((B, NC, D, fH, fW), np.int64)
    for b in range(B):
        for n in range(NC):
            for w in range(fW):
                pick = rng.randint(0, ncells, (3, D))
                q = pick[(h % 3 + d // 4) % 3, d]  # [fH, D]
                q[1] = pick[0, 0]                  # one ray stays in its cell
                q[2, ::5] = -1
                q[-1, 1::7] = ncells
                q[0, :] = pick[0, d // 6]          # runs of six bins
                cell[b, n, :, :, w] = q.T
    cell[..., 0] = rng.choice([-1, ncells, ncells + 3], size=cell[..., 0].shape)
    return torch.from_numpy(cell.astype(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["level_fH4", "mixed_fH16", "mixed_fH3_C300", "mixed_fH16_C37", "nuscenes_fH16",
                                  "mixed_fH20", "mixed_fH20_C300", "train_ida_fH16", "train_ida_pitch2_fH16"])
def test_bev_pool_backward_kernel_on_camera_columns(cuda_device, case):
    """K5 against its plain version (rtol/atol 1e-5) on column geometries:
    the level cameras at fH 4, fW 6 (every column shares its in-grid cell);
    mixed cells with a column wholly outside the grid at fH 16, C 256, at
    fH 3, C 300, and at C 37 (rows of single floats, not float4s); at fH 20
    (two passes over a column's rays), C 256 and C 300; the cameras at full
    width, fH 16, fW 44, level, under the training image augmentation, and
    under it pitched 2 degrees down."""
    from unidistill_torch.configs.nuscenes import DataConfig
    from unidistill_torch.kernels import build
    ncells = 180 * 180
    C = {"level_fH4": 64, "mixed_fH3_C300": 300, "mixed_fH16_C37": 37, "mixed_fH20_C300": 300}.get(case, 256)
    if case == "level_fH4":
        cell = _nuscenes_cells(2, 4, 6)
        q = torch.where(cell < ncells, cell, -1).permute(0, 1, 4, 2, 3).sort(-1).values
        distinct = (q >= 0) & torch.cat([torch.ones_like(q[..., :1], dtype=torch.bool), q[..., 1:] != q[..., :-1]], -1)
        assert distinct.sum(-1).max() == 1 and (cell >= ncells).any()
    elif case == "nuscenes_fH16":
        cell = _nuscenes_cells(1, 16, 44)
    elif case.startswith("train_ida"):
        cell = _nuscenes_cells(2, 16, 44, data=DataConfig(), pitch_deg=2.0 if "pitch2" in case else 0.0)
    else:
        cell = _mixed_cells(fH=int(case.split("_")[1][2:]))
    cell, depth, ctx, g = _bwd_case(cuda_device, cell, C, seed=len(case))
    before = build.LAUNCHES["bev_pool_bwd"]
    gd, gc = bev_pool.bev_pool_bwd_cuda(cell, depth, ctx, g, ncells)
    assert build.LAUNCHES["bev_pool_bwd"] == before + 1
    rd, rc = bev_pool.bev_pool_outer_bwd_plain(cell, depth, ctx, g, ncells)
    torch.cuda.synchronize()
    outside = (cell < 0) | (cell >= ncells)
    assert (gd[outside] == 0).all()
    torch.testing.assert_close(gd, rd, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gc, rc, rtol=1e-5, atol=1e-5)
    if case.startswith("mixed"):
        gone = outside.all(2).all(2)  # [B, NC, fW]: columns with no point in the grid
        assert gone[..., 0].all() and (gc.permute(0, 1, 3, 2, 4)[gone] == 0).all()


@pytest.mark.cuda
def test_bev_pool_backward_kernel_is_bit_identical_at_full_width(cuda_device):
    """K5 at full width (B 4, six cameras, D 112, fH 16, fW 44, C 256) on
    the nuScenes-like cameras: three reruns give the same bits, and both
    gradients equal the float64 plain version at rtol/atol 1e-5."""
    ncells = 180 * 180
    cell, depth, ctx, g = _bwd_case(cuda_device, _nuscenes_cells(4, 16, 44), 256, seed=9)
    gd, gc = bev_pool.bev_pool_bwd_cuda(cell, depth, ctx, g, ncells)
    for _ in range(3):
        gd2, gc2 = bev_pool.bev_pool_bwd_cuda(cell, depth, ctx, g, ncells)
        assert torch.equal(gd2, gd) and torch.equal(gc2, gc)
    rd, rc = _bwd_plain_f64(cell, depth, ctx, g, ncells)
    torch.testing.assert_close(gd.double(), rd, rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(gc.double(), rc, rtol=1e-5, atol=1e-5)


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


def _k2_lanes(device, layout, L, C, seed=0):
    bev, valid = nms_lanes(layout, seed, L=L, C=C, objects=max(1, C // 16), per_object=12)
    valid[:, -3:] = False
    return torch.from_numpy(bev).to(device), torch.from_numpy(valid).to(device)


def _check_k2_words(words, bev, valid, thr):
    """K2's words against the plain mask: equal bit for bit outside the band
    (and exactly where no IoU comes within 1e-4 of thr), zero below the
    diagonal, and equal on a rerun."""
    L, C = valid.shape
    iou = nms.rotated_iou_bev_plain(bev, bev)
    over = nms.iou_over_plain(bev, valid, thr)
    diff = nms.unpack_mask_bits(words) ^ over
    assert ((iou - thr).abs()[diff] < nms.K2_THR_BAND).all(), int(diff.sum())
    if ((iou - thr).abs() > 1e-4).all():
        assert torch.equal(words, nms.pack_mask_bits(over))
    below = torch.arange(C // 64, device=words.device)[None, :] < (torch.arange(C, device=words.device) // 64)[:, None]
    assert not words[:, below].any()
    assert torch.equal(words, nms.rotated_iou_mask_cuda(bev, valid, thr))


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [-0.1, 0.0, 0.1, 0.8])
@pytest.mark.parametrize("L,C", [(1, 64), (24, 64), (1, 128), (24, 128), (1, 512), (24, 512), (1, 1024), (24, 1024)])
@pytest.mark.parametrize("layout", ["spread", "clustered", "coincident", "touching", "mixed_sizes", "tiny"])
def test_iou_mask_kernel_matches_plain(cuda_device, layout, L, C, thr):
    bev, valid = _k2_lanes(cuda_device, layout, L, C)
    _check_k2_words(nms.rotated_iou_mask_cuda(bev, valid, thr), bev, valid, thr)


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [0.0, 0.1])
def test_iou_mask_kernel_on_boxes_the_filter_cannot_bound(cuda_device, thr):
    """Boxes 6 km out, with a 0.1 mm side 60 m out, zero dims or NaN: the
    filter clips every pair of theirs."""
    cx = torch.tensor([0.0, 6000.0, 6001.0, 60.0, 61.0, 0.5, float("nan"), 0.4])
    bev = torch.stack([cx, torch.tensor([0.0, 0.0, 0.5, 1.0, 1.0, 0.0, 0.0, 0.2]),
                       torch.tensor([2.0, 4.0, 4.0, 1e-4, 2.0, 0.0, 2.0, 2.0]),
                       torch.tensor([2.0, 2.0, 2.0, 3.0, 2.0, 0.0, 2.0, 2.0]),
                       torch.tensor([0.3, 0.0, 0.1, 0.2, 0.0, 0.0, 0.0, 0.1])], 1)
    bev = torch.cat([bev, bev[:1] + torch.arange(1.0, 57.0)[:, None] * torch.tensor([3.0, 0, 0, 0, 0])])
    bev, valid = bev[None].contiguous().to(cuda_device), torch.ones(1, 64, dtype=torch.bool, device=cuda_device)
    _check_k2_words(nms.rotated_iou_mask_cuda(bev, valid, thr), bev, valid, thr)


@pytest.mark.cuda
@pytest.mark.parametrize("thr", [-0.1, 0.1])
def test_iou_mask_kernel_with_every_row_invalid(cuda_device, thr):
    bev, valid = _k2_lanes(cuda_device, "coincident", 3, 256)
    valid[:] = False
    words = nms.rotated_iou_mask_cuda(bev, valid, thr)
    assert not words.any()
    _check_k2_words(words, bev, valid, thr)


def _k3_mask(kind, L, C, seed=0):
    """An upper-triangular suppression mask [L, C, C] and valid [L, C]."""
    g = torch.Generator().manual_seed(seed)
    valid = torch.rand(L, C, generator=g) < 0.9
    over = (torch.rand(L, C, C, generator=g) < 4.0 / C) & torch.ones(C, C, dtype=torch.bool).triu(1)
    if kind == "nothing_suppressed":
        over[:] = False
    elif kind == "row0_suppresses_all":
        over[:] = False
        over[:, 0, 1:] = True
        valid[:, 0] = True
    elif kind == "all_invalid":
        valid[:] = False
    return over & valid[:, None, :], valid  # K2 sets no bit for an invalid column


@pytest.mark.cuda
@pytest.mark.parametrize("post", [1, 100, "C"])
@pytest.mark.parametrize("kind", ["random", "nothing_suppressed", "row0_suppresses_all", "all_invalid"])
@pytest.mark.parametrize("L,C", [(1, 64), (1, 128), (24, 512), (3, 2112), (2, 4096)])
def test_greedy_kernel_matches_plain(cuda_device, L, C, kind, post):
    post = C if post == "C" else min(post, C)
    over, valid = _k3_mask(kind, L, C)
    over, valid = over.to(cuda_device), valid.to(cuda_device)
    words = nms.pack_mask_bits(over)
    idx, keep = nms.nms_greedy_select_cuda(words, valid, post)
    ref_idx, ref_keep = nms.greedy_select_plain(over, valid, post)
    assert torch.equal(idx, ref_idx) and torch.equal(keep, ref_keep)
    idx2, keep2 = nms.nms_greedy_select_cuda(words, valid, post)
    assert torch.equal(idx, idx2) and torch.equal(keep, keep2)


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


def _k4_case(device, n_in, n_out, K, cin, cout, seed):
    """bf16 inputs of K4 from numpy: half the map's entries -1, every 7th
    row's first tap at input n_in - 1; with more than three tiles of rows,
    tile 1 has no active tap and tile 2 only its last tap."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n_in, (n_out, K)).astype(np.int32)
    nbr[rng.random((n_out, K)) < 0.5] = -1
    nbr[::7, 0] = n_in - 1
    T = sparse_conv.K4_TILE_ROWS
    if n_out > 3 * T:
        nbr[T:2 * T] = -1
        nbr[2 * T:3 * T, :-1] = -1
    feats = rng.standard_normal((n_in, cin))
    w = rng.standard_normal((K, cin, cout)) * (1.0 / (K * cin)) ** 0.5
    bias = rng.standard_normal(cout)
    to = lambda a: torch.from_numpy(a).to(device, torch.bfloat16)
    return to(feats), torch.from_numpy(nbr).to(device), to(w), to(bias)


def _k4_bf16_check(role, feats, nbr, w, bias):
    """K4 in bf16 as the forward (feats, w [K, cin, cout], bias) or as the
    input gradient (g = feats, the conv's weight w.transpose(1, 2), no bias)
    against its plain version; returns the kernel's result."""
    from unidistill_torch.kernels import build
    name = "sparse_conv_fwd" if role == "fwd" else "sparse_conv_dgrad"
    before = build.LAUNCHES[name]
    if role == "fwd":
        got, ref = sparse_conv.sparse_conv_cuda(feats, nbr, w, bias), sparse_conv.sparse_conv_plain(feats, nbr, w, bias)
    else:
        wc = w.transpose(1, 2).contiguous()  # the conv's [K, Cin, Cout] weight, read untransposed
        got, ref = sparse_conv.sparse_conv_dgrad_cuda(feats, nbr, wc), sparse_conv.sparse_conv_dgrad_plain(feats, nbr, wc)
    assert build.LAUNCHES[name] == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and got.shape == ref.shape
    torch.testing.assert_close(got.float(), ref.float(), rtol=1e-2, atol=1e-5)
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("role,K,cin,cout", [("fwd", *c) for c in ENCODER_CONVS]
                         + [("dgrad", K, cout, cin) for K, cin, cout in ENCODER_CONVS[1:]])
def test_sparse_conv_bf16_kernel_at_encoder_shapes(cuda_device, role, K, cin, cout):
    """K4's tensor-core instance at every forward shape of the encoder and
    every input-gradient shape (the kernel's Cin is the conv's Cout; the
    weight is read as Wᵀ in place), 1000 rows (not a whole number of tiles):
    tile 1 (no active tap) is the bias alone, tile 2 has one active tap."""
    feats, nbr, w, bias = _k4_case(cuda_device, 1500, 1000, K, cin, cout, seed=K + cin + cout)
    got = _k4_bf16_check(role, feats, nbr, w, bias if role == "fwd" else None)
    T = sparse_conv.K4_TILE_ROWS
    expect = bias.float().expand(T, cout) if role == "fwd" else torch.zeros(T, cout, device=cuda_device)
    assert torch.equal(got[T:2 * T].float(), expect.to(torch.bfloat16).float())


@pytest.mark.cuda
@pytest.mark.parametrize("role", ["fwd", "dgrad"])
def test_sparse_conv_bf16_kernel_with_fewer_inputs_than_a_tile(cuda_device, role):
    """50 input rows (fewer than one tile), 300 output rows, neighbours up to
    the last input row."""
    feats, nbr, w, bias = _k4_case(cuda_device, 50, 300, 27, 32, 16, seed=9)
    assert int(nbr.max()) == 49
    _k4_bf16_check(role, feats, nbr, w, bias if role == "fwd" else None)


@pytest.mark.cuda
@pytest.mark.parametrize("role,cin,cout", [("fwd", 128, 128), ("dgrad", 64, 32), ("fwd", 16, 16)])
def test_sparse_conv_bf16_kernel_is_deterministic(cuda_device, role, cin, cout):
    """Two runs over 20 000 rows are bit-equal (each row owned by one block,
    taps in a fixed order)."""
    feats, nbr, w, bias = _k4_case(cuda_device, 20000, 20000, 27, cin, cout, seed=cin * cout)
    bias = bias if role == "fwd" else None
    a = _k4_bf16_check(role, feats, nbr, w, bias)
    b = _k4_bf16_check(role, feats, nbr, w, bias)
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))


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
    """Two K6 runs over 300 000 rows (many chunks per tap) are bit-equal."""
    feats, nbr, _, _ = _sparse_inputs(cuda_device, torch.bfloat16, 320000, 300000, 27, 16, 16, seed=5)
    g = torch.randn(300000, 16, generator=torch.Generator().manual_seed(6)).to(cuda_device, torch.bfloat16)
    a = sparse_conv.sparse_conv_wgrad_cuda(feats, g, nbr)
    b = sparse_conv.sparse_conv_wgrad_cuda(feats, g, nbr)
    assert torch.equal(a, b)
    ref = sparse_conv.sparse_conv_wgrad_plain(feats, g, nbr)
    torch.testing.assert_close(a, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())


def _k6_case(device, n_in, n_out, K, cin, cout, seed):
    """bf16 inputs of K6 from numpy: half the map's entries -1, every 7th
    row's first tap at input n_in - 1, tap 1 -1 everywhere; with more than
    three tiles of rows, tile 1 has no neighbour at any tap and tile 2 one
    active row (5)."""
    rng = np.random.default_rng(seed)
    nbr = rng.integers(0, n_in, (n_out, K)).astype(np.int32)
    nbr[rng.random((n_out, K)) < 0.5] = -1
    nbr[::7, 0] = n_in - 1
    T = sparse_conv.k6_tile_rows(cin + -cin % 16, cout)
    if n_out > 3 * T:
        nbr[T:3 * T] = -1
        nbr[2 * T + 5] = rng.integers(0, n_in, K)
    nbr[:, 1] = -1
    to = lambda a: torch.from_numpy(a).to(device, torch.bfloat16)
    return to(rng.standard_normal((n_in, cin))), to(rng.standard_normal((n_out, cout))), torch.from_numpy(nbr).to(device)


def _k6_bf16_check(feats, g, nbr):
    """K6's bf16 instance against its plain version at K6's tolerance;
    returns the kernel's result."""
    from unidistill_torch.kernels import build
    before = build.LAUNCHES["sparse_conv_wgrad"]
    got = sparse_conv.sparse_conv_wgrad_cuda(feats, g, nbr)
    assert build.LAUNCHES["sparse_conv_wgrad"] == before + 1
    ref = sparse_conv.sparse_conv_wgrad_plain(feats, g, nbr)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-4 * ref.abs().max().item())
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("K,cin,cout", ENCODER_CONVS)
def test_sparse_conv_wgrad_bf16_kernel_at_encoder_shapes(cuda_device, K, cin, cout):
    """K6's tensor-core instance at every conv shape of the encoder (conv_input's
    Cin 5 padded to 16, conv_out's K = 3), 1000 rows (not a whole number of
    tiles): a tap that is -1 everywhere gives an exact 0, and the tile with
    one active row, alone in the map, gives that row's outer products
    exactly (one exact bf16 product per sum)."""
    feats, g, nbr = _k6_case(cuda_device, 1500, 1000, K, cin, cout, seed=K + cin + cout)
    got = _k6_bf16_check(feats, g, nbr)
    assert (got[1] == 0).all()
    T = sparse_conv.k6_tile_rows(cin + -cin % 16, cout)
    one = torch.full_like(nbr, -1)
    one[2 * T + 5] = nbr[2 * T + 5]
    assert torch.equal(sparse_conv.sparse_conv_wgrad_cuda(feats, g, one), sparse_conv.sparse_conv_wgrad_plain(feats, g, one))


@pytest.mark.cuda
def test_sparse_conv_wgrad_bf16_kernel_with_fewer_inputs_than_a_tile(cuda_device):
    """50 input rows (fewer than one tile), 300 output rows, neighbours up to
    the last input row."""
    feats, g, nbr = _k6_case(cuda_device, 50, 300, 27, 32, 16, seed=9)
    assert int(nbr.max()) == 49
    _k6_bf16_check(feats, g, nbr)


@pytest.mark.cuda
@pytest.mark.parametrize("cin,cout", [(16, 16), (128, 128)])
def test_sparse_conv_wgrad_bf16_kernel_is_deterministic(cuda_device, cin, cout):
    """Two runs over 300 000 rows (many chunks per tap, added in chunk order)
    are bit-equal."""
    feats, g, nbr = _k6_case(cuda_device, 320000, 300000, 27, cin, cout, seed=cin + cout)
    a = _k6_bf16_check(feats, g, nbr)
    b = _k6_bf16_check(feats, g, nbr)
    assert torch.equal(a, b)


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


# ---- the microbenchmark kernels: K7-K11 ------------------------------------


def _fused_case(device, B, S, C, co4, general, seed):
    """Cases 0-3 at random; with `general`, one row in eight with a one-hot
    that is not a single 1.0: random multipliers, two 1.0s, or -0.0 beside
    a 1.0 (still a copy)."""
    rng = np.random.default_rng(seed)
    g = torch.from_numpy(rng.standard_normal((B, 8, S, 10 * C)) * 0.1).to(torch.bfloat16)
    case = rng.integers(0, 4, (B, 8, S))  # case 3: an all-zero window
    oh = (case[..., None] == np.arange(4)).astype(np.float32)
    if general:
        pick = rng.random((B, 8, S)) < 0.125
        kind = rng.integers(0, 3, (B, 8, S))
        oh[pick & (kind == 0)] = rng.standard_normal((int((pick & (kind == 0)).sum()), 4))
        oh[pick & (kind == 1)] = [1, 1, 0, 0]
        oh[pick & (kind == 2)] = [-0.0, 0, 1, 0]
    W8 = torch.from_numpy(rng.standard_normal((8, 6 * C, co4)) * 0.05).to(torch.bfloat16)
    return [t.to(device) for t in (g, torch.from_numpy(oh).to(torch.bfloat16), W8)]


@pytest.mark.cuda
@pytest.mark.parametrize("B,S,C,co4,general", [
    (1, 512, 16, 64, False), (2, 1024, 32, 128, False), (2, 1000, 64, 256, False),
    (3, 1000, 32, 128, True), (3, 300, 16, 64, True), (1, 777, 64, 256, True),
    (2, 333, 48, 128, True), (1, 200, 16, 256, False), (1, 129, 96, 64, False)],
    ids=["C16", "C32", "C64_ragged", "B3_C32_general", "B3_C16_general", "C64_general", "C48_k96",
         "C16_n256", "C96_n64"])
def test_fused_offsets_kernel_matches_plain(cuda_device, B, S, C, co4, general):
    """K7 against its plain version, each output in a block just filled with
    NaN (sites of the ragged last tile left unwritten would stay NaN),
    launched once a call, bit-identical on a rerun."""
    from unidistill_torch.experiments.harness import poisoned_call
    from unidistill_torch.kernels import build
    g, oh, W8 = _fused_case(cuda_device, B, S, C, co4, general, seed=S + C)
    nbytes = B * S * co4 * 4
    before = build.LAUNCHES["fused_offsets"]
    got = poisoned_call(lambda: fused_offsets.fused_offsets(g, oh, W8), nbytes)
    assert build.LAUNCHES["fused_offsets"] == before + 1
    ref = fused_offsets.fused_offsets_plain(g, oh, W8)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    torch.testing.assert_close(got, ref, rtol=0, atol=1e-5 * ref.abs().max().item())
    assert torch.equal(poisoned_call(lambda: fused_offsets.fused_offsets(g, oh, W8), nbytes), got)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 8, 9, 1001, 256 * 256, 2**20 + 3])
def test_axpy2_kernel_is_bit_exact(cuda_device, n):
    """K8 on aligned operands and on views 2 bytes off the 16-byte grid,
    each output in a block just filled with NaN (values K8 left unwritten
    would stay NaN), launched once a call."""
    from unidistill_torch.experiments.harness import poisoned_call
    from unidistill_torch.kernels import build
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.standard_normal(n + 1) * 4).to(torch.bfloat16).to(cuda_device)
    y = torch.from_numpy(rng.standard_normal(n + 1) * 2.0 ** rng.integers(-20, 20, n + 1)).to(
        torch.bfloat16).to(cuda_device)
    for a, b in ((x[:n], y[:n]), (x[1:], y[1:])):  # aligned, and views off the 16-byte grid
        before = build.LAUNCHES["axpy2_bf16"]
        got = poisoned_call(lambda: fused_offsets.axpy2(a, b), 2 * n)
        assert build.LAUNCHES["axpy2_bf16"] == before + 1
        assert torch.equal(got.view(torch.int16), fused_offsets.smoke_plain(a, b).view(torch.int16))
    assert fused_offsets.smoke(cuda_device) == 5.0


def _band_case(device, S, W, R, band, n_tab, seed, dtype=torch.bfloat16):
    """Indices anywhere in the table (many outside their block's band) and
    band starts within the contract, for ragged S too."""
    rng = np.random.default_rng(seed)
    nblk = -(-S // R)
    w = rng.integers(0, n_tab - band + 1, nblk).astype(np.int32)
    idx = rng.integers(0, n_tab, S).astype(np.int32)
    near = rng.random(S) < 0.7  # most indices inside the band
    idx[near] = (w.repeat(R)[:S] + rng.integers(0, band, S))[near]
    tab = torch.from_numpy(rng.standard_normal((n_tab, W)) * 0.1).to(dtype)
    return tab.to(device), torch.from_numpy(idx).to(device), torch.from_numpy(w).to(device)


BAND_CASES = [(2048, 128, 256, 512, 2048), (1024, 64, 128, 256, 1024), (1000, 200, 256, 512, 1500)]


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fori", "fori4", "take", "onehot"])
@pytest.mark.parametrize("S,W,R,band,n_tab", BAND_CASES, ids=["S2048", "S1024", "ragged"])
def test_band_gather_kernels_are_bit_exact(cuda_device, variant, S, W, R, band, n_tab):
    from unidistill_torch.kernels import build
    tab, idx, w = _band_case(cuda_device, S, W, R, band, n_tab, seed=S + W)
    fn = {"fori": lambda *a: band_gather.band_gather_fori(*a, unroll=1),
          "fori4": lambda *a: band_gather.band_gather_fori(*a, unroll=4),
          "take": band_gather.band_gather_take, "onehot": band_gather.band_gather_onehot}[variant]
    counter = {"fori": "band_gather_fori", "fori4": "band_gather_fori4", "take": "band_gather_take",
               "onehot": "band_gather_onehot"}[variant]
    before = build.LAUNCHES[counter]
    got = fn(tab, idx, w, R, band)
    assert build.LAUNCHES[counter] == before + 1
    ref = band_gather.band_gather_plain(tab, idx, w, R, band)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    assert torch.equal(fn(tab, idx, w, R, band), got)


def _outside_band_case(device, S, W, R, band, n_tab, seed):
    """Every index outside its block's band, below or above it."""
    tab, _, w = _band_case(device, S, W, R, band, n_tab, seed)
    rng = np.random.default_rng(seed + 1)
    lo = w.cpu().numpy().repeat(R)[:S]
    below = rng.random(S) < 0.5
    idx = np.where(below, lo - 1 - rng.integers(0, 1000, S), lo + band + rng.integers(0, 1000, S))
    return tab, torch.from_numpy(idx.astype(np.int32)).to(device), w


# K10's tile holds 1024 pieces (12 rows at W 640): R not a multiple of it,
# rows of 79 pieces (W 632), S under one tile, rows of more pieces than a
# tile (W 20000: 2500), every index outside its band
TAKE_CASES = {"R37_W640": (1000, 640, 37, 256, 1500), "W632": (2000, 632, 256, 512, 3000),
              "S7": (7, 640, 4, 16, 64), "W20000": (50, 20000, 16, 32, 100),
              "outside_band": (1000, 640, 100, 256, 2000)}


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["fori", "fori4", "take"])
@pytest.mark.parametrize("case", list(TAKE_CASES))
def test_band_gather_copies_on_tile_edges(cuda_device, case, variant):
    """K9 and K10 equal to the plain gather bit for bit, each output in a
    block just filled with NaN, and to themselves on a rerun."""
    from unidistill_torch.experiments.harness import poisoned_call
    S, W, R, band, n_tab = TAKE_CASES[case]
    make = _outside_band_case if case == "outside_band" else _band_case
    tab, idx, w = make(cuda_device, S, W, R, band, n_tab, seed=S + W)
    fn = {"fori": lambda: band_gather.band_gather_fori(tab, idx, w, R, band, unroll=1),
          "fori4": lambda: band_gather.band_gather_fori(tab, idx, w, R, band, unroll=4),
          "take": lambda: band_gather.band_gather_take(tab, idx, w, R, band)}[variant]
    ref = band_gather.band_gather_plain(tab, idx, w, R, band)
    got = poisoned_call(fn, ref.numel() * ref.element_size())
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    assert torch.equal(poisoned_call(fn, ref.numel() * ref.element_size()).view(torch.int16), got.view(torch.int16))


@pytest.mark.cuda
def test_band_gather_copies_past_2_gb_of_table(cuda_device):
    """A table of 1 750 000 rows of 1280 bytes (2.24 GB): rows past 2^31
    bytes need 64-bit row offsets in K9 and K10."""
    from unidistill_torch.experiments.harness import poisoned_call
    n_tab, W, S, R, band = 1_750_000, 640, 4096, 1024, 4096
    assert n_tab * W * 2 > 2**31
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    tab = torch.randint(-2**15, 2**15, (n_tab, W), dtype=torch.int16, device=cuda_device, generator=gen)
    tab = tab.view(torch.bfloat16)
    rng = np.random.default_rng(3)
    w = (n_tab - band - rng.integers(0, 50_000, S // R)).astype(np.int32)
    idx = (w.repeat(R) + rng.integers(-500, band + 500, S)).clip(0, n_tab - 1).astype(np.int32)
    w, idx = torch.from_numpy(w).to(cuda_device), torch.from_numpy(idx).to(cuda_device)
    ref = band_gather.band_gather_plain(tab, idx, w, R, band)
    assert int(band_gather.band_source_rows(idx, w, R, band).min()) * W * 2 > 2**31
    for fn in (lambda: band_gather.band_gather_fori(tab, idx, w, R, band, unroll=1),
               lambda: band_gather.band_gather_fori(tab, idx, w, R, band, unroll=4),
               lambda: band_gather.band_gather_take(tab, idx, w, R, band)):
        got = poisoned_call(fn, ref.numel() * ref.element_size())
        assert torch.equal(got.view(torch.int16), ref.view(torch.int16))


# K11 on layouts that stress its ordering by slab (`mb_gather_pallas.band_layout`),
# small and at the published size (S 65536, W 640, R 2048, band 4096; R 128
# for "uniform", so that band >> R); "uniform" with a band of 300032 rows
# takes ten windows of the sort (2048 slabs a window)
K11_LAYOUTS = [
    ("one_position", 1000, 64, 128, 256), ("edges", 1000, 64, 128, 256), ("uniform", 1024, 32, 128, 1024),
    ("ragged", 1000, 200, 256, 512), ("uniform", 512, 8, 256, 300032),
    ("published", 65536, 640, 2048, 4096), ("one_position", 65536, 640, 2048, 4096),
    ("edges", 65536, 640, 2048, 4096), ("uniform", 65536, 640, 128, 4096), ("ragged", 64531, 632, 2048, 4096),
]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,S,W,R,band", K11_LAYOUTS,
                         ids=[f"{k}-S{s}-W{w}-R{r}-band{b}" for k, s, w, r, b in K11_LAYOUTS])
def test_band_gather_onehot_on_layouts(cuda_device, kind, S, W, R, band):
    """K11 equal to the plain gather bit for bit, and to itself on a rerun."""
    from unidistill_torch.experiments.mb_gather_pallas import band_layout
    tab, idx, w = band_layout(kind, S, W, R, band, seed=S + band, device=cuda_device)
    got = band_gather.band_gather_onehot(tab, idx, w, R, band)
    ref = band_gather.band_gather_plain(tab, idx, w, R, band)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    assert torch.equal(band_gather.band_gather_onehot(tab, idx, w, R, band).view(torch.int16), got.view(torch.int16))


@pytest.mark.cuda
def test_band_gather_onehot_on_random_indices_at_the_published_size(cuda_device):
    """`_band_case`'s indices (30% anywhere in the table) at S 65536, W 640,
    R 2048, band 4096: equal to the plain gather, reruns bit-identical."""
    tab, idx, w = _band_case(cuda_device, 65536, 640, 2048, 4096, 70000, seed=13)
    got = band_gather.band_gather_onehot(tab, idx, w, 2048, 4096)
    ref = band_gather.band_gather_plain(tab, idx, w, 2048, 4096)
    torch.cuda.synchronize()
    assert torch.equal(got.view(torch.int16), ref.view(torch.int16))
    assert torch.equal(band_gather.band_gather_onehot(tab, idx, w, 2048, 4096).view(torch.int16),
                       got.view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,W", [(torch.float32, 4), (torch.bfloat16, 8), (torch.bfloat16, 37)])
def test_band_gather_copies_16_byte_rows_and_rejects_others(cuda_device, dtype, W):
    """K9 and K10 move rows as 16-byte pieces; other rows raise."""
    tab, idx, w = _band_case(cuda_device, 700, W, 128, 256, 900, seed=W, dtype=dtype)
    fns = [lambda *a: band_gather.band_gather_fori(*a, unroll=1),
           lambda *a: band_gather.band_gather_fori(*a, unroll=4), band_gather.band_gather_take]
    if W * tab.element_size() % 16:
        for fn in fns:
            with pytest.raises(ValueError, match="16"):
                fn(tab, idx, w, 128, 256)
        return
    ref = band_gather.band_gather_plain(tab, idx, w, 128, 256)
    for fn in fns:
        assert torch.equal(fn(tab, idx, w, 128, 256), ref)


@pytest.mark.cuda
def test_fused_subm_on_the_card(cuda_device):
    """The fused conv (K7) against the separate path on the card, tiny
    realistic inputs: within the bf16 roundings the separate path adds."""
    from unidistill_torch.configs.nuscenes import tiny_model
    from unidistill_torch.experiments.realistic import realistic_inputs
    from unidistill_torch.ops.sparse_conv_chunked import _subm_impl
    for x in realistic_inputs(tiny_model(with_camera=False), batch=2, device=cuda_device)[0].values():
        got = fused_offsets.fused_subm(x.feats, x.occ_bits, x.colkey, x.chunk, x.valid, x.weight,
                                       x.tables, x.C, x.C)
        ref = _subm_impl(x.feats, x.occ_bits, x.colkey, x.chunk, x.valid, x.weight, None, x.tables,
                         "bfloat16")
        torch.testing.assert_close(got.float(), ref.float(), rtol=0, atol=2e-2 * ref.float().abs().max().item())


def _voxelize_args(cfg):
    caps = cfg.caps
    return (cfg.point_cloud_range, cfg.voxel_size, cfg.grid_size, caps.max_voxels_eval,
            caps.max_points_per_voxel)


@pytest.mark.cuda
def test_voxelize_is_bit_identical_on_reruns(cuda_device):
    """The voxeliser's mean VFE on four full-size 10-sweep clouds at the
    eval cap: two calls on the card give the same bits."""
    from unidistill_torch.configs.nuscenes import lidar_exp
    from unidistill_torch.ops.voxelize import voxelize
    from unidistill_torch.serving.synthetic import lidar_batch
    cfg = lidar_exp().model
    b = lidar_batch(cfg, 4, seed=11)
    pts, mask = torch.from_numpy(b["points"]).to(cuda_device), torch.from_numpy(b["points_mask"]).to(cuda_device)
    f1, c1 = voxelize(pts, mask, *_voxelize_args(cfg))
    f2, c2 = voxelize(pts, mask, *_voxelize_args(cfg))
    assert (c1[..., 0] >= 0).sum() > 200_000
    assert torch.equal(c1, c2)
    n_diff = int((f1 != f2).any(-1).sum().item())
    assert n_diff == 0, f"{n_diff} voxel features differ between two runs"


@pytest.mark.cuda
def test_voxelize_on_the_card_equals_the_cpu(cuda_device):
    """The tiny LiDAR model's voxels: the card sums each voxel's points in
    the CPU's order, so coords and features are equal bit for bit."""
    from unidistill_torch.configs.nuscenes import tiny_model
    from unidistill_torch.ops.voxelize import voxelize
    from unidistill_torch.serving.synthetic import lidar_batch
    cfg = tiny_model(with_camera=False)
    b = lidar_batch(cfg, 2, seed=13)
    pts, mask = torch.from_numpy(b["points"]), torch.from_numpy(b["points_mask"])
    fc, cc = voxelize(pts, mask, *_voxelize_args(cfg))
    fg, cg = voxelize(pts.to(cuda_device), mask.to(cuda_device), *_voxelize_args(cfg))
    assert (cc[..., 0] >= 0).sum() > 1000
    assert torch.equal(cg.cpu(), cc)
    n_diff = int((fg.cpu() != fc).any(-1).sum().item())
    assert n_diff == 0, f"{n_diff} voxel features differ between the card and the CPU"
