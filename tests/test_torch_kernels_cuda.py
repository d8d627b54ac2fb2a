"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda`: every test skips without an NVIDIA GPU. This file imports no
JAX, so it also runs where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py -m cuda

Tolerances: K1 rtol/atol 1e-5 (float32 atomics sum in another order); K2
float mode rtol 1e-4, atol 1e-5 (same float math, libm cos/sin may differ
by an ulp); K2 mask bits and K3 keep sets exactly (no IoU within 1e-4 of
the threshold in these inputs).
"""
import numpy as np
import pytest
import torch

from unidistill_torch.ops import bev_pool, nms

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
