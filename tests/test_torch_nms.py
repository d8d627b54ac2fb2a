"""The port's rotated IoU and NMS (kernels K2/K3's plain versions) against
the JAX package.

IoU: the port's `rotated_iou_bev` on CPU tensors against JAX
`rotated_iou_bev_pallas(..., interpret=True)`, `rotated_iou_upper_blocked`
and the XLA `rotated_iou_bev`, at rtol 1e-4, atol 1e-5 (float32; XLA fuses
and orders the same clip arithmetic differently), as tests/test_nms.py
holds the Pallas tile against XLA.

NMS: keep indices must be equal to JAX `nms_bev_batched` and `nms_bev`.
Every case is checked to keep all pairwise IoUs at least 1e-4 away from
the threshold, so that round-off cannot flip a suppression.

K2's pair filter (`pairs_to_clip_plain`): on spread, clustered, coincident,
touching, mixed-size and 1 mm boxes, every pair it rejects has plain IoU exactly
0, so the mask restricted to the clipped pairs equals the whole mask bit for
bit. At thr < 0 it clips every candidate pair. Touching boxes far from the
origin get IoUs far from their overlap (the reference's clip leaves their
shoelace chain open), which is why the filter has no area bound.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidistill_tpu.ops import nms as jnms

from unidistill_torch.ops import nms as port
from unidistill_torch.serving.synthetic import nms_lanes

RTOL, ATOL = 1e-4, 1e-5
MARGIN = 1e-4


def _rand_boxes(rng, shape, spread=20.0):
    return np.stack(
        [rng.uniform(-spread, spread, shape), rng.uniform(-spread, spread, shape),
         rng.uniform(1, 5, shape), rng.uniform(1, 5, shape),
         rng.uniform(-np.pi, np.pi, shape)], -1).astype(np.float32)


def _special_boxes():
    """Identical, touching (shared edge), nested, 45°-rotated and far boxes."""
    return np.array([
        [0.0, 0.0, 2.0, 2.0, 0.0],
        [0.0, 0.0, 2.0, 2.0, 0.0],          # identical
        [2.0, 0.0, 2.0, 2.0, 0.0],          # touches box 0 along x = 1
        [0.0, 0.0, 1.0, 1.0, 0.0],          # inside box 0
        [0.0, 0.0, 2.0, 4.0, np.pi / 4],    # rotated over box 0
        [0.0, 0.0, 2.0, 4.0, np.pi / 4],    # identical rotated
        [0.5, 0.0, 2.0, 2.0, np.pi / 2],    # quarter turn, shifted
        [30.0, 30.0, 3.0, 1.5, 1.0],        # far away
    ], np.float32)


def _port_iou(a, b):
    return port.rotated_iou_bev(torch.from_numpy(a), torch.from_numpy(b)).numpy()


def test_iou_special_cases():
    a = _special_boxes()
    got = _port_iou(a, a)
    np.testing.assert_allclose(np.diag(got), 1.0, atol=1e-5)
    np.testing.assert_allclose(got[0, 1], 1.0, atol=1e-5)
    # touching along x = 1: the JAX clip counts the first box's edge lying on
    # the second box's boundary (exclude_boundary covers the second box's
    # edges only), so iou(0, 2) = 1/7 while iou(2, 0) = 0; the port keeps it
    np.testing.assert_allclose(got[0, 2], 1.0 / 7.0, atol=1e-6)
    assert got[2, 0] == 0.0
    np.testing.assert_allclose(got[0, 3], 0.25, atol=1e-5)  # nested
    np.testing.assert_allclose(got[4, 5], 1.0, atol=1e-4)
    assert got[0, 7] == 0.0
    ref = np.asarray(jnms.rotated_iou_bev(jnp.asarray(a), jnp.asarray(a)))
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("seed", [11, 12])
def test_iou_matches_pallas_interpret(seed):
    rng = np.random.RandomState(seed)
    L, M, N = 2, 70, 45
    a = _rand_boxes(rng, (L, M), spread=8.0)
    b = _rand_boxes(rng, (L, N), spread=8.0)
    ref = np.asarray(jnms.rotated_iou_bev_pallas(jnp.asarray(a), jnp.asarray(b),
                                                 block=64, interpret=True))
    got = _port_iou(a, b)
    assert got.shape == (L, M, N)
    np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL)
    assert (ref > 0.05).sum() > 20  # overlaps are exercised
    # unbatched form
    np.testing.assert_allclose(_port_iou(a[0], b[0]), ref[0], rtol=RTOL, atol=ATOL)


def test_iou_matches_upper_blocked():
    rng = np.random.RandomState(5)
    L, C = 3, 128
    a = _rand_boxes(rng, (L, C), spread=10.0)
    ref = np.asarray(jnms.rotated_iou_upper_blocked(jnp.asarray(a)))
    got = _port_iou(a, a)
    tri = np.triu(np.ones((C, C), bool), 1)
    # atol 1e-4 here: the blocked XLA form precomputes each plane's offset
    # n·a and subtracts n·p0 from it, a different rounding of the same num
    np.testing.assert_allclose(np.where(tri, got, 0.0), ref, rtol=RTOL, atol=1e-4)
    full = np.asarray(jax.vmap(jnms.rotated_iou_bev)(jnp.asarray(a), jnp.asarray(a)))
    np.testing.assert_allclose(got, full, rtol=RTOL, atol=ATOL)


def test_mask_bits_roundtrip():
    rng = np.random.RandomState(0)
    over = torch.from_numpy(rng.rand(2, 128, 128) > 0.7)
    words = port.pack_mask_bits(over)
    assert words.shape == (2, 128, 2) and words.dtype == torch.int64
    assert torch.equal(port.unpack_mask_bits(words), over)
    # bit 63 lands in the sign bit
    one = torch.zeros(1, 64, 64, dtype=torch.bool)
    one[0, 0, 63] = True
    assert port.pack_mask_bits(one)[0, 0, 0].item() == -(2 ** 63)


def _nms_lanes(seed, L, K, n_invalid, thr):
    """Score-sorted lanes with clusters of near-duplicates; returns boxes7,
    valid, after checking every pair is MARGIN away from thr."""
    rng = np.random.RandomState(seed)
    boxes7 = np.zeros((L, K, 7), np.float32)
    centers = rng.uniform(-15, 15, (L, K // 4, 2))
    pick = rng.randint(0, K // 4, (L, K))
    boxes7[..., 0:2] = np.take_along_axis(centers, pick[..., None], 1) + rng.normal(0, 0.6, (L, K, 2))
    boxes7[..., 2] = rng.uniform(-1, 1, (L, K))
    boxes7[..., 3:5] = rng.uniform(1.5, 4, (L, K, 2))
    boxes7[..., 5] = rng.uniform(1, 2, (L, K))
    boxes7[..., 6] = rng.uniform(-np.pi, np.pi, (L, K))
    boxes7[:, 1] = boxes7[:, 0]  # an identical pair in every lane
    valid = np.ones((L, K), bool)
    valid[:, K - n_invalid:] = False
    bev = boxes7[..., [0, 1, 3, 4, 6]]
    iou = np.asarray(jax.vmap(jnms.rotated_iou_bev)(jnp.asarray(bev), jnp.asarray(bev)))
    assert np.abs(iou - thr).min() > MARGIN, "case too close to the threshold"
    return boxes7, valid


def _clustered_lanes(seed, L, K, thr):
    """`nms_lanes("clustered")` as 7-dof boxes, checked as `_nms_lanes`."""
    bev, valid = nms_lanes("clustered", seed, L, K)
    boxes7 = np.zeros((L, K, 7), np.float32)
    boxes7[..., [0, 1, 3, 4, 6]] = bev
    boxes7[..., 5] = 1.6
    iou = np.asarray(jax.vmap(jnms.rotated_iou_bev)(jnp.asarray(bev), jnp.asarray(bev)))
    assert np.abs(iou - thr).min() > MARGIN, "case too close to the threshold"
    return boxes7, valid


@pytest.mark.parametrize("seed,L,K,cap,post,thr", [
    (0, 3, 128, 512, 40, 0.2),   # C = 128
    (1, 2, 100, 512, 30, 0.1),   # C = 100 padded to 128
    (5, 4, 200, 64, 20, 0.3),    # cap binds: C = 64
    (0, 4, 512, 512, 100, 0.1),  # the clustered layout: 40 cars x 12 candidates
])
def test_nms_batched_matches_jax(seed, L, K, cap, post, thr):
    if K == 512:
        boxes7, valid = _clustered_lanes(seed, L, K, thr)
    else:
        boxes7, valid = _nms_lanes(seed, L, K, 7, thr)
    ref_idx, ref_mask = map(np.asarray, jnms.nms_bev_batched(
        jnp.asarray(boxes7), jnp.asarray(valid), thr, post, cap=cap))
    idx, mask = port.nms_bev_batched(torch.from_numpy(boxes7), torch.from_numpy(valid), thr, post, cap=cap)
    assert idx.dtype == torch.int32 and mask.dtype == torch.bool
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    assert 0 < ref_mask.sum() < ref_mask.size or ref_mask.all()
    assert (ref_mask.sum(1) < min(cap, K) - 7).all()  # suppression happened


@pytest.mark.parametrize("thr", [0.1, 0.5])
def test_nms_special_cases_match_jax(thr):
    """Identical, touching, nested and rotated boxes in two score orders."""
    bev = _special_boxes()
    boxes7 = np.zeros((2, len(bev), 7), np.float32)
    boxes7[0][:, [0, 1, 3, 4, 6]] = bev
    boxes7[1][:, [0, 1, 3, 4, 6]] = bev[::-1]
    valid = np.ones((2, len(bev)), bool)
    iou = np.asarray(jax.vmap(jnms.rotated_iou_bev)(jnp.asarray(boxes7[..., [0, 1, 3, 4, 6]]),
                                                  jnp.asarray(boxes7[..., [0, 1, 3, 4, 6]])))
    assert np.abs(iou - thr).min() > MARGIN
    ref_idx, ref_mask = map(np.asarray, jnms.nms_bev_batched(
        jnp.asarray(boxes7), jnp.asarray(valid), thr, 6))
    idx, mask = port.nms_bev_batched(torch.from_numpy(boxes7), torch.from_numpy(valid), thr, 6)
    np.testing.assert_array_equal(mask.numpy(), ref_mask)
    np.testing.assert_array_equal(idx.numpy(), ref_idx)
    for lane in range(2):
        s_idx, s_mask = jnms.nms_bev(jnp.asarray(boxes7[lane]), jnp.zeros(len(bev)),
                                     jnp.asarray(valid[lane]), thr, 6)
        np.testing.assert_array_equal(mask.numpy()[lane], np.asarray(s_mask))
        np.testing.assert_array_equal(idx.numpy()[lane][mask.numpy()[lane]],
                                      np.asarray(s_idx)[np.asarray(s_mask)])


@pytest.mark.parametrize("seed,thr", [(3, 0.2), (4, 0.5)])
def test_nms_matches_serial_oracle(seed, thr):
    K, post = 96, 50
    boxes7, valid = _nms_lanes(seed, 1, K, 5, thr)
    scores = np.linspace(1.0, 0.1, K).astype(np.float32)
    ref_idx, ref_mask = map(np.asarray, jnms.nms_bev(
        jnp.asarray(boxes7[0]), jnp.asarray(scores), jnp.asarray(valid[0]), thr, post))
    ser_idx, ser_mask = port.nms_bev(torch.from_numpy(boxes7[0]), torch.from_numpy(scores),
                                     torch.from_numpy(valid[0]), thr, post)
    np.testing.assert_array_equal(ser_mask.numpy(), ref_mask)
    np.testing.assert_array_equal(ser_idx.numpy()[ser_mask.numpy()], ref_idx[ref_mask])
    b_idx, b_mask = port.nms_bev_batched(torch.from_numpy(boxes7), torch.from_numpy(valid), thr, post)
    np.testing.assert_array_equal(b_mask.numpy()[0], ref_mask)
    np.testing.assert_array_equal(b_idx.numpy()[0][b_mask.numpy()[0]], ref_idx[ref_mask])


def test_cuda_wrappers_reject_cpu_tensors():
    bev = torch.zeros(1, 64, 5)
    valid = torch.ones(1, 64, dtype=torch.bool)
    with pytest.raises(ValueError, match="CUDA"):
        port.rotated_iou_mask_cuda(bev, valid, 0.1)
    with pytest.raises(ValueError, match="CUDA"):
        port.nms_greedy_select_cuda(torch.zeros(1, 64, 1, dtype=torch.int64), valid, 10)
    with pytest.raises(ValueError, match="CUDA"):
        port.rotated_iou_cuda(bev, bev)


FILTER_LAYOUTS = ("spread", "clustered", "coincident", "touching", "mixed_sizes", "tiny")


def _filter_case(kind, seed=0):
    bev, valid = nms_lanes(kind, seed, L=2, C=128, objects=8, per_object=12)
    bev, valid = torch.from_numpy(bev), torch.from_numpy(valid)
    valid[:, -5:] = False
    C = bev.shape[1]
    cand = torch.triu(torch.ones(C, C, dtype=torch.bool), 1)[None] & valid[:, None, :]
    return bev, valid, cand


@pytest.mark.parametrize("thr", [0.0, 0.1, 0.8])
@pytest.mark.parametrize("layout", FILTER_LAYOUTS)
def test_pair_filter_rejects_only_pairs_without_a_bit(layout, thr):
    bev, valid, cand = _filter_case(layout)
    clip = port.pairs_to_clip_plain(bev, valid, thr)
    assert not (clip & ~cand).any()
    iou = port.rotated_iou_bev_plain(bev, bev)
    rejected = cand & ~clip
    assert clip.any()
    assert rejected.any() == (layout != "coincident")
    assert (iou[rejected] == 0).all(), iou[rejected & (iou != 0)]


@pytest.mark.parametrize("thr", [0.0, 0.1, 0.8])
def test_mask_over_the_clipped_pairs_is_exact(thr):
    for i, layout in enumerate(FILTER_LAYOUTS):
        bev, valid, _ = _filter_case(layout, seed=10 + i)
        over = port.iou_over_plain(bev, valid, thr)
        clip = port.pairs_to_clip_plain(bev, valid, thr)
        assert torch.equal(over & clip, over), layout
        assert torch.equal(port.pack_mask_bits(over & clip), port.pack_mask_bits(over))


def test_pair_filter_is_off_below_zero():
    """At thr < 0 a pair of boxes that cannot meet (IoU 0) has its bit set,
    so the filter must clip every candidate pair."""
    bev, valid, cand = _filter_case("spread")
    assert torch.equal(port.pairs_to_clip_plain(bev, valid, -0.1), cand)
    over = port.iou_over_plain(bev, valid, -0.1)
    assert torch.equal(over, cand)
    assert (cand & (port.rotated_iou_bev_plain(bev, bev) == 0)).any()
    assert not torch.equal(port.pairs_to_clip_plain(bev, valid, 0.0), cand)


def _untame_lane():
    """Boxes the filter cannot bound beside ordinary ones: 6 km out, a 0.1 mm
    side 60 m out, zero dims, NaN."""
    bev = torch.tensor([[0.0, 0.0, 2.0, 2.0, 0.3], [6000.0, 0.0, 4.0, 2.0, 0.0],
                        [6001.0, 0.5, 4.0, 2.0, 0.1], [60.0, 1.0, 1e-4, 3.0, 0.2],
                        [61.0, 1.0, 2.0, 2.0, 0.0], [0.5, 0.0, 0.0, 0.0, 0.0],
                        [float("nan"), 0.0, 2.0, 2.0, 0.0], [0.4, 0.2, 2.0, 2.0, 0.1]])
    return torch.cat([bev, bev[:1].repeat(56, 1) + torch.arange(56.0)[:, None] * torch.tensor(
        [3.0, 0.0, 0.0, 0.0, 0.0])])[None]


def test_pair_filter_clips_boxes_it_cannot_bound():
    bev = _untame_lane()
    valid = torch.ones(1, 64, dtype=torch.bool)
    clip = port.pairs_to_clip_plain(bev, valid, 0.1)
    for row in (1, 3, 5, 6):  # 6 km out, a 0.1 mm side, zero dims, NaN
        assert clip[0, row, row + 1:].all() and clip[0, :row, row].all()
    for thr in (0.0, 0.1):
        over = port.iou_over_plain(bev, valid, thr)
        assert torch.equal(over & port.pairs_to_clip_plain(bev, valid, thr), over)


def test_touching_boxes_far_out_break_an_area_bound():
    """Why K2 has no area bound: two boxes that share an edge 60 m out get a
    plain IoU far above min(a, b) / max(a, b), and the filter clips them."""
    bev = torch.tensor([[[60.0, 20.0, 2.0, 2.0, 0.0], [62.0, 20.0, 2.0, 4.0, 0.0]]])
    valid = torch.ones(1, 2, dtype=torch.bool)
    iou = port.rotated_iou_bev_plain(bev, bev)[0, 0, 1]
    assert iou > 1.0  # min / max is 0.5
    assert port.pairs_to_clip_plain(bev, valid, 0.1)[0, 0, 1]
    assert port.iou_over_plain(bev, valid, 0.1)[0, 0, 1]
