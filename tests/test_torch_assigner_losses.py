"""The port's target assigner and training losses against the JAX package.

The same numpy inputs go through the JAX function and its counterpart in
`unidistill_torch` on the CPU in float32. Head maps are NCHW in the port and
NHWC in JAX; the tests permute. Tolerances:
  * assigner: `ind`, `mask`, `cat` and `heatmap` exactly (index arithmetic
    and comparisons of the same float32 values), `box_encoding` 1e-6;
  * each loss rtol 1e-5 (atol 1e-6), and the gradient of `center_head_loss`
    and of the distillation losses with respect to their inputs within 1e-5
    of the tensor's max |g|: the same float32 formulas summed in another
    order.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidistill_tpu.configs.nuscenes import AssignerConfig as JaxAssignerConfig
from unidistill_tpu.losses import det as jdet
from unidistill_tpu.losses import distill as jdist
from unidistill_tpu.ops import gaussian as jgauss
from unidistill_tpu.ops.grid_sample import grid_sample_2d as jax_grid_sample
from unidistill_tpu.targets.assigner import assign_targets as jax_assign

from unidistill_torch.configs.nuscenes import AssignerConfig, TASKS, tiny_model
from unidistill_torch.layers.center_head import branch_list
from unidistill_torch.losses import det as pdet
from unidistill_torch.losses import distill as pdist
from unidistill_torch.ops import gaussian as pgauss
from unidistill_torch.ops.grid_sample import grid_sample_2d
from unidistill_torch.targets.assigner import assign_targets

RTOL, ATOL = 1e-5, 1e-6
CFG = tiny_model(with_lidar=False)
# exact-arithmetic geometry: 1 m voxels, a 10×10 grid of 8 m cells
EXACT = dict(grid_size=(80, 80, 40), pc_range=(-40.0, -40.0, -5.0, 40.0, 40.0, 3.0),
             voxel_size=(1.0, 1.0, 0.2))
TINY = dict(grid_size=CFG.grid_size, pc_range=CFG.point_cloud_range, voxel_size=CFG.voxel_size)


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def nhwc(t):
    return t.detach().permute(0, 2, 3, 1).numpy()


def random_gt(rng, B, G, n_lo, n_hi, span=50.0, classes=range(1, 11)):
    gt = np.zeros((B, G, 10), np.float32)
    for b in range(B):
        n = rng.randint(n_lo, n_hi + 1)
        gt[b, :n, 0:2] = rng.uniform(-span, span, (n, 2))
        gt[b, :n, 2] = rng.uniform(-2, 1, n)
        gt[b, :n, 3:6] = rng.uniform(0.5, 6, (n, 3))
        gt[b, :n, 6] = rng.uniform(-6, 6, n)
        gt[b, :n, 7:9] = rng.uniform(-3, 3, (n, 2))
        gt[b, :n, 9] = rng.choice(list(classes), n)
    return gt


def _gt_case(name):
    rng = np.random.RandomState(0)
    if name == "random":
        return random_gt(rng, 3, 16, 3, 12), AssignerConfig(max_pos=128), TINY
    if name == "ties":  # centres on grid points and on cell midpoints: equal distances
        gt = random_gt(rng, 2, 12, 12, 12, classes=(1, 9))
        k = rng.randint(0, 10, (2, 12, 2)).astype(np.float32)
        half = rng.randint(0, 2, (2, 12, 2)).astype(np.float32)
        gt[..., 0:2] = -40.0 + 8.0 * k + 4.0 * half
        gt[0, 1, 0:2] = gt[0, 0, 0:2] + np.float32(8.0)  # two GTs 8 m apart: argmin ties too
        gt[0, 2, 0:2] = gt[0, 0, 0:2] + np.float32(4.0)
        return gt, AssignerConfig(max_pos=256), EXACT
    if name == "edges":  # at and past the grid's edges
        gt = random_gt(rng, 2, 8, 8, 8, classes=(1, 2, 9))
        gt[0, :, 0] = [-40.0, 39.99, -39.5, 38.0, 45.0, -47.0, 0.0, 39.0]
        gt[0, :, 1] = [-40.0, 39.99, 30.0, -39.9, 0.0, 12.0, 40.5, -45.0]
        gt[1, :, 0:2] = rng.uniform(-41, 41, (8, 2))
        return gt, AssignerConfig(max_pos=128), EXACT
    if name == "no_gt_tasks":  # only cars and pedestrians, and an empty sample
        gt = random_gt(rng, 3, 10, 2, 6, classes=(1, 9))
        gt[2] = 0.0
        return gt, AssignerConfig(max_pos=64), TINY
    if name == "over_cap":  # 16 cars, 9 positives each: more than max_pos
        gt = random_gt(rng, 2, 16, 16, 16, span=45.0, classes=(1,))
        return gt, AssignerConfig(max_pos=40), TINY
    raise KeyError(name)


@pytest.mark.parametrize("name", ["random", "ties", "edges", "no_gt_tasks", "over_cap"])
def test_assigner_matches_jax(name):
    gt, acfg, geo = _gt_case(name)
    jcfg = JaxAssignerConfig(**dataclasses.asdict(acfg))
    ref = jax_assign(jnp.asarray(gt), jcfg, TASKS, geo["grid_size"], geo["pc_range"], geo["voxel_size"])
    got = assign_targets(torch.from_numpy(gt), acfg, TASKS, geo["grid_size"], geo["pc_range"],
                         geo["voxel_size"])
    n_pos = 0
    for tid, (r, g) in enumerate(zip(ref, got)):
        for k in ("ind", "mask", "cat"):
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(r[k]), err_msg=f"task {tid} {k}")
        np.testing.assert_array_equal(nhwc(g["heatmap"]), np.asarray(r["heatmap"]), err_msg=f"task {tid}")
        np.testing.assert_allclose(g["box_encoding"].numpy(), np.asarray(r["box_encoding"]),
                                   rtol=1e-6, atol=1e-6, err_msg=f"task {tid}")
        n_pos += int(np.asarray(r["mask"]).sum())
    assert n_pos > 0
    if name == "over_cap":  # the cap binds: every slot of the car task is taken
        assert np.asarray(ref[0]["mask"]).all()
    if name == "no_gt_tasks":
        assert not np.asarray(ref[1]["mask"]).any() and not np.asarray(ref[0]["mask"])[2].any()


# ---------------------------------------------------------------------------
# detection losses
# ---------------------------------------------------------------------------


def random_heads(rng, B=2, H=10, W=10, scale=1.0):
    """Per-task NHWC head maps of the tiny config's branches."""
    heads = [dict() for _ in TASKS]
    for tid, name, ch in branch_list(TASKS, CFG.det_head.common_heads):
        heads[tid][name] = (scale * rng.randn(B, H, W, ch)).astype(np.float32)
    return heads


def _targets(gt):
    ref = jax_assign(jnp.asarray(gt), JaxAssignerConfig(max_pos=128), TASKS, CFG.grid_size,
                     CFG.point_cloud_range, CFG.voxel_size)
    got = assign_targets(torch.from_numpy(gt), AssignerConfig(max_pos=128), TASKS, CFG.grid_size,
                         CFG.point_cloud_range, CFG.voxel_size)
    return ref, got


def test_focal_loss_matches_jax():
    rng = np.random.RandomState(1)
    pred = rng.uniform(1e-4, 1 - 1e-4, (2, 3, 10, 10)).astype(np.float32)
    gt = (rng.rand(2, 3, 10, 10) < 0.05).astype(np.float32)
    for g in (gt, np.zeros_like(gt)):  # with positives, and with none
        ref = jdet.focal_loss(jnp.asarray(pred), jnp.asarray(g), 0.25, 2.0, None)
        got = pdet.focal_loss(torch.from_numpy(pred), torch.from_numpy(g), 0.25, 2.0)
        np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL, atol=ATOL)


def test_reg_and_iou_losses_match_jax():
    rng = np.random.RandomState(2)
    gt = random_gt(rng, 2, 16, 3, 12)
    ref_t, got_t = _targets(gt)
    pred = (0.5 * rng.randn(2, 10, 10, 11)).astype(np.float32)
    tid = int(np.argmax([np.asarray(t["mask"]).sum() for t in ref_t]))
    tg_r, tg_g = ref_t[tid], got_t[tid]
    target = np.asarray(tg_r["box_encoding"]).copy()
    target[0, 0, 3] = np.inf  # the reg loss masks non-finite targets
    r = jdet.reg_loss(jnp.asarray(pred[..., :10]), tg_r["mask"], tg_r["ind"], jnp.asarray(target), None)
    g = pdet.reg_loss(nchw(pred[..., :10]), tg_g["mask"], tg_g["ind"], torch.from_numpy(target))
    np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=RTOL, atol=ATOL)
    r = jdet.iou_losses(jnp.asarray(pred), tg_r["box_encoding"], tg_r["ind"], tg_r["mask"], 8,
                        CFG.voxel_size[:2], None)
    g = pdet.iou_losses(nchw(pred), tg_g["box_encoding"], tg_g["ind"], tg_g["mask"], 8, CFG.voxel_size[:2])
    np.testing.assert_allclose([x.item() for x in g], [float(x) for x in r], rtol=RTOL, atol=ATOL)
    assert float(r[0]) > 0 and float(r[1]) > 0


def test_automatic_weighted_loss_matches_jax():
    rng = np.random.RandomState(3)
    p = rng.uniform(0.5, 2, 12).astype(np.float32)
    losses = [np.float32(x) for x in rng.uniform(0, 5, 3)]
    ref = jdet.automatic_weighted_loss(jnp.asarray(p), [jnp.asarray(x) for x in losses])
    got = pdet.automatic_weighted_loss(torch.from_numpy(p), [torch.tensor(x) for x in losses])
    np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)


@pytest.mark.parametrize("code_scale", [1.0, 1e-3], ids=["loc_over_1", "loc_under_1"])
def test_center_head_loss_matches_jax(code_scale):
    """Total, metrics and the gradients to every head tensor and to the AWL
    parameters; with code weights scaled down, loc_loss < 1 and the IoU
    loss joins the total."""
    rng = np.random.RandomState(4)
    gt = random_gt(rng, 2, 16, 3, 12)
    gt[1, :, 9] = np.where(gt[1, :, 9] > 0, 1, 0)  # sample 1 has cars only
    ref_t, got_t = _targets(gt)
    heads = random_heads(rng)
    awl = rng.uniform(0.8, 1.2, 12).astype(np.float32)
    cw = tuple(c * code_scale for c in CFG.det_head.code_weights)
    args = (cw, CFG.det_head.iou_weight, 8, CFG.voxel_size[:2], 0.25, 2.0)

    def jloss(h, a):
        total, metrics, preds = jdet.center_head_loss(h, ref_t, a, *args)
        return total, (metrics, preds)

    (r_total, (r_metrics, r_preds)), (r_gh, r_ga) = jax.value_and_grad(jloss, argnums=(0, 1), has_aux=True)(
        jax.tree.map(jnp.asarray, heads), jnp.asarray(awl))
    th = [{k: nchw(v).requires_grad_(True) for k, v in h.items()} for h in heads]
    ta = torch.from_numpy(awl).requires_grad_(True)
    total, metrics, preds = pdet.center_head_loss(th, got_t, ta, *args)
    total.backward()
    np.testing.assert_allclose(total.item(), float(r_total), rtol=RTOL)
    assert set(metrics) == set(r_metrics)
    for k, v in r_metrics.items():
        np.testing.assert_allclose(metrics[k].item(), float(v), rtol=RTOL, atol=ATOL, err_msg=k)
    loc = [float(r_metrics[f"task_{t}/loc_loss"]) for t in range(len(TASKS))]
    assert all(x < 1 for x in loc) if code_scale < 1 else max(loc) > 1
    for tid, h in enumerate(th):
        np.testing.assert_allclose(nhwc(preds[tid]["hm"]), np.asarray(r_preds[tid]["hm"]), rtol=RTOL)
        assert not torch.equal(preds[tid]["hm"], h["hm"])  # the model's heads are left as they were
        for name, t in h.items():
            ref = np.asarray(r_gh[tid][name])
            scale = max(np.abs(ref).max(), 1e-12)
            np.testing.assert_allclose(nhwc(t.grad) / scale, ref / scale, atol=1e-5, err_msg=f"{tid}/{name}")
    np.testing.assert_allclose(ta.grad.numpy(), np.asarray(r_ga), rtol=1e-5, atol=1e-6)


# ---------------------------------------------------------------------------
# distillation pieces
# ---------------------------------------------------------------------------


def _boxes(seed):
    gt = random_gt(np.random.RandomState(seed), 2, 8, 3, 6)
    return gt


def test_gt_corners_bev_matches_jax():
    gt = _boxes(5)
    ref = jdist.gt_corners_bev(jnp.asarray(gt), CFG.point_cloud_range, CFG.voxel_size, 8)
    got = pdist.gt_corners_bev(torch.from_numpy(gt), CFG.point_cloud_range, CFG.voxel_size, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=1e-5)


def test_gaussian_mask_matches_jax():
    gt = _boxes(6)
    gt[0, 0, 3:5] = [0.2, 0.3]  # radius 0
    h, w = np.float32([0.5, 3.0, 40.0]), np.float32([0.7, 9.0, 2.0])
    np.testing.assert_allclose(pgauss.gaussian_radius(torch.from_numpy(h), torch.from_numpy(w)).numpy(),
                               np.asarray(jgauss.gaussian_radius(jnp.asarray(h), jnp.asarray(w))), rtol=RTOL)
    for hw, pc, vs in (((10, 10), CFG.point_cloud_range, CFG.voxel_size),
                       ((180, 180), (-54.0, -54.0, -5.0, 54.0, 54.0, 3.0), (0.075, 0.075, 0.2))):
        ref = jgauss.box_mask_gaussian(jnp.asarray(gt), hw, pc, vs, 8)
        got = pgauss.box_mask_gaussian(torch.from_numpy(gt), hw, pc, vs, 8)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)
        assert np.asarray(ref).max() == 1.0


def test_grid_sample_matches_jax():
    rng = np.random.RandomState(7)
    feat = rng.randn(2, 9, 11, 5).astype(np.float32)
    grid = rng.uniform(-1.3, 1.3, (2, 4, 9, 2)).astype(np.float32)  # some taps outside the map
    grid[0, 0, :3] = [[-1, -1], [1, 1], [0, 0]]
    ref = jax_grid_sample(jnp.asarray(feat), jnp.asarray(grid))
    got = grid_sample_2d(nchw(feat), torch.from_numpy(grid))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=RTOL, atol=ATOL)


def _grad_close(t, ref, name):
    ref = np.asarray(ref)
    scale = max(np.abs(ref).max(), 1e-12)
    np.testing.assert_allclose(nhwc(t.grad) / scale, ref / scale, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("which", ["feature", "bev_rel"])
def test_feature_and_relation_losses_match_jax(which):
    rng = np.random.RandomState(8)
    gt = _boxes(9)
    fs, ft = (rng.randn(2, 10, 10, 16).astype(np.float32) for _ in range(2))
    mask = np.abs(gt).sum(-1) > 0
    jfn, pfn = ((jdist.feature_distill_loss, pdist.feature_distill_loss) if which == "feature"
                else (jdist.bev_distill_loss, pdist.bev_distill_loss))
    jc = jdist.gt_corners_bev(jnp.asarray(gt), CFG.point_cloud_range, CFG.voxel_size, 8)
    ref, ref_g = jax.value_and_grad(lambda s: jfn(s, jnp.asarray(ft), jc, jnp.asarray(mask)))(jnp.asarray(fs))
    s = nchw(fs).requires_grad_(True)
    pc = pdist.gt_corners_bev(torch.from_numpy(gt), CFG.point_cloud_range, CFG.voxel_size, 8)
    got = pfn(s, nchw(ft), pc, torch.from_numpy(mask))
    got.backward()
    np.testing.assert_allclose(got.item(), float(ref), rtol=RTOL)
    _grad_close(s, ref_g, which)


def test_response_loss_matches_jax():
    rng = np.random.RandomState(10)
    gt = _boxes(11)
    student = random_heads(rng)
    for h in student:  # the student's heatmap arrives sigmoided and clamped
        h["hm"] = np.clip(1 / (1 + np.exp(-h["hm"])), 1e-4, 1 - 1e-4).astype(np.float32)
    teacher = random_heads(rng, scale=2.0)
    args = (CFG.point_cloud_range, CFG.voxel_size, 8, 2.0, 1e-4)

    def jloss(s):
        c, r = jdist.response_distill_loss(s, jax.tree.map(jnp.asarray, teacher), jnp.asarray(gt), *args)
        return c + 10 * r, (c, r)

    (_, (rc, rr)), rg = jax.value_and_grad(jloss, has_aux=True)(jax.tree.map(jnp.asarray, student))
    ts = [{k: nchw(v).requires_grad_(True) for k, v in h.items()} for h in student]
    c, r = pdist.response_distill_loss(ts, [{k: nchw(v) for k, v in h.items()} for h in teacher],
                                       torch.from_numpy(gt), *args)
    (c + 10 * r).backward()
    np.testing.assert_allclose([c.item(), r.item()], [float(rc), float(rr)], rtol=RTOL)
    assert float(rc) > 0 and float(rr) > 0
    for tid, h in enumerate(ts):
        for name, t in h.items():
            _grad_close(t, rg[tid][name], f"{tid}/{name}")
