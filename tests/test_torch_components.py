"""The port's leaf modules against the JAX package: `layers/sc_conv.py`,
`layers/pillar_vfe.py`, `ops/points_in_boxes.py`, `ops/roiaware_pool.py`.

Float32 on the CPU, on the cases of tests/test_parity_components.py and
tests/test_roiaware_pool.py and on seeded random inputs. JAX modules run
through `Module.apply` under `jax.jit` with parameters shaped by
`jax.eval_shape` and drawn from numpy (`tests/test_torch_weights.randomize`).
Tolerances: the convolution and linear blocks rtol 1e-4, atol 1e-4 (those
of tests/test_torch_weights.py), their BatchNorms' running statistics
rtol 1e-4, atol 1e-5 (tests/test_torch_train_step.py); the pools rtol 1e-5,
atol 1e-5 (tests/test_roiaware_pool.py); box tests and scatters exact.
The max pool's gradients are compared on tie-free features (continuous
random values): at ties torch splits a gradient where JAX need not.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidistill_tpu.layers.pillar_vfe import PillarVFE as JaxPillarVFE
from unidistill_tpu.layers.pillar_vfe import pointpillar_scatter as jax_scatter
from unidistill_tpu.layers.sc_conv import SCBottleneck as JaxSCBottleneck
from unidistill_tpu.ops import points_in_boxes as jpib
from unidistill_tpu.ops import roiaware_pool as jrp

from unidistill_torch.layers.pillar_vfe import PillarVFE, pointpillar_scatter
from unidistill_torch.layers.sc_conv import SCBottleneck
from unidistill_torch.ops import points_in_boxes as pib
from unidistill_torch.ops import roiaware_pool as rp
from unidistill_torch.serving.synthetic import pillars
from unidistill_torch.training.jax_weights import state_dict_from_jax

from tests.test_torch_data import _two_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_weights import PCFG, nchw, nhwc, randomize

TOL = dict(rtol=1e-4, atol=1e-4)
STATS_TOL = dict(rtol=1e-4, atol=1e-5)
POOL_TOL = dict(rtol=1e-5, atol=1e-5)


def jax_module(module, *args):
    """(params, batch_stats) drawn from numpy at the module's shapes, and
    run(*args) -> (eval-mode output, train-mode output, the batch_stats
    that train-mode forward leaves), jitted."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, False))
    rng = np.random.RandomState(0)
    params = randomize(shapes["params"], rng)
    stats = randomize(shapes.get("batch_stats", {}), rng, True)

    @jax.jit
    def run(v, *a):
        eval_out = module.apply(v, *a, False)
        train_out, new = module.apply(v, *a, True, mutable=["batch_stats"])
        return eval_out, train_out, new["batch_stats"]

    return params, stats, lambda *a: jax.tree.map(np.asarray, run({"params": params, "batch_stats": stats}, *a))


def port_from(module, params, stats):
    module.load_state_dict(state_dict_from_jax(params, stats, PCFG), strict=True)
    return module


def assert_stats(module, want_stats):
    got = module.state_dict()
    for k, v in state_dict_from_jax({}, want_stats, PCFG).items():
        if not k.endswith("num_batches_tracked"):
            np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **STATS_TOL)


# 18 x 22: the pool floors (4 x 5) and the nearest resize back is not a
# whole multiple; 16 x 16 divides
@pytest.mark.parametrize("H,W", [(16, 16), (18, 22)])
def test_scbottleneck_matches_jax(H, W):
    """Eval mode on the drawn statistics, then one train-mode forward: its
    output and the running statistics it leaves."""
    x = np.random.RandomState(H).randn(2, H, W, 32).astype(np.float32)
    params, stats, run = jax_module(JaxSCBottleneck(planes=32, dtype=jnp.float32), jnp.asarray(x))
    want_eval, want_train, want_stats = run(jnp.asarray(x))
    m = port_from(SCBottleneck(32, 32), params, stats)
    with torch.no_grad():
        np.testing.assert_allclose(nhwc(m.eval()(nchw(x))), want_eval, **TOL)
        np.testing.assert_allclose(nhwc(m.train()(nchw(x))), want_train, **TOL)
    assert_stats(m, want_stats)


def test_nearest_resize_is_half_pixel():
    """The JAX block's resize is `jax.image.resize(..., "nearest")`:
    half-pixel centres, torch's "nearest-exact" (not "nearest")."""
    x = np.arange(4 * 5, dtype=np.float32).reshape(1, 4, 5, 1)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 18, 22, 1), "nearest"))
    got = torch.nn.functional.interpolate(nchw(x), size=(18, 22), mode="nearest-exact")
    np.testing.assert_array_equal(nhwc(got), want)
    assert not torch.equal(torch.nn.functional.interpolate(nchw(x), size=(18, 22), mode="nearest"), got)


def pillar_case():
    """tests/test_parity_components.py's pillar inputs, with every pillar
    on its own cell."""
    rng = np.random.RandomState(0)
    P, N = 32, 10
    feats = rng.randn(P, N, 5).astype(np.float32)
    cells = rng.permutation(64)[:P]
    coords = np.stack([np.zeros(P, np.int64), cells // 8, cells % 8], 1).astype(np.int32)
    npts = rng.randint(0, N + 1, P).astype(np.int32)
    npts[:2] = (0, N)  # an empty pillar and a full one
    return feats, coords, npts


def test_pillar_vfe_and_scatter_match_jax():
    feats, coords, npts = pillar_case()
    kw = dict(num_filters=(16, 16), voxel_size=(1.0, 1.0, 8.0), point_cloud_range=(0, 0, -5, 8, 8, 3))
    args = (jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(npts))
    params, stats, run = jax_module(JaxPillarVFE(**kw, dtype=jnp.float32), *args)
    want_eval, want_train, want_stats = run(*args)
    m = port_from(PillarVFE(5, **kw), params, stats)
    t = [torch.from_numpy(a) for a in (feats, coords, npts)]
    with torch.no_grad():
        got_eval = m.eval()(*t)
        np.testing.assert_allclose(got_eval.numpy(), want_eval, **TOL)
        np.testing.assert_allclose(m.train()(*t).numpy(), want_train, **TOL)
    assert_stats(m, want_stats)
    valid = npts > 0
    canvas = pointpillar_scatter(got_eval, t[1], torch.from_numpy(valid), (8, 8, 1))
    want = np.asarray(jax_scatter(jnp.asarray(want_eval), jnp.asarray(coords), jnp.asarray(valid), (8, 8, 1)))
    assert canvas.shape == (8, 8, 16)
    np.testing.assert_allclose(canvas.numpy(), want, **TOL)
    # each valid pillar written once, the rest of the canvas 0
    np.testing.assert_array_equal(canvas[coords[valid, 1], coords[valid, 2]].numpy(), got_eval[valid].numpy())
    assert int((canvas.abs().sum(-1) > 0).sum()) == int((got_eval[valid].abs().sum(-1) > 0).sum())


def test_pointpillar_scatter_case_matches_jax():
    """tests/test_parity_components.py's scatter case, exactly."""
    P, C = 8, 4
    feats = np.arange(P * C, dtype=np.float32).reshape(P, C)
    coords = np.asarray([[0, 1, 2], [0, 0, 0], [0, 3, 1], [0, 2, 2]] + [[-1, -1, -1]] * 4, np.int32)
    valid = np.asarray([True] * 4 + [False] * 4)
    want = np.asarray(jax_scatter(jnp.asarray(feats), jnp.asarray(coords), jnp.asarray(valid), (4, 4, 1)))
    got = pointpillar_scatter(torch.from_numpy(feats), torch.from_numpy(coords), torch.from_numpy(valid), (4, 4, 1))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError, match="one cell high"):
        pointpillar_scatter(torch.from_numpy(feats), torch.from_numpy(coords), torch.from_numpy(valid), (4, 4, 2))


def test_pillars_group_points():
    """`synthetic.pillars`: every kept point sits in its pillar's cell, in
    input order, at most max_points a pillar."""
    rng = np.random.RandomState(1)
    pts = np.concatenate([rng.uniform(-1, 9, (400, 3)), rng.randn(400, 2)], 1).astype(np.float32)
    mask = rng.rand(400) > 0.1
    feats, coords, n = pillars(pts, mask, (1.0, 1.0, 8.0), (0, 0, -5, 8, 8, 3), 6)
    inside = mask & (pts[:, 0] >= 0) & (pts[:, 0] < 8) & (pts[:, 1] >= 0) & (pts[:, 1] < 8)
    inside &= (pts[:, 2] >= -5) & (pts[:, 2] < 3)
    assert len(set(map(tuple, coords.tolist()))) == len(coords) and (coords[:, 0] == 0).all()
    for v in range(len(coords)):
        cell = inside & (np.floor(pts[:, 1]) == coords[v, 1]) & (np.floor(pts[:, 0]) == coords[v, 2])
        want = pts[cell][:6]
        assert n[v] == len(want)
        np.testing.assert_array_equal(feats[v, :n[v]], want)
        assert not feats[v, n[v]:].any()
    assert n.sum() == sum(min(6, int(c)) for c in np.unique(
        (np.floor(pts[inside, 1]) * 8 + np.floor(pts[inside, 0])), return_counts=True)[1])


def box_case():
    boxes = np.asarray([[0.0, 0.0, 0.0, 4.0, 2.0, 2.0, np.pi / 2, 0, 0]], np.float32)
    pts = np.asarray([[0.9, 0.0, 0.0], [1.5, 0.0, 0.0], [0.0, 1.9, 0.0], [0.0, 0.0, 1.5]], np.float32)
    return pts, boxes


def random_boxes(rng, M, P):
    pts = rng.uniform(-6, 6, (P, 3)).astype(np.float32)
    boxes = np.concatenate([rng.uniform(-4, 4, (M, 3)), rng.uniform(0.5, 4, (M, 3)),
                            rng.uniform(-np.pi, np.pi, (M, 1))], 1).astype(np.float32)
    return pts, boxes


@pytest.mark.parametrize("case", ["parity", "random"])
def test_points_in_boxes_match_jax(case):
    pts, boxes = box_case() if case == "parity" else random_boxes(np.random.RandomState(2), 12, 500)
    for name in ("points_in_boxes_bev", "points_in_boxes_3d", "remove_points_in_boxes"):
        want = np.asarray(getattr(jpib, name)(jnp.asarray(pts), jnp.asarray(boxes)))
        got = getattr(pib, name)(torch.from_numpy(pts), torch.from_numpy(boxes)).numpy()
        np.testing.assert_array_equal(got, want, err_msg=name)
    if case == "parity":
        assert list(pib.remove_points_in_boxes(torch.from_numpy(pts), torch.from_numpy(boxes))) == [
            False, True, False, True]


def roi_case():
    """tests/test_roiaware_pool.py's oracle case."""
    rng = np.random.RandomState(0)
    rois = np.array([[0.0, 0.0, 0.0, 4.0, 2.0, 2.0, 0.3], [3.0, -1.0, 0.5, 2.0, 2.0, 1.5, -1.1]], np.float32)
    pts = rng.uniform(-4, 5, size=(300, 3)).astype(np.float32)
    feats = rng.randn(300, 5).astype(np.float32)
    return rois, pts, feats, (4, 3, 2)


@pytest.mark.parametrize("method", ["max", "avg"])
def test_roiaware_pool3d_and_gradients_match_jax(method):
    rois, pts, feats, out = roi_case()
    cot = np.random.RandomState(3).randn(2, *out, 5).astype(np.float32)

    def jax_loss(f):
        return jnp.sum(jrp.roiaware_pool3d(jnp.asarray(rois), jnp.asarray(pts), f, out, method) * cot)

    want = np.asarray(jrp.roiaware_pool3d(jnp.asarray(rois), jnp.asarray(pts), jnp.asarray(feats), out, method))
    want_g = np.asarray(jax.grad(jax_loss)(jnp.asarray(feats)))
    f = torch.from_numpy(feats).requires_grad_(True)
    got = rp.roiaware_pool3d(torch.from_numpy(rois), torch.from_numpy(pts), f, out, method)
    (got * torch.from_numpy(cot)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, **POOL_TOL)
    np.testing.assert_allclose(f.grad.numpy(), want_g, **POOL_TOL)
    assert (want != 0).any() and (want == 0).any()  # filled and empty cells


def test_roiaware_pool3d_gradient_case_matches_jax():
    """tests/test_roiaware_pool.py's backward case: max routes a cell's
    gradient to its maximum, avg spreads it 1/count."""
    rois = np.array([[0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0]], np.float32)
    pts = np.array([[-0.6, -0.6, 0.0], [-0.55, -0.55, 0.0], [0.6, 0.6, 0.0]], np.float32)
    feats = np.array([[1.0], [2.0], [3.0]], np.float32)
    for method, expect in (("max", [0.0, 1.0, 1.0]), ("avg", [0.5, 0.5, 1.0])):
        want = np.asarray(jax.grad(lambda f: jrp.roiaware_pool3d(rois, pts, f, 2, method).sum())(feats))
        f = torch.from_numpy(feats).requires_grad_(True)
        rp.roiaware_pool3d(torch.from_numpy(rois), torch.from_numpy(pts), f, 2, method).sum().backward()
        np.testing.assert_allclose(f.grad.numpy(), want, **POOL_TOL)
        np.testing.assert_allclose(f.grad.numpy()[:, 0], expect)


def test_roiaware_avg_bf16_count_matches_jax():
    """400 bf16 points in one cell: the count is float32 (a bf16 count stops
    at 256), the mean 2.0."""
    rois = np.array([[0.0, 0.0, 0.0, 1.0, 1.0, 1.0, 0.0]], np.float32)
    pts = np.zeros((400, 3), np.float32)
    want = np.asarray(jrp.roiaware_pool3d(jnp.asarray(rois), jnp.asarray(pts),
                                          jnp.ones((400, 1), jnp.bfloat16) * 2.0, 2, "avg"), np.float32)
    got = rp.roiaware_pool3d(torch.from_numpy(rois), torch.from_numpy(pts),
                             torch.full((400, 1), 2.0, dtype=torch.bfloat16), 2, "avg")
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), want)
    assert got.float().max().item() == 2.0


def test_points_in_boxes_index_matches_jax():
    boxes = np.array([[0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0], [0.5, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0]], np.float32)
    pts = np.array([[0.4, 0.0, 0.0], [1.3, 0.0, 0.0], [9.0, 9.0, 9.0]], np.float32)
    for p, b in ((pts, boxes), random_boxes(np.random.RandomState(4), 12, 500)):
        want = np.asarray(jrp.points_in_boxes_index(jnp.asarray(p), jnp.asarray(b)))
        got = rp.points_in_boxes_index(torch.from_numpy(p), torch.from_numpy(b))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    assert rp.points_in_boxes_index(torch.from_numpy(pts), torch.from_numpy(boxes)).tolist() == [0, 1, -1]


def test_bev_in_boxes_matches_jax():
    xs = np.linspace(-2, 2, 9, dtype=np.float32)
    grid = np.stack(np.meshgrid(xs, xs, indexing="ij"), -1)
    cases = [(np.array([[0.0, 0.0, 0.0, 2.0, 2.0, 2.0, 0.0]], np.float32), (-1.2, -1.2, -5, 1.2, 1.2, 5)),
             (random_boxes(np.random.RandomState(5), 6, 1)[1] * 0.5, (-1.5, -2.0, -5, 2.0, 1.0, 5))]
    for boxes, rng_ in cases:
        want = np.asarray(jrp.bev_in_boxes(jnp.asarray(grid), jnp.asarray(boxes), rng_))
        got = rp.bev_in_boxes(torch.from_numpy(grid), torch.from_numpy(boxes), rng_)
        np.testing.assert_array_equal(got.numpy(), want)
    assert got.dtype == torch.int32 and (got >= 0).any() and (got == -1).any()
