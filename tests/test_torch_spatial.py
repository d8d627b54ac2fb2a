"""The port's (dp, bev) spatial steps against the JAX package's
`parallel/spatial.py`, on the CPU. The port's side runs on a world of four
gloo ranks (dp = 2, bev = 2; `parallel.launch.run_ranks`, rank-side
functions in `tests/torch_spatial_ranks.py`, which imports no JAX); the
JAX side jits the `*_spatial` step on `make_mesh_2d(dp=2, bev=2)`, four of
the eight virtual CPU devices that `tests/conftest.py` forces.

The tiny camera detector in float32, its BatchNorms tamed (the parameters
of `tests/test_torch_train_step.py`), a batch of 4 (2 a dp shard):

  * eval: each rank's ROIs (its dp shard's frames, equal on the shard's
    two bev peers) against JAX `eval_step_spatial`: the kept scores of
    each frame within 2e-2 (the tolerance of `tests/test_spatial_sharding.py`,
    which compares sorted kept scores: near-tied random-init scores make
    the keep order unstable); the whole gathered maps (bev_feature, the
    heatmaps) against the port's one-process forward, 1e-4;
  * train: JAX `train_step_spatial`: the loss rtol 1e-3, every metric
    rtol 5e-3 / atol 1e-4 (the tolerances of `tests/test_spatial_sharding.py`),
    the gradients within 2e-3 of their scale and the BatchNorm running
    statistics rtol 1e-4 / atol 1e-5 (those of `tests/test_torch_parallel.py`);
    the port's one-process step on the global batch: the same statistics
    and the one-step parameter change (`check_one_step`); every rank's
    parameters and statistics bit-equal;
  * the camera<-LiDAR distill step against JAX `distill_train_step_spatial`
    (marked slow: its JAX compile takes ~80 s; `tests/test_torch_spatial_trainer.py`
    holds the same step to the port's one-process step, which
    `tests/test_torch_distill.py` holds to JAX's).
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidistill_tpu.configs.nuscenes import DISTILL_VARIANTS as JAX_VARIANTS
from unidistill_tpu.configs.nuscenes import tiny_model as jax_tiny_model
from unidistill_tpu.models.bevfusion import BEVFusionCenterHead as JaxModel
from unidistill_tpu.parallel.spatial import (
    distill_train_step_spatial as jax_distill_spatial,
    eval_step_spatial as jax_eval_spatial,
    make_mesh_2d,
    train_step_spatial as jax_train_spatial,
)
from unidistill_tpu.training.train_state import create_train_state, make_optimizer as jax_make_optimizer

from unidistill_torch.configs.nuscenes import TrainConfig, tiny_model
from unidistill_torch.parallel.launch import run_ranks
from unidistill_torch.training.jax_weights import state_dict_from_jax

from tests.test_torch_parallel_cli import THREADS, WORLD_TIMEOUT_S, to_numpy
from tests.test_torch_train_step import CLIP, LR, WD, capturing, grad_scales, jax_params, train_batch_np
from tests.torch_spatial_ranks import one_process_step, rank_spatial, rank_spatial_kinds

DP, BEV, B = 2, 2, 4
TRAIN_CFG = TrainConfig(lr=LR, weight_decay=WD, grad_clip_value=CLIP)
PAIR = ("lidar", "camera")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=1)
def case():
    """(JAX config, port config, JAX params, JAX stats, batch, port state dict)."""
    jcfg = dataclasses.replace(jax_tiny_model(with_lidar=False), compute_dtype="float32")
    pcfg = dataclasses.replace(tiny_model(with_lidar=False), compute_dtype="float32")
    batch = train_batch_np(pcfg, B=B, seed=31)
    params, stats = jax_params(jcfg, batch, seed=32)
    return jcfg, pcfg, params, stats, batch, to_numpy(state_dict_from_jax(params, stats, pcfg))


def jax_state(params, stats, tx):
    return create_train_state({"params": params, "batch_stats": stats}, tx)


@functools.lru_cache(maxsize=1)
def port_world():
    """The eval and the train step, each from the same weights, in one
    world of four ranks."""
    _, pcfg, _, _, batch, sd = case()
    return run_ranks(rank_spatial_kinds, DP * BEV, (("eval", "train"), BEV, pcfg, sd, batch, TRAIN_CFG),
                     timeout_s=WORLD_TIMEOUT_S, threads=THREADS)


def port_spatial(kind):
    return [r[kind] for r in port_world()]


@functools.lru_cache(maxsize=1)
def jax_train():
    """JAX `train_step_spatial` on the 2×2 mesh: new params, new stats,
    metrics, gradients."""
    jcfg, _, params, stats, batch, _ = case()
    tx = capturing(jax_make_optimizer(LR, WD, CLIP))
    mesh = make_mesh_2d(dp=DP, bev=BEV)
    step = jax.jit(lambda s, b: jax_train_spatial(s, b, JaxModel(jcfg), tx, jcfg, mesh))
    new, metrics = step(jax_state(params, stats, tx), jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, (new.params, new.batch_stats, metrics, new.opt_state[0]))


def assert_ranks_equal(got, keys):
    for r in got[1:]:
        for k in keys:
            np.testing.assert_array_equal(r["state"][k], got[0]["state"][k], err_msg=k)


def check_stats(state, ref, before):
    stats = [k for k in ref if k.endswith(("running_mean", "running_var"))]
    assert stats
    for k in stats:
        assert not np.array_equal(state[k], before[k]), k
        np.testing.assert_allclose(state[k], np.asarray(ref[k]), rtol=1e-4, atol=1e-5, err_msg=k)


def check_grads(grads, ref):
    assert set(grads) == set(ref)
    scales = grad_scales(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(grads[k] / scales[k], np.asarray(r) / scales[k], atol=2e-3, err_msg=f"grad {k}")


def check_one_step(state, ref_state, before, g_ref, lr=LR):
    """The parameter change of one Adam step (as `tests/test_torch_train_step.py`):
    within 1e-2·lr where the gradient is above 1e-3 of its scale, within
    2·lr everywhere (a gradient near 0 may flip the sign of its step)."""
    scales = grad_scales(g_ref)
    for k, g in g_ref.items():
        d_got, d_ref = state[k] - before[k], np.asarray(ref_state[k]) - before[k]
        big = np.abs(g) > 1e-3 * scales[k]
        err = np.abs(d_got - d_ref)
        assert err[big].max(initial=0) <= 1e-2 * lr, (k, err[big].max())
        assert err.max() <= 2 * lr * (1 + 1e-3), (k, err.max())


# ---- eval ----------------------------------------------------------------------


def test_spatial_eval_matches_jax():
    jcfg, pcfg, params, stats, batch, sd = case()
    mesh = make_mesh_2d(dp=DP, bev=BEV)
    ref = jax.jit(lambda s, b: jax_eval_spatial(s, b, JaxModel(jcfg), jcfg, mesh))(
        jax_state(params, stats, jax_make_optimizer(LR, WD, CLIP)), jax.tree.map(jnp.asarray, batch))
    ref = jax.tree.map(np.asarray, ref)
    got = port_spatial("eval")
    assert [g["place"] for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert got[0]["blocks"] == [3, 2]  # 10 BEV rows, 5 at the backbone's stride 2
    for d in range(DP):
        peer0, peer1 = got[d * BEV], got[d * BEV + 1]
        for k in peer0["rois"]:  # the bev peers of a shard decode the same maps
            np.testing.assert_array_equal(peer1["rois"][k], peer0["rois"][k], err_msg=k)
        for i in range(B // DP):
            mine = peer0["rois"]
            gs = np.sort(mine["scores"][i][mine["mask"][i]])
            rs = np.sort(ref["scores"][d * 2 + i][ref["mask"][d * 2 + i]])
            assert len(gs) == len(rs) > 0, (d, i)
            np.testing.assert_allclose(gs, rs, rtol=2e-2, atol=2e-2)
    whole = one_process_step("eval", pcfg, sd, batch, TRAIN_CFG)
    for k, v in whole.items():
        mine = np.concatenate([got[d * BEV]["maps"][k] for d in range(DP)])
        np.testing.assert_allclose(mine, v, rtol=1e-4, atol=1e-4, err_msg=k)


# ---- train ----------------------------------------------------------------------


def test_spatial_train_metrics_and_gradients_match_jax():
    _, pcfg, _, _, _, _ = case()
    _, _, ref_metrics, ref_grads = jax_train()
    got = port_spatial("train")
    m = got[0]["metrics"]
    assert all(g["metrics"] == m for g in got)  # one global loss on every rank
    np.testing.assert_allclose(m["loss"], float(ref_metrics["loss"]), rtol=1e-3)
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(m[k], float(v), rtol=5e-3, atol=1e-4, err_msg=k)
    check_grads(got[0]["grads"], to_numpy(state_dict_from_jax(ref_grads, {}, pcfg)))


def test_spatial_train_statistics_match_jax_and_ranks_agree():
    _, pcfg, _, _, _, sd = case()
    ref_params, ref_stats, _, _ = jax_train()
    got = port_spatial("train")
    check_stats(got[0]["state"], to_numpy(state_dict_from_jax(ref_params, ref_stats, pcfg)), sd)
    assert_ranks_equal(got, sd)


def test_spatial_train_matches_the_one_process_step():
    _, pcfg, _, _, batch, sd = case()
    m_ref, state_ref, g_ref = one_process_step("train", pcfg, sd, batch, TRAIN_CFG)
    got = port_spatial("train")
    m = got[0]["metrics"]
    for k, v in m_ref.items():
        np.testing.assert_allclose(m[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    check_grads(got[0]["grads"], g_ref)
    check_stats(got[0]["state"], state_ref, sd)
    check_one_step(got[0]["state"], state_ref, sd, g_ref)


# ---- distill, against the JAX spatial step -------------------------------------------


@pytest.mark.slow
def test_spatial_distill_matches_jax_spatial_step():
    from tests.test_torch_parallel import step_case

    (s_j, t_j, s_p, t_p), (s_params, s_stats, t_params, t_stats), batch = step_case()
    tx = capturing(jax_make_optimizer(LR, WD, CLIP))
    mesh = make_mesh_2d(dp=DP, bev=BEV)
    step = jax.jit(lambda s, b: jax_distill_spatial(s, t_params, t_stats, b, JaxModel(s_j), JaxModel(t_j), tx,
                                                    s_j, t_j, JAX_VARIANTS[PAIR], mesh))
    new, ref = step(jax_state(s_params, s_stats, tx), jax.tree.map(jnp.asarray, batch))
    new, ref = jax.tree.map(np.asarray, (new, ref))
    s_sd = to_numpy(state_dict_from_jax(s_params, s_stats, s_p))
    t_sd = to_numpy(state_dict_from_jax(t_params, t_stats, t_p))
    got = run_ranks(rank_spatial, DP * BEV, ("distill", BEV, s_p, s_sd, batch, TRAIN_CFG, t_p, t_sd, PAIR),
                    timeout_s=WORLD_TIMEOUT_S, threads=THREADS)
    m = got[0]["metrics"]
    np.testing.assert_allclose(m["loss"], float(ref["loss"]), rtol=1e-3)
    for k, v in ref.items():
        np.testing.assert_allclose(m[k], float(v), rtol=5e-3, atol=1e-4, err_msg=k)
    check_grads(got[0]["grads"], to_numpy(state_dict_from_jax(new.opt_state[0], {}, s_p)))
    check_stats(got[0]["state"], to_numpy(state_dict_from_jax(new.params, new.batch_stats, s_p)), s_sd)
    assert_ranks_equal(got, s_sd)
