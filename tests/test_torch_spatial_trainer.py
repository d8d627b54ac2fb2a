"""The port's (dp, bev) spatial path against its own one-process steps, on
the CPU, in worlds of four gloo ranks (`parallel.launch.run_ranks`;
rank-side functions in `tests/torch_spatial_ranks.py`):

  * the camera<-LiDAR distill step over (dp = 2, bev = 2), the case of
    `tests/test_torch_parallel.py` (float32, BatchNorms tamed, a batch of
    4): the metrics rtol 1e-4, the gradients within 2e-3 of their scale,
    the BatchNorm running statistics rtol 1e-4 / atol 1e-5 and the one-step
    parameter change against the one-process step on the global batch;
    every rank's parameters and statistics bit-equal;
  * the fusion train step over (dp = 1, bev = 4): 5 coarse BEV rows over
    four ranks (uneven blocks 2, 1, 1, 1), the same checks;
  * a BatchNorm with its statistics over two ranks (2-D, as the LiDAR
    encoder's, and 4-D, rows split unevenly) equals one BatchNorm over the
    whole batch: outputs, running statistics and gradients, 1e-5;
  * `train.spatial_bev = 2` in the `Trainer` over two ranks (one dp
    shard): the launchers' loaders give both the global batch; one train
    step equals the one-process `Trainer`'s step on it (its BatchNorm
    statistics, those of the whole batch, on every rank); over four ranks
    (dp = 2) `predict` gives every frame of the validation split once, in
    order;
  * `Trainer.fit(profile_steps=...)` writes a trace, and nothing without it.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from unidistill_torch.configs import nuscenes as cfgs
from unidistill_torch.parallel.launch import run_ranks
from unidistill_torch.parallel.spatial import row_blocks
from unidistill_torch.training.jax_weights import state_dict_from_jax

from tests.test_torch_parallel_cli import THREADS, WORLD_TIMEOUT_S, to_numpy
from tests.test_torch_spatial import TRAIN_CFG, assert_ranks_equal, check_grads, check_one_step, check_stats
from tests.torch_spatial_ranks import (
    _bn_case, one_process_step, rank_global_batch_norm, rank_spatial, rank_trainer, trainer_predict_and_step)

PAIR = ("lidar", "camera")
FRAMES = 5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


def check_against_one_process(got, m_ref, state_ref, g_ref, start):
    m = got[0]["metrics"]
    assert all(g["metrics"] == m for g in got)
    for k, v in m_ref.items():
        np.testing.assert_allclose(m[k], v, rtol=1e-4, atol=1e-6, err_msg=k)
    check_grads(got[0]["grads"], g_ref)
    check_stats(got[0]["state"], state_ref, start)
    check_one_step(got[0]["state"], state_ref, start, g_ref)
    assert_ranks_equal(got, start)


def test_row_blocks_split_as_evenly_as_they_go():
    assert row_blocks(90, 4) == [23, 23, 22, 22]
    assert row_blocks(90, 2) == [45, 45]
    assert row_blocks(5, 4) == [2, 1, 1, 1]
    with pytest.raises(ValueError):
        row_blocks(3, 4)


def test_spatial_distill_matches_the_one_process_step():
    from tests.test_torch_parallel import step_case

    (_, _, s_p, t_p), (s_params, s_stats, t_params, t_stats), batch = step_case()
    s_sd = to_numpy(state_dict_from_jax(s_params, s_stats, s_p))
    t_sd = to_numpy(state_dict_from_jax(t_params, t_stats, t_p))
    args = ("distill", 2, s_p, s_sd, batch, TRAIN_CFG, t_p, t_sd, PAIR)
    got = run_ranks(rank_spatial, 4, args, timeout_s=WORLD_TIMEOUT_S, threads=THREADS)
    assert [g["place"] for g in got] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    check_against_one_process(got, *one_process_step(*args[:1], *args[2:]), s_sd)


def fusion_case():
    """The tiny fusion detector in float32, seeded weights with tamed
    BatchNorms (scale × 0.3, bias + 1), a batch of 4 with clouds and
    images."""
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.serving.synthetic import train_batch
    from unidistill_torch.training.loop import init_params

    cfg = dataclasses.replace(cfgs.tiny_model(), compute_dtype="float32")
    model = init_params(BEVFusionCenterHead(cfg), 41)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, torch.nn.modules.batchnorm._BatchNorm):
                m.weight.mul_(0.3)
                m.bias.add_(1.0)
    return cfg, to_numpy(model.state_dict()), train_batch(cfg, cfg, 4, 42)


def test_uneven_row_blocks_over_four_bev_ranks():
    """The fusion detector (both encoders, the LiDAR one's BatchNorms
    over the sites, the fusion encoder's gate before the split)."""
    pcfg, sd, batch = fusion_case()
    args = ("train", 4, pcfg, sd, batch, TRAIN_CFG)
    got = run_ranks(rank_spatial, 4, args, timeout_s=WORLD_TIMEOUT_S, threads=THREADS)
    assert [g["place"] for g in got] == [(0, j) for j in range(4)]
    assert got[0]["blocks"] == [2, 1, 1, 1]
    check_against_one_process(got, *one_process_step(*args[:1], *args[2:]), sd)


def test_global_batch_norm_is_one_batch_norm_over_the_whole_batch():
    """Two ranks, rows split 5 + 3 ([N, C], as the LiDAR encoder's sites)
    and 3 + 1 ([N, C, H, W]): outputs, running statistics, the input
    gradient and the summed affine gradients equal one BatchNorm over the
    whole batch in one process."""
    from unidistill_torch.layers.common import BatchNorm

    shapes = (((8, 6), 5), ((4, 5, 3, 7), 3))
    got = run_ranks(rank_global_batch_norm, 2, (shapes, 7), timeout_s=WORLD_TIMEOUT_S, threads=THREADS)
    for shape, rows0 in shapes:
        x, w = _bn_case(shape, 7)
        bn = BatchNorm(shape[1], eps=1e-3, momentum=0.9)
        x = x.requires_grad_(True)
        y = bn(x)
        (y * w).sum().backward()
        ref = dict(y=y.detach().numpy(), gx=x.grad.numpy(),
                   gparams=torch.cat([bn.weight.grad, bn.bias.grad]).numpy(),
                   stats=np.stack([bn.running_mean.numpy(), bn.running_var.numpy()]))
        for k, v in ref.items():
            mine = np.concatenate([got[0][shape][k], got[1][shape][k]]) if k in ("y", "gx") else got[0][shape][k]
            np.testing.assert_allclose(mine, v, rtol=1e-5, atol=1e-5, err_msg=f"{shape} {k}")
        np.testing.assert_array_equal(got[1][shape]["stats"], got[0][shape]["stats"])


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    from tests.test_data_pipeline import build_synth_nusc  # the JAX package's test helper

    return build_synth_nusc(tmp_path_factory.mktemp("nusc_spatial"), FRAMES)


def test_spatial_bev_routes_the_trainer_through_the_spatial_step(synth_root, tmp_path):
    """Two ranks, `-b 2`, spatial_bev 2: one dp shard of two bev peers,
    which load the global batch of 2 that the one-process Trainer takes
    at `-b 2` (with the same augmentations: a dp shard draws from its own
    generator)."""
    ref = trainer_predict_and_step(synth_root, str(tmp_path / "one"), 1, 2)
    got = run_ranks(rank_trainer, 2, (synth_root, str(tmp_path / "spatial"), 2, 2),
                    timeout_s=WORLD_TIMEOUT_S, threads=THREADS)
    assert [g["tokens"] for g in got] == [ref["tokens"]] * 2
    for g in got:
        np.testing.assert_allclose(g["metrics"]["loss"], ref["metrics"]["loss"], rtol=1e-4)
    stats = [k for k in ref["state"] if k.endswith(("running_mean", "running_var"))]
    for r, g in enumerate(got):
        for k in stats:
            np.testing.assert_allclose(g["state"][k], ref["state"][k], rtol=1e-4, atol=1e-5,
                                       err_msg=f"rank {r}: {k}")
    assert_ranks_equal(got, ref["state"])


def test_spatial_trainer_predicts_each_frame_once_in_order(synth_root, tmp_path):
    ref = trainer_predict_and_step(synth_root, str(tmp_path / "one"), 1, 2)["preds"]
    got = run_ranks(rank_trainer, 4, (synth_root, str(tmp_path / "spatial"), 2, 1),
                    timeout_s=WORLD_TIMEOUT_S, threads=THREADS)
    assert len(ref) == FRAMES
    for g in got:
        preds = g["preds"]
        assert [p["meta"]["token"] for p in preds] == [p["meta"]["token"] for p in ref]
        for p, q in zip(preds, ref):
            assert len(p["scores"]) == len(q["scores"])
            np.testing.assert_allclose(np.sort(p["scores"]), np.sort(q["scores"]), rtol=1e-4, atol=1e-5)


def test_fit_writes_a_profile_only_when_asked(synth_root, tmp_path):
    from unidistill_torch.data.collate import DataLoader
    from unidistill_torch.data.dataset import NuScenesDataset
    from unidistill_torch.training.loop import Trainer

    exp = cfgs.ExpConfig(exp_name="tiny_camera", model=cfgs.tiny_model(with_lidar=False),
                         data=cfgs.DataConfig(root_path=synth_root, num_lidar_sweeps=2, use_cbgs=False),
                         train=cfgs.TrainConfig(batch_size_per_device=2, max_epochs=1))
    ds = NuScenesDataset(exp.data, exp.model, "training", seed=0)
    for name, steps in (("plain", None), ("traced", (1, 1))):
        trainer = Trainer(exp, output_dir=str(tmp_path / name), device="cpu")
        try:
            trainer.fit(DataLoader(ds, 2, drop_last=True), 1, profile_steps=steps)
        finally:
            trainer.close()
    assert not os.path.exists(tmp_path / "plain" / "profile")
    assert os.listdir(tmp_path / "traced" / "profile") == ["trace_rank0.json"]
    assert os.path.getsize(tmp_path / "traced" / "profile" / "trace_rank0.json") > 0
