"""The port's LiDAR and fusion train steps against the JAX package.

As tests/test_torch_train_step.py does for the camera detector: seeded JAX
parameters (He-scaled kernels, BatchNorms tamed: scale × 0.3, bias + 1, see
that file) go into the JAX model as they are and into the port through
`state_dict_from_jax`; one numpy batch (point clouds, for fusion also
images and camera matrices, and GT boxes) runs through JAX `train_step` and
the port's `train_step`, float32 on the CPU at `tiny_model` shapes, with the
experiment's optimizer (`lidar_exp().train`, lr 1e-3; `fusion_exp().train`,
lr 1e-3). The JAX encoder is its default chunked one with its stage caps
raised so that none binds (tests/test_torch_lidar_detector.py). The port's
LiDAR encoder trains through `SparseConv`'s backward, here on the CPU its
plain version's autograd.

Tolerances, those of the camera step: loss and every metric rtol 1e-4; every
gradient within 2e-3 of its scale (the larger of the tensor's max |g| and
1e-3 of the largest |g|); BatchNorm statistics rtol 1e-4, atol 1e-5; the
one-step parameter change within 1e-2·lr where |g| is above 1e-3 of its
scale, elsewhere within 2·lr.

Also here: the voxel caps in training. The JAX step voxelises the batch at
`max_voxels_train` in training and at `max_voxels_eval` otherwise; a cloud
with a voxel count between the two caps shows the difference.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidistill_tpu.configs.nuscenes import fusion_exp as jax_fusion_exp
from unidistill_tpu.configs.nuscenes import lidar_exp as jax_lidar_exp
from unidistill_tpu.configs.nuscenes import tiny_model as jax_tiny_model
from unidistill_tpu.models.bevfusion import BEVFusionCenterHead as JaxModel
from unidistill_tpu.training import steps as jax_steps
from unidistill_tpu.training.train_state import create_train_state, make_optimizer as jax_make_optimizer

from unidistill_torch.configs.nuscenes import fusion_exp, lidar_exp, tiny_model
from unidistill_torch.models.bevfusion import BEVFusionCenterHead
from unidistill_torch.training.jax_weights import state_dict_from_jax
from unidistill_torch.training.steps import metrics_to_host, model_inputs, train_step
from unidistill_torch.training.train_state import TrainState, make_optimizer

from tests.test_torch_assigner_losses import random_gt
from tests.test_torch_camera_detector import camera_batch
from tests.test_torch_lidar_detector import RAISED_CAPS, point_batch
from tests.test_torch_train_step import (
    capturing, check_batch_stats, check_gradients, check_metrics, check_one_step, jax_params,
)

MODALITIES = ("lidar", "fusion")
EXPS = {"lidar": (lidar_exp, jax_lidar_exp), "fusion": (fusion_exp, jax_fusion_exp)}


def configs(modality):
    """(JAX, port) tiny f32 configs; the JAX stage caps raised."""
    cam = modality == "fusion"
    base = jax_tiny_model(with_camera=cam)
    jcfg = dataclasses.replace(base, compute_dtype="float32",
                               lidar_encoder=dataclasses.replace(base.lidar_encoder, **RAISED_CAPS))
    return jcfg, dataclasses.replace(tiny_model(with_camera=cam), compute_dtype="float32")


@functools.lru_cache(maxsize=None)
def case(modality):
    jcfg, pcfg = configs(modality)
    batch = dict(point_batch(pcfg, 2, 1500, seed=0),
                 gt_boxes=random_gt(np.random.RandomState(3), 2, pcfg.caps.max_gt_boxes, 4, 12, span=45.0))
    if modality == "fusion":
        batch.update(camera_batch(pcfg, 2, seed=4))
    params, stats = jax_params(jcfg, batch, seed=7)
    return jcfg, pcfg, params, stats, batch


def train_cfg(modality):
    return EXPS[modality][0]().train


@functools.lru_cache(maxsize=None)
def jax_step(modality):
    jcfg, _, params, stats, batch = case(modality)
    model = JaxModel(jcfg)
    t = EXPS[modality][1]().train
    tx = capturing(jax_make_optimizer(t.lr, t.weight_decay, t.grad_clip_value))
    state = create_train_state({"params": params, "batch_stats": stats}, tx)
    step = jax.jit(lambda st, b: jax_steps.train_step(st, b, model, tx, jcfg))
    new_state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, (new_state.params, new_state.batch_stats, metrics,
                                     new_state.opt_state[0]))


@functools.lru_cache(maxsize=None)
def port_step(modality):
    _, pcfg, params, stats, batch = case(modality)
    model = BEVFusionCenterHead(pcfg)
    model.load_state_dict(state_dict_from_jax(params, stats, pcfg), strict=True)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model, train_cfg(modality))
    state = TrainState()
    metrics = train_step(state, batch, model, opt, pcfg)
    unclip = max(1.0, metrics["grad_norm"].item() / opt.grad_clip)  # .grad holds the clipped gradients
    grads = {k: p.grad * unclip for k, p in model.named_parameters()}
    return model, before, metrics_to_host(metrics), grads, state


@pytest.mark.parametrize("modality", MODALITIES)
def test_train_loss_and_metrics_match_jax(modality):
    _, _, ref_metrics, ref_grads = jax_step(modality)
    _, _, metrics, _, state = port_step(modality)
    assert state.step == 1
    check_metrics(metrics, ref_metrics, ref_grads)


@pytest.mark.parametrize("modality", MODALITIES)
def test_train_gradients_match_jax(modality):
    """Every parameter's gradient, and every sparse weight and bias and every
    LiDAR BatchNorm γ/β gets one (through `to_dense_bev` and 21 convs)."""
    _, pcfg, _, _, _ = case(modality)
    _, _, _, ref_grads = jax_step(modality)
    _, _, _, grads, _ = port_step(modality)
    check_gradients(grads, state_dict_from_jax(ref_grads, {}, pcfg))
    lidar = {k: g for k, g in grads.items() if k.startswith("lidar_encoder.")}
    assert len(lidar) == 21 + 16 + 2 * 21  # 21 weights, 16 block conv biases, 21 BN γ and β
    dead = [k for k, g in lidar.items() if not g.abs().max() > 0 and not k.endswith(("conv1.bias", "conv2.bias"))]
    assert not dead, dead  # a conv bias before a BatchNorm has a true gradient of 0


@pytest.mark.parametrize("modality", MODALITIES)
def test_train_batch_stats_match_jax(modality):
    _, pcfg, _, _, _ = case(modality)
    ref_params, ref_stats, _, _ = jax_step(modality)
    model, before, _, _, _ = port_step(modality)
    check_batch_stats(model, before, state_dict_from_jax(ref_params, ref_stats, pcfg))


@pytest.mark.parametrize("modality", MODALITIES)
def test_train_one_step_parameters_match_jax(modality):
    _, pcfg, _, _, _ = case(modality)
    ref_params, _, _, ref_grads = jax_step(modality)
    model, before, _, _, _ = port_step(modality)
    # the clip divides by |g| ≈ 40; the first stages' gradients (~1e-6) then
    # fall below Adam's eps 1e-8 and step by less than lr/2 on both sides
    check_one_step(model, before, state_dict_from_jax(ref_params, {}, pcfg),
                   state_dict_from_jax(ref_grads, {}, pcfg), train_cfg(modality).lr, min_moved=0.6)


@pytest.mark.parametrize("modality", MODALITIES)
def test_optimizer_is_the_experiments(modality):
    """`make_optimizer` of the experiment's TrainConfig: lr 1e-3, weight
    decay 1e-7, clip 0.1, milestones (10, 15) at γ 0.1, as the JAX config."""
    t, jt = EXPS[modality][0]().train, EXPS[modality][1]().train
    assert dataclasses.asdict(t) == dataclasses.asdict(jt)
    model = BEVFusionCenterHead(configs(modality)[1])
    opt = make_optimizer(model, t, steps_per_epoch=2)
    assert (opt.base_lr, opt.grad_clip, opt.milestones, opt.gamma) == (1e-3, 0.1, (10, 15), 0.1)
    assert [opt.lr(s) for s in (0, 19, 20, 29, 30)] == pytest.approx([1e-3, 1e-3, 1e-4, 1e-4, 1e-5])
    assert all(g["weight_decay"] == 1e-7 for g in opt.adamw.param_groups)
    assert len(opt.params) == len(list(model.parameters()))


def test_voxel_caps_follow_training():
    """Train-mode voxels are the JAX `voxelize_batch(..., training=True)`
    ones (the train cap), eval-mode voxels the eval cap's, on a cloud whose
    voxel count lies between the two caps."""
    jcfg, pcfg = jax_tiny_model(with_camera=False), tiny_model(with_camera=False)
    caps = dict(max_voxels_train=384, max_voxels_eval=2048)
    jcfg = dataclasses.replace(jcfg, caps=dataclasses.replace(jcfg.caps, **caps))
    pcfg = dataclasses.replace(pcfg, caps=dataclasses.replace(pcfg.caps, **caps))
    batch = point_batch(pcfg, 2, 1500, seed=5)
    jb = jax.tree.map(jnp.asarray, batch)
    n_voxels = (np.asarray(jax_steps.voxelize_batch(jb, jcfg, training=False)[1])[..., 0] >= 0).sum(1)
    assert (n_voxels > caps["max_voxels_train"]).all() and (n_voxels < caps["max_voxels_eval"]).all()
    for training, cap in ((True, caps["max_voxels_train"]), (False, caps["max_voxels_eval"])):
        jf, jc = map(np.asarray, jax_steps.voxelize_batch(jb, jcfg, training=training))
        kw = model_inputs(batch, pcfg, "cpu", training=training)
        assert kw["voxel_coords"].shape == (2, cap, 3)
        np.testing.assert_array_equal(kw["voxel_coords"].numpy(), jc)
        np.testing.assert_allclose(kw["voxel_feats"].numpy(), jf, rtol=1e-6, atol=1e-6)
