"""The port's distillation step for the three pairs besides camera←LiDAR
(tests/test_torch_distill.py): camera→LiDAR, fusion→LiDAR and
fusion→camera, against the JAX `distill_train_step`.

One parametrised set of tests. The student has seeded JAX parameters with
its BatchNorms tamed (tests/test_torch_train_step.py); the frozen teacher
has seeded parameters and statistics. Every LiDAR encoder is the JAX chunked
one with its stage caps raised so that none binds. One numpy batch carries
images, camera matrices, point clouds and GT boxes; the student voxelises
it at the train cap, the teacher at the eval cap (both 2048 here). Each
pair runs with its `DISTILL_VARIANTS` weights and `distill_exp` optimizer,
float32 on the CPU at `tiny_model` shapes.

Tolerances as tests/test_torch_distill.py: the total, the four distillation
terms, `loss_det` and every metric rtol 1e-4; every student gradient within
2e-3 of its scale; BatchNorm statistics rtol 1e-4, atol 1e-5. The teacher
is left as it was and gets no gradient.
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
from unidistill_tpu.training import steps as jax_steps
from unidistill_tpu.training.train_state import create_train_state, make_optimizer as jax_make_optimizer

from unidistill_torch.configs.nuscenes import DISTILL_VARIANTS, distill_exp, tiny_model
from unidistill_torch.models.bevfusion import BEVFusionCenterHead
from unidistill_torch.training.jax_weights import state_dict_from_jax
from unidistill_torch.training.steps import distill_train_step, metrics_to_host
from unidistill_torch.training.train_state import TrainState, make_optimizer

from tests.test_torch_assigner_losses import random_gt
from tests.test_torch_camera_detector import camera_batch
from tests.test_torch_lidar_detector import RAISED_CAPS, point_batch
from tests.test_torch_train_step import capturing, check_gradients, jax_params, jax_shapes
from tests.test_torch_weights import randomize

PAIRS = [("camera", "lidar"), ("fusion", "lidar"), ("fusion", "camera")]
IDS = [f"{s}_from_{t}" for t, s in PAIRS]


def configs(modality):
    """(JAX, port) tiny f32 configs of a modality; JAX stage caps raised."""
    lidar, camera = modality in ("lidar", "fusion"), modality in ("camera", "fusion")
    base = jax_tiny_model(with_lidar=lidar, with_camera=camera)
    jcfg = dataclasses.replace(base, compute_dtype="float32",
                               lidar_encoder=dataclasses.replace(base.lidar_encoder, **RAISED_CAPS))
    return jcfg, dataclasses.replace(tiny_model(with_lidar=lidar, with_camera=camera), compute_dtype="float32")


@functools.lru_cache(maxsize=1)
def frames():
    """One batch for every pair: images, camera matrices, clouds, GT boxes
    (the tiny configs share their caps and cameras)."""
    p = configs("fusion")[1]
    return dict(point_batch(p, 2, 1500, seed=6), **camera_batch(p, 2, seed=5),
                gt_boxes=random_gt(np.random.RandomState(4), 2, p.caps.max_gt_boxes, 4, 12, span=45.0))


@functools.lru_cache(maxsize=None)
def shapes_of(modality):
    """The JAX model's parameter shapes, traced once per modality (each is
    the student or the teacher of two pairs)."""
    return jax_shapes(configs(modality)[0], frames())


@functools.lru_cache(maxsize=None)
def case(pair):
    teacher, student = pair
    (s_j, s_p), (t_j, t_p) = configs(student), configs(teacher)
    batch = frames()
    s_params, s_stats = jax_params(s_j, batch, seed=8, shapes=shapes_of(student))
    shapes = shapes_of(teacher)
    rng = np.random.RandomState(9)
    t_params, t_stats = randomize(shapes["params"], rng), randomize(shapes["batch_stats"], rng)
    t_params["det_head"]["out_kernel"] = t_params["det_head"]["out_kernel"] * np.float32(0.05)
    return (s_j, t_j, s_p, t_p), (s_params, s_stats, t_params, t_stats), batch


@functools.lru_cache(maxsize=None)
def jax_step(pair):
    (s_j, t_j, _, _), (s_params, s_stats, t_params, t_stats), batch = case(pair)
    t = distill_exp(*pair).train
    tx = capturing(jax_make_optimizer(t.lr, t.weight_decay, t.grad_clip_value))
    state = create_train_state({"params": s_params, "batch_stats": s_stats}, tx)
    student, teacher = JaxModel(s_j), JaxModel(t_j)
    step = jax.jit(lambda st, b: jax_steps.distill_train_step(
        st, t_params, t_stats, b, student, teacher, tx, s_j, t_j, JAX_VARIANTS[pair]))
    new_state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, (new_state.params, new_state.batch_stats, metrics,
                                     new_state.opt_state[0]))


@functools.lru_cache(maxsize=None)
def port_step(pair):
    (_, _, s_p, t_p), (s_params, s_stats, t_params, t_stats), batch = case(pair)
    student = BEVFusionCenterHead(s_p)
    student.load_state_dict(state_dict_from_jax(s_params, s_stats, s_p), strict=True)
    teacher = BEVFusionCenterHead(t_p)
    teacher.load_state_dict(state_dict_from_jax(t_params, t_stats, t_p), strict=True)
    teacher.requires_grad_(False)
    teacher_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    opt = make_optimizer(student, distill_exp(*pair).train)
    metrics = distill_train_step(TrainState(), batch, student, teacher, opt, s_p, t_p, DISTILL_VARIANTS[pair])
    unclip = max(1.0, metrics["grad_norm"].item() / opt.grad_clip)  # .grad holds the clipped gradients
    grads = {k: p.grad * unclip for k, p in student.named_parameters()}
    return student, teacher, teacher_before, metrics_to_host(metrics), grads


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_distill_pair_losses_match_jax(pair):
    _, _, ref, _ = jax_step(pair)
    _, _, _, got, _ = port_step(pair)
    for k in ("loss", "loss_det", "loss_feature", "loss_bev_rel", "loss_resp_cls", "loss_resp_reg"):
        assert np.isfinite(got[k]) and got[k] > 0, k
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    w = DISTILL_VARIANTS[pair]
    total = got["loss_det"] + w.w_feature * got["loss_feature"] + w.w_rel * got["loss_bev_rel"] \
        + w.w_resp * (got["loss_resp_cls"] + got["loss_resp_reg"])
    np.testing.assert_allclose(got["loss"], total, rtol=1e-6)


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_distill_pair_student_gradients_match_jax(pair):
    (_, _, s_p, _), _, _ = case(pair)
    _, _, _, ref_grads = jax_step(pair)
    _, _, _, _, grads = port_step(pair)
    check_gradients(grads, state_dict_from_jax(ref_grads, {}, s_p))


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_distill_pair_batch_stats_match_jax(pair):
    (_, _, s_p, _), _, _ = case(pair)
    ref_params, ref_stats, _, _ = jax_step(pair)
    student, _, _, _, _ = port_step(pair)
    ref = state_dict_from_jax(ref_params, ref_stats, s_p)
    got = student.state_dict()
    n = 0
    for k, r in ref.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
            n += 1
    assert n > 40


@pytest.mark.parametrize("pair", PAIRS, ids=IDS)
def test_distill_pair_teacher_stays_frozen(pair):
    _, teacher, before, _, _ = port_step(pair)
    assert not teacher.training
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in teacher.parameters())


def test_every_pair_has_its_experiment():
    """`distill_exp` picks the student's experiment (LiDAR or camera) and
    the pair's weights; the fusion teacher is `fusion_exp().model`."""
    from unidistill_torch.configs.nuscenes import fusion_exp, lidar_exp
    for t, s in PAIRS:
        exp = distill_exp(t, s)
        assert exp.distill == DISTILL_VARIANTS[(t, s)] and exp.train.lr == 2e-4
        assert (exp.model.with_lidar, exp.model.with_camera) == (s == "lidar", s == "camera")
        if s == "lidar":
            assert exp.model == lidar_exp().model
    assert fusion_exp().model.with_lidar and fusion_exp().model.with_camera
