"""The port's camera←LiDAR distillation step against the JAX package.

The student is the tiny camera model of tests/test_torch_train_step.py
(seeded JAX parameters, BatchNorms tamed as described there); the frozen
teacher is the tiny LiDAR model with seeded parameters and statistics (its
JAX stage caps raised so that none binds, as in
tests/test_torch_lidar_detector.py). One numpy batch carries images, camera
matrices, point clouds and GT boxes; it runs through JAX
`distill_train_step` and the port's `distill_train_step` with the
("lidar", "camera") weights of `DISTILL_VARIANTS`, float32 on the CPU.
Tolerances as in tests/test_torch_train_step.py: the total, the four
distillation terms, `loss_det` and every metric rtol 1e-4; every student
gradient within 2e-3 of its scale; BatchNorm statistics rtol 1e-4, atol
1e-5. The teacher is left as it was.
"""
import dataclasses
import functools

import numpy as np
import torch

import jax
import jax.numpy as jnp

from unidistill_tpu.configs.nuscenes import DISTILL_VARIANTS as JAX_VARIANTS
from unidistill_tpu.configs.nuscenes import tiny_model as jax_tiny_model
from unidistill_tpu.models.bevfusion import BEVFusionCenterHead as JaxModel
from unidistill_tpu.training import steps as jax_steps
from unidistill_tpu.training.train_state import create_train_state, make_optimizer as jax_make_optimizer

from unidistill_torch.configs.nuscenes import CLASS_TO_IDX, DISTILL_VARIANTS, TrainConfig, distill_exp, tiny_model
from unidistill_torch.models.bevfusion import BEVFusionCenterHead
from unidistill_torch.serving.synthetic import lidar_batch, train_batch
from unidistill_torch.training.jax_weights import state_dict_from_jax
from unidistill_torch.training.steps import distill_train_step, metrics_to_host
from unidistill_torch.training.train_state import TrainState, make_optimizer

from tests.test_torch_lidar_detector import RAISED_CAPS, point_batch
from tests.test_torch_train_step import (
    CLIP, LR, WD, capturing, grad_scales, jax_params, train_batch_np,
)
from tests.test_torch_weights import randomize

PAIR = ("lidar", "camera")


@functools.lru_cache(maxsize=1)
def case():
    s_j = dataclasses.replace(jax_tiny_model(with_lidar=False), compute_dtype="float32")
    base = jax_tiny_model(with_camera=False)
    t_j = dataclasses.replace(base, compute_dtype="float32",
                              lidar_encoder=dataclasses.replace(base.lidar_encoder, **RAISED_CAPS))
    s_p = dataclasses.replace(tiny_model(with_lidar=False), compute_dtype="float32")
    t_p = dataclasses.replace(tiny_model(with_camera=False), compute_dtype="float32")
    batch = dict(train_batch_np(s_p, B=2, seed=5), **point_batch(t_p, 2, 1500, seed=6))
    s_params, s_stats = jax_params(s_j, batch, seed=8)
    kw = jax_steps.model_inputs(jax.tree.map(jnp.asarray, batch), t_j, training=False)
    shapes = jax.eval_shape(lambda: JaxModel(t_j).init(jax.random.PRNGKey(0), **kw, train=False))
    rng = np.random.RandomState(9)
    t_params, t_stats = randomize(shapes["params"], rng), randomize(shapes["batch_stats"], rng)
    t_params["det_head"]["out_kernel"] = t_params["det_head"]["out_kernel"] * np.float32(0.05)
    return (s_j, t_j, s_p, t_p), (s_params, s_stats, t_params, t_stats), batch


@functools.lru_cache(maxsize=1)
def jax_step():
    (s_j, t_j, _, _), (s_params, s_stats, t_params, t_stats), batch = case()
    tx = capturing(jax_make_optimizer(LR, WD, CLIP))
    state = create_train_state({"params": s_params, "batch_stats": s_stats}, tx)
    student, teacher = JaxModel(s_j), JaxModel(t_j)
    step = jax.jit(lambda st, b: jax_steps.distill_train_step(
        st, t_params, t_stats, b, student, teacher, tx, s_j, t_j, JAX_VARIANTS[PAIR]))
    new_state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, (new_state.params, new_state.batch_stats, metrics,
                                     new_state.opt_state[0]))


@functools.lru_cache(maxsize=1)
def port_step():
    (_, _, s_p, t_p), (s_params, s_stats, t_params, t_stats), batch = case()
    student = BEVFusionCenterHead(s_p)
    student.load_state_dict(state_dict_from_jax(s_params, s_stats, s_p), strict=True)
    teacher = BEVFusionCenterHead(t_p)
    teacher.load_state_dict(state_dict_from_jax(t_params, t_stats, t_p), strict=True)
    teacher.requires_grad_(False)
    teacher_before = {k: v.clone() for k, v in teacher.state_dict().items()}
    opt = make_optimizer(student, TrainConfig(lr=LR))
    metrics = distill_train_step(TrainState(), batch, student, teacher, opt, s_p, t_p, DISTILL_VARIANTS[PAIR])
    norm = metrics["grad_norm"].item()
    grads = {k: p.grad * max(1.0, norm / CLIP) for k, p in student.named_parameters()}
    return student, teacher, teacher_before, metrics_to_host(metrics), grads


def test_train_batch_carries_both_modalities_and_scene_boxes():
    """`train_batch`: the student's camera batch, the teacher's clouds, and
    the scenes' cars and pedestrians standing on the ground as GT boxes."""
    s_cfg, t_cfg = tiny_model(with_lidar=False), tiny_model(with_camera=False)
    b = train_batch(s_cfg, t_cfg, 2, seed=3)
    assert b["imgs"].shape == (2, 2, 32, 64, 3) and b["points"].shape == (2, 4096, 5)
    np.testing.assert_array_equal(b["points"], lidar_batch(t_cfg, 2, 3)["points"])
    gt = b["gt_boxes"]
    assert gt.shape == (2, s_cfg.caps.max_gt_boxes, 10) and gt.dtype == np.float32
    real = np.abs(gt).sum(-1) > 0
    assert real.all()  # 15+ cars and 8+ pedestrians fill the 16 rows of the tiny config
    assert set(np.unique(gt[..., 9])) <= {CLASS_TO_IDX["car"], CLASS_TO_IDX["pedestrian"]}
    np.testing.assert_allclose(gt[..., 2], -1.84 + gt[..., 5] / 2, rtol=1e-6)
    assert (np.hypot(gt[..., 0], gt[..., 1]) < 45.5).all()
    full = train_batch(s_cfg, dataclasses.replace(t_cfg, caps=dataclasses.replace(t_cfg.caps, max_gt_boxes=128)), 1, 3)
    assert distill_exp(*PAIR).distill == DISTILL_VARIANTS[PAIR] and distill_exp(*PAIR).train.lr == 2e-4
    assert full["gt_boxes"].shape == (1, 16, 10)  # the student's cap rules


def test_distill_losses_match_jax():
    _, _, ref, _ = jax_step()
    _, _, _, got, _ = port_step()
    for k in ("loss", "loss_det", "loss_feature", "loss_bev_rel", "loss_resp_cls", "loss_resp_reg"):
        assert np.isfinite(got[k]) and got[k] > 0, k
    for k, v in ref.items():
        np.testing.assert_allclose(got[k], float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    w = DISTILL_VARIANTS[PAIR]
    total = got["loss_det"] + w.w_feature * got["loss_feature"] + w.w_rel * got["loss_bev_rel"] \
        + w.w_resp * (got["loss_resp_cls"] + got["loss_resp_reg"])
    np.testing.assert_allclose(got["loss"], total, rtol=1e-6)


def test_distill_student_gradients_match_jax():
    (_, _, s_p, _), _, _ = case()
    _, _, _, ref_grads = jax_step()
    _, _, _, _, grads = port_step()
    ref = state_dict_from_jax(ref_grads, {}, s_p)
    assert set(ref) == set(grads)
    scales = grad_scales(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(grads[k].numpy() / scales[k], r.numpy() / scales[k], atol=2e-3,
                                   err_msg=f"grad {k}")


def test_distill_batch_stats_match_jax():
    (_, _, s_p, _), _, _ = case()
    ref_params, ref_stats, _, _ = jax_step()
    student, _, _, _, _ = port_step()
    ref = state_dict_from_jax(ref_params, ref_stats, s_p)
    got = student.state_dict()
    for k, r in ref.items():
        if k.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)


def test_teacher_stays_frozen():
    _, teacher, before, _, _ = port_step()
    assert not teacher.training
    for k, v in teacher.state_dict().items():
        assert torch.equal(v, before[k]), k
    assert all(p.grad is None for p in teacher.parameters())
