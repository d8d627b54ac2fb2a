"""The port's camera train step against the JAX package.

JAX parameters are shaped by `jax.eval_shape(model.init, ...)` and drawn
from a numpy seed (`tests/test_torch_weights.randomize`: He-scaled kernels);
they go into the JAX model as they are and into the port through
`state_dict_from_jax`. One numpy batch (images, the golden test's camera
matrices, GT boxes) then runs through JAX `train_step` and the port's
`train_step`, float32 on the CPU at `tiny_model(with_lidar=False)` shapes.
JAX gradients, parameters and batch statistics are mapped onto the port's
names by `state_dict_from_jax` (its layout transforms are linear, so
gradients map as weights do).

Conditioning. A random BN-ReLU network in train mode at these batch sizes
is chaotic: in the port alone, a relative change of 1e-7 (one float32
rounding) at the ResNet stem moves some weight gradients by 40% of their
tensor's max. The two frameworks round their convolutions differently, so
their gradients cannot agree there. `tame` scales every BatchNorm scale by
0.3 and shifts its bias by +1, so nearly every ReLU passes; the same 1e-7 change
then moves no gradient by more than about 1e-5 of its scale. The code path
is the same.

Tolerances:
  * loss and every metric rtol 1e-4;
  * every parameter's gradient within 2e-3 of its scale, the larger of the
    tensor's max |g| and 1e-3 of the largest |g| of any tensor (some true
    gradients are 0, e.g. a conv bias before a BatchNorm, and their max is
    round-off); the global norm rtol 1e-4;
  * updated BatchNorm statistics rtol 1e-4, atol 1e-5 (batch means of
    activations that agree to about 1e-5);
  * the one-step parameter change, where |g| > 1e-3 of its scale, within
    1e-2·lr; elsewhere within 2·lr: Adam's first update is ≈ −lr·sign(g),
    and a gradient near round-off may take either sign.
The optimizer alone is held to optax over three steps (rtol 1e-6).

Also here, a test for each fault of the serving slices that only training
shows: BatchNorm momenta, the biased running variance, float32 master
weights (the K1 gradient on the card is in tests/test_torch_kernels_cuda.py).
"""
import dataclasses
import functools

import numpy as np
import optax
import pytest
import torch
from torch import nn

import jax
import jax.numpy as jnp

from unidistill_tpu.configs.nuscenes import tiny_model as jax_tiny_model
from unidistill_tpu.layers.center_head import CenterHead as JaxHead
from unidistill_tpu.layers.lidar_encoder import SparseBasicBlockDense as JaxDenseBlock
from unidistill_tpu.models.bevfusion import BEVFusionCenterHead as JaxModel
from unidistill_tpu.training import steps as jax_steps
from unidistill_tpu.training.train_state import create_train_state, make_optimizer as jax_make_optimizer

from unidistill_torch.configs.nuscenes import TrainConfig, tiny_model
from unidistill_torch.layers.center_head import CenterHead
from unidistill_torch.layers.lidar_encoder import SparseBasicBlock
from unidistill_torch.models.bevfusion import BEVFusionCenterHead
from unidistill_torch.ops.sparse_conv import from_voxels, subm_rules
from unidistill_torch.serving.synthetic import calibrate_batchnorm, lidar_batch, random_state_dict
from unidistill_torch.training.jax_weights import state_dict_from_jax
from unidistill_torch.training.steps import metrics_to_host, model_inputs, train_step
from unidistill_torch.training.train_state import Optimizer, TrainState, make_optimizer

from tests.test_torch_assigner_losses import random_gt
from tests.test_torch_camera_detector import camera_batch
from tests.test_torch_weights import init, nchw, port_module, randomize

LR, WD, CLIP = 2e-4, 1e-7, 0.1


def train_batch_np(cfg, B, seed):
    batch = camera_batch(cfg, B, seed)
    batch["gt_boxes"] = random_gt(np.random.RandomState(seed), B, cfg.caps.max_gt_boxes, 4, 12, span=45.0)
    return batch


@functools.lru_cache(maxsize=1)
def case():
    jcfg = dataclasses.replace(jax_tiny_model(with_lidar=False), compute_dtype="float32")
    pcfg = dataclasses.replace(tiny_model(with_lidar=False), compute_dtype="float32")
    batch = train_batch_np(pcfg, B=2, seed=3)
    params, stats = jax_params(jcfg, batch, seed=7)
    return jcfg, pcfg, params, stats, batch


def jax_shapes(jcfg, batch):
    """Shapes of the JAX model's `init` trees (`jax.eval_shape`)."""
    kw = jax_steps.model_inputs(jax.tree.map(jnp.asarray, batch), jcfg, training=False)
    return jax.eval_shape(lambda: JaxModel(jcfg).init(jax.random.PRNGKey(0), **kw, train=False))


def jax_params(jcfg, batch, seed, shapes=None):
    """Seeded JAX parameter and statistics trees of the model of `jcfg`
    (of `shapes`, when given); the head's output layer is scaled to logits
    of a few units, and the AWL parameters lie near their initial 1."""
    shapes = shapes or jax_shapes(jcfg, batch)
    rng = np.random.RandomState(seed)
    params, stats = randomize(shapes["params"], rng), randomize(shapes["batch_stats"], rng)
    params["det_head"]["out_kernel"] = params["det_head"]["out_kernel"] * np.float32(0.05)
    params["awl_params"] = rng.uniform(0.8, 1.2, np.shape(params["awl_params"])).astype(np.float32)
    return tame(params), stats


def tame(tree):
    """BatchNorm scales × 0.3 and biases + 1 (see the module docstring)."""
    if "scale" in tree:
        return dict(tree, scale=tree["scale"] * np.float32(0.3), bias=tree["bias"] + np.float32(1.0))
    return {k: tame(v) if isinstance(v, dict) else v for k, v in tree.items()}


def grad_scales(grads):
    """Per tensor: max(max |g|, 1e-3 · the largest |g| of any tensor)."""
    top = max(float(np.abs(np.asarray(g)).max()) for g in grads.values())
    return {k: max(float(np.abs(np.asarray(g)).max()), 1e-3 * top) for k, g in grads.items()}


def capturing(tx):
    """`tx` that also keeps the gradients it was given in its state, so that
    a JAX step's gradients can be read from the state it returns."""
    def init(params):
        return jax.tree.map(jnp.zeros_like, params), tx.init(params)

    def update(grads, state, params=None):
        updates, inner = tx.update(grads, state[1], params)
        return updates, (grads, inner)
    return optax.GradientTransformation(init, update)


@functools.lru_cache(maxsize=1)
def jax_step():
    """JAX train_step: new params, new batch stats, metrics, gradients."""
    jcfg, _, params, stats, batch = case()
    model = JaxModel(jcfg)
    tx = capturing(jax_make_optimizer(LR, WD, CLIP))
    state = create_train_state({"params": params, "batch_stats": stats}, tx)
    step = jax.jit(lambda st, b: jax_steps.train_step(st, b, model, tx, jcfg))
    new_state, metrics = step(state, jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, (new_state.params, new_state.batch_stats, metrics,
                                     new_state.opt_state[0]))


@functools.lru_cache(maxsize=1)
def port_step():
    _, pcfg, params, stats, batch = case()
    model = BEVFusionCenterHead(pcfg)
    model.load_state_dict(state_dict_from_jax(params, stats, pcfg), strict=True)
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    opt = make_optimizer(model, TrainConfig(lr=LR))
    state = TrainState()
    metrics = train_step(state, batch, model, opt, pcfg)
    norm = metrics["grad_norm"].item()
    unclip = max(1.0, norm / CLIP)  # the step leaves the clipped gradients in .grad
    grads = {k: p.grad * unclip for k, p in model.named_parameters()}
    return model, before, metrics_to_host(metrics), grads, state


def check_metrics(metrics, ref_metrics, ref_grads):
    """Loss and every metric rtol 1e-4; the global gradient norm too, and
    the clip acts."""
    for k, v in ref_metrics.items():
        np.testing.assert_allclose(metrics[k], float(v), rtol=1e-4, atol=1e-6, err_msg=k)
    assert metrics["loss"] > 0 and sum(metrics[f"task_{t}/num_positive"] for t in range(6)) > 0
    ref_norm = np.sqrt(sum(np.sum(np.square(g)) for g in jax.tree.leaves(ref_grads)))
    np.testing.assert_allclose(metrics["grad_norm"], ref_norm, rtol=1e-4)
    assert ref_norm > CLIP  # the clip acts


def check_gradients(grads, ref):
    """Every gradient within 2e-3 of its scale; `ref` in the port's names."""
    assert set(ref) == set(grads)
    scales = grad_scales(ref)
    for k, r in ref.items():
        np.testing.assert_allclose(grads[k].numpy() / scales[k], r.numpy() / scales[k], atol=2e-3,
                                   err_msg=f"grad {k}")
    # the grouped out conv's unused output columns get no gradient on either side
    assert np.abs(ref["det_head.out_conv.weight"].numpy()).max() > 0


def check_batch_stats(model, before, ref):
    """Every BatchNorm moved by its own momentum towards the biased batch
    variance, as the JAX step's statistics."""
    got = model.state_dict()
    n = 0
    for k, r in ref.items():
        if k.endswith(("running_mean", "running_var")):
            assert not torch.equal(got[k], before[k]), k
            np.testing.assert_allclose(got[k].numpy(), r.numpy(), rtol=1e-4, atol=1e-5, err_msg=k)
            n += 1
    assert n == 2 * len([m for m in model.modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)])


def check_one_step(model, before, new_ref, g_ref, lr, min_moved=0.75):
    """The one-step parameter change (see the module docstring); at least
    `min_moved` of the tensors took an Adam step of lr/2 or more."""
    scales = grad_scales(g_ref)
    moved = 0
    for k, p in model.named_parameters():
        d_got = (p.detach() - before[k]).numpy()
        d_ref = (new_ref[k] - before[k]).numpy()
        moved += np.abs(d_ref).max() > 0.5 * lr
        big = np.abs(g_ref[k].numpy()) > 1e-3 * scales[k]
        err = np.abs(d_got - d_ref)
        assert err[big].max(initial=0) <= 1e-2 * lr, (k, err[big].max())
        assert err.max() <= 2 * lr * (1 + 1e-3), (k, err.max())
    assert moved > min_moved * len(g_ref)  # most tensors took an Adam step (some true gradients are 0)


def test_loss_and_metrics_match_jax():
    _, _, ref_metrics, ref_grads = jax_step()
    _, _, metrics, _, state = port_step()
    assert state.step == 1
    check_metrics(metrics, ref_metrics, ref_grads)


def test_gradients_match_jax():
    _, pcfg, _, _, _ = case()
    _, _, _, ref_grads = jax_step()
    _, _, _, grads, _ = port_step()
    check_gradients(grads, state_dict_from_jax(ref_grads, {}, pcfg))


def test_batch_stats_match_jax():
    """Every BatchNorm moved by its own momentum towards the biased batch
    variance (ResNet and head flax 0.9, SECONDFPN and BEV backbone 0.99)."""
    _, pcfg, _, _, _ = case()
    ref_params, ref_stats, _, _ = jax_step()
    model, before, _, _, _ = port_step()
    check_batch_stats(model, before, state_dict_from_jax(ref_params, ref_stats, pcfg))


def test_one_step_parameters_match_jax():
    _, pcfg, _, _, _ = case()
    ref_params, _, _, ref_grads = jax_step()
    model, before, _, _, _ = port_step()
    check_one_step(model, before, state_dict_from_jax(ref_params, {}, pcfg),
                   state_dict_from_jax(ref_grads, {}, pcfg), LR)


# ---------------------------------------------------------------------------
# the optimizer alone, against optax
# ---------------------------------------------------------------------------


class TwoModules(nn.Module):
    def __init__(self, rng):
        super().__init__()
        p = lambda *s: nn.Parameter(torch.from_numpy(rng.randn(*s).astype(np.float32)))
        self.a = nn.ParameterDict(dict(w=p(3, 4)))
        self.b = nn.ParameterDict(dict(w=p(5), v=p(2, 2)))


def test_optimizer_matches_optax_over_three_steps():
    """Fixed gradients, milestones at steps 1 and 2 (the lr falls twice),
    `lr_scale_factor` on one module; the clip acts in steps 0 and 1 and not
    in step 2."""
    rng = np.random.RandomState(0)
    net = TwoModules(rng)
    params = {"a": {"w": net.a.w.detach().numpy().copy()},
              "b": {"w": net.b.w.detach().numpy().copy(), "v": net.b.v.detach().numpy().copy()}}
    grads = [jax.tree.map(lambda x: (s * rng.randn(*x.shape)).astype(np.float32), params)
             for s in (1.0, 0.3, 0.001)]
    kw = dict(milestones_epochs=(1, 2), gamma=0.5, steps_per_epoch=1, lr_scale_factor={"b": 0.1})
    tx = jax_make_optimizer(1e-2, 1e-2, CLIP, **kw)
    jp, opt_state = jax.tree.map(jnp.asarray, params), None
    opt_state = tx.init(jp)
    opt = Optimizer(net, 1e-2, 1e-2, CLIP, **kw)
    norms = []
    for step, g in enumerate(grads):
        upd, opt_state = tx.update(jax.tree.map(jnp.asarray, g), opt_state, jp)
        jp = optax.apply_updates(jp, upd)
        net.a.w.grad = torch.from_numpy(g["a"]["w"])
        net.b.w.grad, net.b.v.grad = torch.from_numpy(g["b"]["w"]), torch.from_numpy(g["b"]["v"])
        norms.append(opt.step(step).item())
        for name, t in (("a", net.a.w), ("b", net.b.w)):
            np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[name]["w"]), rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {name}")
        np.testing.assert_allclose(net.b.v.detach().numpy(), np.asarray(jp["b"]["v"]), rtol=1e-6, atol=1e-7)
    assert norms[0] > CLIP and norms[1] > CLIP and norms[2] < CLIP
    assert [opt.lr(s) for s in range(3)] == [1e-2, 5e-3, 2.5e-3]


# ---------------------------------------------------------------------------
# faults of the serving slices that only training shows
# ---------------------------------------------------------------------------

FLAX_MOMENTUM = {"img_backbone": 0.9, "det_head": 0.9, "img_neck": 0.99, "bev_encoder": 0.99,
                 "lidar_encoder": 0.99, "fusion_encoder": 0.9}


@pytest.mark.parametrize("modality", ["camera", "lidar", "fusion"])
def test_batchnorm_momenta_are_the_jax_modules(modality):
    """Every BatchNorm carries the flax momentum of the JAX module it
    mirrors (torch's momentum = 1 − flax's), and BN calibration puts it
    back."""
    cfg = tiny_model(with_lidar=modality != "camera", with_camera=modality != "lidar")
    model = BEVFusionCenterHead(cfg)
    model.load_state_dict(random_state_dict(cfg, seed=0))

    def check():
        bns = [(n, m) for n, m in model.named_modules() if isinstance(m, nn.modules.batchnorm._BatchNorm)]
        assert len(bns) > 10
        for name, m in bns:
            key = next(k for k in FLAX_MOMENTUM if f".{k}." in f".{name}.")
            assert m.momentum == pytest.approx(1 - FLAX_MOMENTUM[key], abs=1e-12), name

    check()
    batch = {}
    if cfg.with_camera:
        batch.update(camera_batch(cfg, 2, 1))
    if cfg.with_lidar:
        batch.update(lidar_batch(cfg, 2, 2))
    calibrate_batchnorm(model, model_inputs(batch, cfg, "cpu", training=False))
    check()


def test_center_head_train_statistics_match_jax():
    """At n = 2·3·3 = 18 values per channel the unbiased variance torch
    would put into the running statistics is 6% above flax's biased one."""
    x = np.random.RandomState(4).randn(2, 3, 3, 16).astype(np.float32)
    cfg = tiny_model(with_lidar=False)
    jm = JaxHead(cfg.tasks, cfg.det_head.common_heads, dtype=jnp.float32)
    p, s = init(jm, jnp.asarray(x))
    _, upd = jm.apply({"params": p, "batch_stats": s}, jnp.asarray(x), train=True, mutable=["batch_stats"])
    mod = port_module(CenterHead(16, cfg.tasks, cfg.det_head.common_heads), p, s, "det_head").train()
    mod(nchw(x))
    for name in ("shared_bn", "branches_bn0"):
        bn = getattr(mod, name)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"][name]["var"]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"][name]["mean"]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_sparse_block_train_statistics_match_jax():
    """The LiDAR MaskedBatchNorms in training: flax momentum 0.99 and the
    biased variance over the active voxels."""
    B, shape, C = 2, (5, 6, 7), 16
    rng = np.random.RandomState(7)
    occ = rng.rand(B, *shape) < 0.35
    x = np.where(occ[..., None], rng.randn(B, *shape, C), 0).astype(np.float32)
    jm = JaxDenseBlock(C, dtype=jnp.float32)
    p, s = init(jm, jnp.asarray(x), jnp.asarray(occ))
    _, upd = jm.apply({"params": p, "batch_stats": s}, jnp.asarray(x), jnp.asarray(occ), train=True,
                      mutable=["batch_stats"])
    V = int(occ.reshape(B, -1).sum(1).max())
    coords = np.full((B, V, 3), -1, np.int32)
    feats = np.zeros((B, V, C), np.float32)
    for b in range(B):
        zyx = np.argwhere(occ[b])
        coords[b, : len(zyx)] = zyx
        feats[b, : len(zyx)] = x[b][tuple(zyx.T)]
    st = from_voxels(torch.from_numpy(feats), torch.from_numpy(coords), shape)
    block = port_module(SparseBasicBlock(C), p, s, "lidar_encoder.backbone_3d.res1a",
                        dataclasses.replace(tiny_model(with_camera=False), compute_dtype="float32")).train()
    with torch.no_grad():
        block(st.features, subm_rules(st))
    for name in ("bn1", "bn2"):
        bn = getattr(block, name)
        np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(upd["batch_stats"][name]["var"]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)
        np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(upd["batch_stats"][name]["mean"]),
                                   rtol=1e-5, atol=1e-7, err_msg=name)


def test_parameters_are_float32_masters():
    """A bf16 model holds float32 parameters, so an AdamW step smaller than
    a bf16 ulp of the weight is kept; and its forward equals that of a model
    whose weights were rounded to bf16 first (what serving computed before):
    the cast happens at each convolution's call."""
    cfg = tiny_model(with_lidar=False)
    assert cfg.compute_dtype == "bfloat16"
    model = BEVFusionCenterHead(cfg)
    sd = random_state_dict(cfg, seed=1)
    model.load_state_dict(sd)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    rounded = BEVFusionCenterHead(cfg)
    rounded.load_state_dict({k: v.to(torch.bfloat16).float() if k.endswith("weight") and v.dim() > 1 else v
                             for k, v in sd.items()})
    batch = camera_batch(cfg, 2, 1)
    with torch.no_grad():
        a = model.eval()(**model_inputs(batch, cfg, "cpu", training=False))
        b = rounded.eval()(**model_inputs(batch, cfg, "cpu", training=False))
    for tid, heads in enumerate(a["multi_head_features"]):
        for name, t in heads.items():
            assert torch.equal(t, b["multi_head_features"][tid][name]), (tid, name)
    w = model.det_head.shared_conv.weight
    w.data.fill_(0.5)  # a bf16 ulp of 0.5 is 2^-8, far above one step of lr 2e-4
    opt = Optimizer(model, LR, 0.0, CLIP)
    for p in model.parameters():
        p.grad = torch.zeros_like(p)
    w.grad = torch.ones_like(w)
    opt.step(0)
    np.testing.assert_allclose(w.detach().numpy(), 0.5 - LR, rtol=1e-6)
