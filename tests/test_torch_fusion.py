"""The port's fusion detector against the JAX package.

`FusionEncoder` alone against the JAX module, in eval and train mode, in
float32 and in bfloat16; then the tiny fusion model (`tiny_model()`, LiDAR
and camera) end to end in float32: its outputs, `eval_step` and
`Detector.predict` ROIs against JAX `eval_step`, with the JAX parameters
shaped by `jax.eval_shape` and drawn from a numpy seed, the JAX stage caps
raised (tests/test_torch_lidar_detector.py) and the golden camera matrices
(tests/test_torch_camera_detector.py).

Tolerances: FusionEncoder in float32 rtol/atol 1e-5 (the same sums in
another order); in bfloat16 3e-2 of the output's range: both frameworks
round x, the gate and the gated x to bf16 at the same places, but the mean
and the two convolutions sum in other orders, and a sum that lands on the
other side of a bf16 rounding moves by one ulp (2^-8 relative) and carries
that through the 3×3 reduce. The model as the LiDAR detector's test: BEV
maps rtol 1e-4 and atol 1e-4 of the range, BEV backbone and heads rtol
1e-3, atol 3e-3; ROI masks and labels exactly, boxes and scores rtol 1e-3,
atol 3e-3.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidistill_tpu.configs.nuscenes import tiny_model as jax_tiny_model
from unidistill_tpu.models.bevfusion import BEVFusionCenterHead as JaxModel
from unidistill_tpu.models.bevfusion import FusionEncoder as JaxFusionEncoder
from unidistill_tpu.training import steps as jax_steps

from unidistill_torch.configs.nuscenes import tiny_model
from unidistill_torch.models.bevfusion import BEVFusionCenterHead, FusionEncoder
from unidistill_torch.serving.predictor import Detector
from unidistill_torch.training.jax_weights import state_dict_from_jax
from unidistill_torch.training.steps import eval_step, model_inputs

from tests.test_torch_camera_detector import camera_batch
from tests.test_torch_lidar_detector import RAISED_CAPS, _assert_rois_equal, nhwc, point_batch
from tests.test_torch_weights import nchw, randomize

RTOL, ATOL_HEAD = 1e-3, 3e-3
BATCH = 2


def fusion_inputs(seed, B=2, H=12, W=10, C=8):
    rng = np.random.RandomState(seed)
    return (rng.randn(B, H, W, C).astype(np.float32) + 0.3,
            np.maximum(rng.randn(B, H, W, C), 0).astype(np.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_fusion_encoder_matches_jax(dtype, train):
    x1, x2 = fusion_inputs(0)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    jm = JaxFusionEncoder(out_channels=16, dtype=jdt)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x1, x2, False))
    rng = np.random.RandomState(1)
    params, stats = randomize(shapes["params"], rng), randomize(shapes["batch_stats"], rng)
    variables = {"params": params, "batch_stats": stats}
    if train:
        ref, upd = jm.apply(variables, x1, x2, True, mutable=["batch_stats"])
    else:
        ref = jm.apply(variables, x1, x2, False)
    ref = np.asarray(ref, np.float32)
    mod = FusionEncoder(16, out_channels=16)
    sd = state_dict_from_jax({"fusion_encoder": params}, {"fusion_encoder": stats}, tiny_model())
    mod.load_state_dict({k.split(".", 1)[1]: v for k, v in sd.items()}, strict=True)
    for m in (mod.att_conv, mod.reduce_conv):
        m.compute_dtype = getattr(torch, dtype)
    mod.train(train)
    got = mod(nchw(x1), nchw(x2))
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    if dtype == "float32":
        np.testing.assert_allclose(nhwc(got.detach()), ref, rtol=1e-5, atol=1e-5)
    else:
        err = np.abs(nhwc(got.detach()) - ref).max() / np.abs(ref).max()
        assert err < 3e-2, err
    if train:
        bn = upd["batch_stats"]["reduce_bn"]
        np.testing.assert_allclose(mod.reduce_bn.running_mean.numpy(), np.asarray(bn["mean"]),
                                   rtol=1e-4 if dtype == "float32" else 3e-2, atol=1e-5)
        np.testing.assert_allclose(mod.reduce_bn.running_var.numpy(), np.asarray(bn["var"]),
                                   rtol=1e-4 if dtype == "float32" else 3e-2, atol=1e-5)


def test_fusion_encoder_concatenates_lidar_first():
    """Channel concat in the order [lidar, camera]: swapping the two inputs
    changes the output."""
    torch.manual_seed(0)
    mod = FusionEncoder(16, out_channels=8).eval()
    a, b = (nchw(x) for x in fusion_inputs(2))
    with torch.no_grad():
        assert not torch.allclose(mod(a, b), mod(b, a))


@functools.lru_cache(maxsize=1)
def case():
    base = jax_tiny_model()
    jcfg = dataclasses.replace(base, compute_dtype="float32",
                               lidar_encoder=dataclasses.replace(base.lidar_encoder, **RAISED_CAPS))
    pcfg = dataclasses.replace(tiny_model(), compute_dtype="float32")
    batch = dict(point_batch(pcfg, BATCH, 1500, seed=0), **camera_batch(pcfg, BATCH, seed=2))
    kw = jax_steps.model_inputs(jax.tree.map(jnp.asarray, batch), jcfg, training=False)
    shapes = jax.eval_shape(lambda: JaxModel(jcfg).init(jax.random.PRNGKey(0), **kw, train=False))
    # the exact ROI comparison needs weights whose decode keeps every score
    # and NMS IoU off its threshold by more than the heads' tolerance: seed
    # 2 does (of seeds 1-8, five put one ROI across a threshold)
    rng = np.random.RandomState(2)
    params, stats = randomize(shapes["params"], rng), randomize(shapes["batch_stats"], rng)
    params["det_head"]["out_kernel"] = params["det_head"]["out_kernel"] * np.float32(0.05)
    return jcfg, pcfg, params, stats, state_dict_from_jax(params, stats, pcfg), batch


@functools.lru_cache(maxsize=1)
def jax_outputs():
    jcfg, _, params, stats, _, batch = case()
    model = JaxModel(jcfg)
    jb = jax.tree.map(jnp.asarray, batch)
    variables = {"params": params, "batch_stats": stats}

    class State:
        pass

    state = State()
    state.params, state.batch_stats = params, stats
    # one compile for the outputs and the eval step's ROIs
    out, rois = jax.jit(lambda b: (
        model.apply(variables, **jax_steps.model_inputs(b, jcfg, training=False), train=False),
        jax_steps.eval_step(state, b, model, jcfg)))(jb)
    return jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, rois)


def port_model():
    _, pcfg, _, _, port_sd, _ = case()
    model = BEVFusionCenterHead(pcfg)
    model.load_state_dict(port_sd, strict=True)
    return model.eval()


def test_fusion_weights_load_strictly():
    """The JAX fusion tree maps onto every parameter and statistic of the
    port's fusion model: both encoders, the fusion encoder, backbone, head."""
    _, pcfg, _, _, port_sd, _ = case()
    model = BEVFusionCenterHead(pcfg)
    assert set(port_sd) == set(model.state_dict())
    assert {"lidar_encoder", "camera_encoder", "fusion_encoder", "bev_encoder", "det_head"} <= \
        {k.split(".")[0] for k in port_sd}
    enc = model.fusion_encoder
    assert tuple(enc.att_conv.weight.shape) == (512, 512, 1, 1) and enc.att_conv.bias is not None
    assert tuple(enc.reduce_conv.weight.shape) == (256, 512, 3, 3) and enc.reduce_conv.bias is None
    assert enc.reduce_bn.momentum == pytest.approx(0.1) and enc.reduce_bn.eps == 1e-5


def test_fusion_forward_matches_jax():
    _, pcfg, _, _, _, batch = case()
    ref, _ = jax_outputs()
    with torch.no_grad():
        out = port_model()(**model_inputs(batch, pcfg, "cpu", training=False))
    fused = ref["model_output"]
    assert fused.shape[-1] == 256 and np.abs(fused).max() > 1e-2
    np.testing.assert_allclose(nhwc(out["model_output"]), fused, rtol=1e-4,
                               atol=1e-4 * np.abs(fused).max(), err_msg="fused BEV map")
    np.testing.assert_allclose(nhwc(out["bev_feature"]), ref["bev_feature"],
                               rtol=RTOL, atol=ATOL_HEAD, err_msg="BEV backbone feature")
    for tid, r in enumerate(ref["multi_head_features"]):
        for name, v in r.items():
            np.testing.assert_allclose(nhwc(out["multi_head_features"][tid][name]), v,
                                       rtol=RTOL, atol=ATOL_HEAD, err_msg=f"task{tid}/{name}")


def test_fusion_eval_step_matches_jax():
    _, pcfg, _, _, _, batch = case()
    _, ref = jax_outputs()
    _assert_rois_equal(eval_step(port_model(), batch, pcfg), ref)
    assert (ref["mask"].sum(1) > 0).all()


@pytest.mark.parametrize("mode", ["points", "host_voxels"])
def test_fusion_detector_predict_matches_jax(mode):
    """The fusion batch contract: points (or loader voxels) plus images and
    camera matrices."""
    _, pcfg, _, _, port_sd, batch = case()
    _, ref = jax_outputs()
    det = Detector(pcfg, port_sd, device="cpu")
    if mode == "host_voxels":
        kw = model_inputs(batch, pcfg, "cpu", training=False)
        batch = dict(imgs=batch["imgs"], mats=batch["mats"], voxel_feats=kw["voxel_feats"].numpy(),
                     voxel_coords=kw["voxel_coords"].numpy())
    _assert_rois_equal(det.predict(batch), ref)


def test_fusion_detector_checks_both_modalities():
    _, pcfg, _, _, port_sd, batch = case()
    det = Detector(pcfg, port_sd, device="cpu")
    with pytest.raises(ValueError, match="points"):
        det.predict(dict(batch, points=batch["points"][..., :4]))
    with pytest.raises(ValueError, match="imgs"):
        det.predict(dict(batch, imgs=batch["imgs"][:, :1]))
    with pytest.raises(ValueError, match="intrin_mats"):
        det.predict(dict(batch, mats=dict(batch["mats"], intrin_mats=batch["mats"]["intrin_mats"][:, :1])))
