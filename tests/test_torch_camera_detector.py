"""The port's camera detector against the JAX package, end to end.

One random reference-named state dict (tests/test_torch_import_full.py)
goes into the JAX model through `training/torch_import.convert_state_dict`
and into the port through `unidistill_torch.training.jax_weights
.state_dict_from_jax`; the same numpy batch then runs through JAX
`eval_step` and the port's `eval_step` / `Detector(device="cpu").predict`.

Float32 on the CPU at `tiny_model(with_lidar=False)` shapes. Tolerances are
those of tests/test_full_model_golden.py (rtol 1e-3, atol 2e-3 on the BEV
features, 3e-3 on the BEV backbone and heads): two frameworks sum the same
convolutions in another order. The ROI masks and labels must be equal;
boxes and scores are held at rtol 1e-3, atol 3e-3.
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
from unidistill_tpu.training import steps as jax_steps
from unidistill_tpu.training.torch_import import convert_state_dict

from unidistill_torch.configs.nuscenes import tiny_model
from unidistill_torch.models.bevfusion import BEVFusionCenterHead
from unidistill_torch.serving.predictor import Detector
from unidistill_torch.training.jax_weights import state_dict_from_jax
from unidistill_torch.training.steps import eval_step, model_inputs

from tests.test_full_model_golden import _rich_mats
from tests.test_torch_import_full import build_reference_state_dict

RTOL, ATOL_BEV, ATOL_HEAD = 1e-3, 2e-3, 3e-3


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def camera_batch(cfg, B: int, seed: int):
    """Normalised random images with the rich camera matrices of the golden
    test (frustum points land well inside BEV cells)."""
    rng = np.random.RandomState(seed)
    n = cfg.camera_encoder.num_cams
    H, W = cfg.camera_encoder.final_dim
    return dict(imgs=rng.randn(B, n, H, W, 3).astype(np.float32),
                mats=_rich_mats(B, n, H, W))


@functools.lru_cache(maxsize=1)
def case():
    jcfg = dataclasses.replace(jax_tiny_model(with_lidar=False), compute_dtype="float32")
    pcfg = dataclasses.replace(tiny_model(with_lidar=False), compute_dtype="float32")
    sd = build_reference_state_dict(jax_tiny_model(), rng=np.random.RandomState(7))
    params, stats = convert_state_dict(sd, jcfg)
    port_sd = state_dict_from_jax(params, stats, pcfg)
    batch = camera_batch(pcfg, B=2, seed=3)
    return jcfg, pcfg, params, stats, port_sd, batch


@functools.lru_cache(maxsize=1)
def jax_outputs():
    jcfg, _, params, stats, _, batch = case()
    model = JaxModel(jcfg)
    jb = jax.tree.map(jnp.asarray, batch)
    kw = jax_steps.model_inputs(jb, jcfg, training=False)
    variables = {"params": params, "batch_stats": stats}
    out = jax.jit(lambda: model.apply(variables, **kw, train=False))()

    class State:
        pass

    state = State()
    state.params, state.batch_stats = params, stats
    rois = jax.jit(lambda b: jax_steps.eval_step(state, b, model, jcfg))(jb)
    return jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, rois)


def port_model():
    _, pcfg, _, _, port_sd, _ = case()
    model = BEVFusionCenterHead(pcfg)
    model.load_state_dict(port_sd, strict=True)
    return model.eval()


def test_forward_matches_jax():
    _, pcfg, _, _, _, batch = case()
    ref, _ = jax_outputs()
    with torch.no_grad():
        out = port_model()(**model_inputs(batch, pcfg, "cpu", training=False))
    np.testing.assert_allclose(nhwc(out["model_output"]), ref["model_output"],
                               rtol=RTOL, atol=ATOL_BEV, err_msg="camera BEV feature")
    np.testing.assert_allclose(nhwc(out["bev_feature"]), ref["bev_feature"],
                               rtol=RTOL, atol=ATOL_HEAD, err_msg="BEV backbone feature")
    assert len(out["multi_head_features"]) == len(ref["multi_head_features"])
    for tid, r in enumerate(ref["multi_head_features"]):
        assert set(out["multi_head_features"][tid]) == set(r)
        for name, v in r.items():
            np.testing.assert_allclose(nhwc(out["multi_head_features"][tid][name]), v,
                                       rtol=RTOL, atol=ATOL_HEAD, err_msg=f"task{tid}/{name}")
    np.testing.assert_array_equal(out["awl_params"].detach().numpy(), ref["awl_params"])
    # the case is not degenerate: the camera BEV map carries signal
    assert np.abs(ref["model_output"]).max() > 1e-2


def _assert_rois_equal(got, ref):
    assert set(got) == {"boxes", "scores", "labels", "mask"}
    for k in got:
        assert tuple(got[k].shape) == ref[k].shape, k
    np.testing.assert_array_equal(got["mask"].numpy(), ref["mask"])
    np.testing.assert_array_equal(got["labels"].numpy(), ref["labels"])
    np.testing.assert_allclose(got["scores"].numpy(), ref["scores"], rtol=RTOL, atol=ATOL_HEAD)
    np.testing.assert_allclose(got["boxes"].numpy(), ref["boxes"], rtol=RTOL, atol=ATOL_HEAD)


def test_eval_step_matches_jax():
    _, pcfg, _, _, _, batch = case()
    _, ref = jax_outputs()
    got = eval_step(port_model(), batch, pcfg)
    _assert_rois_equal(got, ref)
    # every sample keeps boxes, so the comparison reaches the NMS
    assert (ref["mask"].sum(1) > 0).all()


def test_detector_predict_matches_jax():
    _, pcfg, _, _, port_sd, batch = case()
    _, ref = jax_outputs()
    got = Detector(pcfg, port_sd, device="cpu").predict(batch)
    _assert_rois_equal(got, ref)


def test_detector_rejects_wrong_shapes():
    _, pcfg, _, _, port_sd, batch = case()
    det = Detector(pcfg, port_sd, device="cpu")
    bad = dict(batch, imgs=batch["imgs"][:, :1])
    with pytest.raises(ValueError, match="imgs"):
        det.predict(bad)
    mats = dict(batch["mats"], intrin_mats=batch["mats"]["intrin_mats"][:, :, :3])
    with pytest.raises(ValueError, match="intrin_mats"):
        det.predict(dict(batch, mats=mats))


def test_detector_without_cuda_raises():
    _, pcfg, _, _, port_sd, _ = case()
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        Detector(pcfg, port_sd)


def test_lidar_model_not_ported():
    """Named when a model with the LiDAR encoder raised; with LiDAR on, the
    camera configuration now builds the fusion model: both encoders and the
    fusion encoder (tests/test_torch_fusion.py holds it to JAX)."""
    model = BEVFusionCenterHead(tiny_model(with_lidar=True))
    assert {"lidar_encoder", "camera_encoder", "fusion_encoder"} <= dict(model.named_children()).keys()
