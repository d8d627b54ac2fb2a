"""The port's LiDAR detector against the JAX package, end to end.

JAX parameters are shaped by `jax.eval_shape(model.init, ...)` and filled
from a numpy seed (`randomize`), go into the JAX model as they are and into
the port through `state_dict_from_jax`; the same numpy point clouds then run
through JAX `eval_step` and the port's `eval_step` / `Detector.predict`.

Float32 on the CPU at `tiny_model(with_camera=False)` shapes. The JAX
encoder is its default, `encoder_impl="chunked"`, with its fixed-shape stage
caps raised so that none binds (the port keeps every site). Tolerances: the
encoder's BEV map at rtol 1e-4 and atol 1e-4 of the map's range (21 sparse
convs summed in another order); the BEV backbone and heads as for the camera
detector (rtol 1e-3, atol 3e-3); the ROI masks and labels exactly, boxes
and scores at rtol 1e-3, atol 3e-3.
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

from unidistill_torch.configs.nuscenes import tiny_model
from unidistill_torch.layers.lidar_encoder import build_rulebooks, stage_shapes
from unidistill_torch.models.bevfusion import BEVFusionCenterHead
from unidistill_torch.serving.predictor import Detector
from unidistill_torch.training.jax_weights import state_dict_from_jax
from unidistill_torch.training.steps import eval_step, model_inputs

from tests.test_torch_weights import randomize

RTOL, ATOL_HEAD = 1e-3, 3e-3
BATCH = 2
# JAX stage caps (s2, s3, s4, s5 sites; s0 slots; columns) that no stage of
# these clouds reaches
RAISED_CAPS = dict(stage_voxel_caps=(6144, 4096, 2048, 2048), s0_slot_cap=4096,
                   stage_col_caps=(6144, 6144, 4096, 2048, 2048))


def nhwc(t: torch.Tensor) -> np.ndarray:
    return t.permute(0, 2, 3, 1).numpy()


def point_batch(cfg, B: int, n: int, seed: int):
    """Ground returns plus vertical structures, as the JAX encoder tests use."""
    rng = np.random.RandomState(seed)
    P = cfg.caps.max_points
    pts = np.zeros((B, P, 5), np.float32)
    pts[:, :n, 0:2] = rng.uniform(-50, 50, (B, n, 2))
    pts[:, :n, 2] = rng.uniform(-3.5, -2.5, (B, n))
    pts[:, : n // 4, 2] = rng.uniform(-3, 2, (B, n // 4))
    pts[:, :n, 3] = rng.uniform(0, 255, (B, n))
    pts[:, :n, 4] = rng.choice(np.arange(10) * 0.05, (B, n))
    mask = np.zeros((B, P), bool)
    mask[:, :n] = True
    return dict(points=pts, points_mask=mask)


@functools.lru_cache(maxsize=1)
def case():
    base = jax_tiny_model(with_camera=False)
    jcfg = dataclasses.replace(base, compute_dtype="float32",
                               lidar_encoder=dataclasses.replace(base.lidar_encoder, **RAISED_CAPS))
    pcfg = dataclasses.replace(tiny_model(with_camera=False), compute_dtype="float32")
    batch = point_batch(pcfg, BATCH, 1500, seed=0)
    kw = jax_steps.model_inputs(jax.tree.map(jnp.asarray, batch), jcfg, training=False)
    shapes = jax.eval_shape(lambda: JaxModel(jcfg).init(jax.random.PRNGKey(0), **kw, train=False))
    rng = np.random.RandomState(1)
    params, stats = randomize(shapes["params"], rng), randomize(shapes["batch_stats"], rng)
    # He-scaled kernels under random BN statistics leave head logits of
    # ~30, where sigmoid scores saturate at 1.0 and tie; scale the output
    # layer down to logits of a few units
    params["det_head"]["out_kernel"] = params["det_head"]["out_kernel"] * np.float32(0.05)
    port_sd = state_dict_from_jax(params, stats, pcfg)
    return jcfg, pcfg, params, stats, port_sd, batch


@functools.lru_cache(maxsize=1)
def jax_outputs():
    jcfg, _, params, stats, _, batch = case()
    model = JaxModel(jcfg)
    jb = jax.tree.map(jnp.asarray, batch)
    kw = jax_steps.model_inputs(jb, jcfg, training=False)
    variables = {"params": params, "batch_stats": stats}
    out = jax.jit(lambda k: model.apply(variables, **k, train=False))(kw)

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


def test_no_jax_stage_cap_binds():
    _, pcfg, _, _, _, batch = case()
    kw = model_inputs(batch, pcfg, "cpu", training=False)
    rb = build_rulebooks(kw["voxel_feats"], kw["voxel_coords"], stage_shapes(pcfg.grid_size))
    sites = [torch.bincount(st.coords[:, 0], minlength=BATCH).max().item() for st in rb.sites]
    assert sites[0] < RAISED_CAPS["s0_slot_cap"]
    assert all(n < cap for n, cap in zip(sites[1:], RAISED_CAPS["stage_voxel_caps"])), sites
    # every stage is populated, so the comparison reaches the last conv
    assert min(sites) > 50, sites


def test_forward_matches_jax():
    _, pcfg, _, _, _, batch = case()
    ref, _ = jax_outputs()
    with torch.no_grad():
        out = port_model()(**model_inputs(batch, pcfg, "cpu", training=False))
    bev = ref["model_output"]
    assert np.abs(bev).max() > 1e-2
    np.testing.assert_allclose(nhwc(out["model_output"]), bev, rtol=1e-4,
                               atol=1e-4 * np.abs(bev).max(), err_msg="LiDAR BEV map")
    np.testing.assert_allclose(nhwc(out["bev_feature"]), ref["bev_feature"],
                               rtol=RTOL, atol=ATOL_HEAD, err_msg="BEV backbone feature")
    for tid, r in enumerate(ref["multi_head_features"]):
        assert set(out["multi_head_features"][tid]) == set(r)
        for name, v in r.items():
            np.testing.assert_allclose(nhwc(out["multi_head_features"][tid][name]), v,
                                       rtol=RTOL, atol=ATOL_HEAD, err_msg=f"task{tid}/{name}")


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
    _assert_rois_equal(eval_step(port_model(), batch, pcfg), ref)
    assert (ref["mask"].sum(1) > 0).all()  # the comparison reaches the NMS


@pytest.mark.parametrize("mode", ["points", "host_voxels"])
def test_detector_predict_matches_jax(mode):
    _, pcfg, _, _, port_sd, batch = case()
    _, ref = jax_outputs()
    det = Detector(pcfg, port_sd, device="cpu")
    if mode == "host_voxels":
        kw = model_inputs(batch, pcfg, "cpu", training=False)
        batch = {k: v.numpy() for k, v in kw.items()}
    _assert_rois_equal(det.predict(batch), ref)


def test_samples_do_not_interact():
    """The batch shares one sorted key space and one launch per conv, but a
    sample's ROIs must not depend on the others: emptying sample 1 leaves
    sample 0's equal and still serves sample 1."""
    _, pcfg, _, _, port_sd, batch = case()
    det = Detector(pcfg, port_sd, device="cpu")
    full = det.predict(batch)
    emptied = det.predict(dict(batch, points_mask=batch["points_mask"] & (np.arange(BATCH) == 0)[:, None]))
    for k in full:
        torch.testing.assert_close(emptied[k][0], full[k][0], rtol=1e-5, atol=1e-5)
        assert torch.isfinite(emptied[k][1].float()).all()


def test_detector_rejects_wrong_lidar_batches():
    _, pcfg, _, _, port_sd, batch = case()
    det = Detector(pcfg, port_sd, device="cpu")
    with pytest.raises(ValueError, match="points"):
        det.predict(dict(batch, points=batch["points"][..., :4]))
    with pytest.raises(ValueError, match="points_mask"):
        det.predict(dict(batch, points_mask=batch["points_mask"][:, :-1]))
    with pytest.raises(ValueError, match="voxel_coords"):
        det.predict(dict(voxel_feats=np.zeros((2, 8, 5), np.float32),
                         voxel_coords=np.zeros((2, 8, 3), np.float32)))


def test_fusion_model_builds_both_encoders_and_fuses():
    """With both modalities the model holds both encoders and the fusion
    encoder, and its `model_output` is the fused [B, 256, ny, nx] map."""
    cfg = dataclasses.replace(tiny_model(), compute_dtype="float32")
    model = BEVFusionCenterHead(cfg).eval()
    assert {"lidar_encoder", "camera_encoder", "fusion_encoder"} <= dict(model.named_children()).keys()
    _, _, _, _, port_sd, batch = case()
    lidar_sd = {k: v for k, v in port_sd.items() if k.startswith("lidar_encoder.")}
    model.load_state_dict(lidar_sd, strict=False)
    from tests.test_torch_camera_detector import camera_batch
    kw = model_inputs(dict(batch, **camera_batch(cfg, BATCH, seed=3)), cfg, "cpu", training=False)
    calls = []
    model.fusion_encoder.register_forward_hook(lambda m, args, out: calls.append((args, out)))
    with torch.no_grad():
        out = model(**kw)
    (lidar_map, camera_map), fused = calls[0]
    assert lidar_map.shape == camera_map.shape == (BATCH, 256, 10, 10)
    with torch.no_grad():
        assert torch.equal(lidar_map, port_model()(**model_inputs(batch, case()[1], "cpu", training=False))["model_output"])
    assert torch.equal(out["model_output"], fused) and fused.shape == (BATCH, 256, 10, 10)
