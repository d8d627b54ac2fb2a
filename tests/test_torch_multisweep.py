"""Multi-sweep camera input in the port against the JAX package.

  * `LSSFPN` on tests/test_lss_multisweep.py's inputs (tiny camera encoder,
    B 1, S 2, sweeps moved by ego motion): the [B, S·C, ny, nx] map equals
    JAX's (rtol 1e-3, atol 2e-3, the BEV tolerance of
    tests/test_torch_camera_detector.py), and each channel block equals the
    port's single-sweep run on that sweep alone, bit for bit;
  * the 2-sweep camera detector (`tiny_model(with_lidar=False)`, the BEV
    backbone on 2·256 channels) in train mode, one forward: its outputs at
    the tolerances of tests/test_torch_camera_detector.py, and the
    BatchNorms' running statistics after it against JAX's `batch_stats`
    (rtol 1e-4, atol 1e-5, those of tests/test_torch_train_step.py), the
    BatchNorms tamed as there; every sweep updates the camera encoder's
    statistics, key sweep first;
  * in the port alone: only the key sweep's images carry a gradient, no
    graph is kept for the others, a batch with another S raises, and
    `Detector` and `serving/export.py` take S from the weights (the
    exported program predicts bit-equal to the live detector).
Float32 on the CPU; JAX parameters shaped by `jax.eval_shape` and drawn
from numpy (`tests/test_torch_weights.randomize`); no JAX step compiled.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidistill_tpu.configs.nuscenes import tiny_model as jax_tiny_model
from unidistill_tpu.layers.lss import LSSFPN as JaxLSSFPN
from unidistill_tpu.models.bevfusion import BEVFusionCenterHead as JaxModel

from unidistill_torch.configs.nuscenes import tiny_model
from unidistill_torch.layers.lss import LSSFPN
from unidistill_torch.models.bevfusion import BEVFusionCenterHead, sweeps_from_state_dict
from unidistill_torch.serving.export import export_detector, load_detector
from unidistill_torch.serving.predictor import Detector
from unidistill_torch.serving.synthetic import nuscenes_batch, random_state_dict
from unidistill_torch.training.jax_weights import state_dict_from_jax
from unidistill_torch.training.steps import model_inputs

from tests.test_full_model_golden import _rich_mats
from tests.test_lss_multisweep import _mats
from tests.test_torch_camera_detector import ATOL_BEV, ATOL_HEAD, RTOL, nhwc
from tests.test_torch_data import _two_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_train_step import tame
from tests.test_torch_weights import port_module, randomize

S = 2
STATS_TOL = dict(rtol=1e-4, atol=1e-5)


def stack_sweeps(per_sweep):
    """Per-sweep mats dicts -> the multi-sweep layout (bda_mat of sweep 0)."""
    return {k: (per_sweep[0][k] if k == "bda_mat" else np.stack([m[k] for m in per_sweep], axis=1))
            for k in per_sweep[0]}


@functools.lru_cache(maxsize=1)
def lss_case():
    """tests/test_lss_multisweep.py's inputs and JAX's output on them."""
    ccfg = jax_tiny_model().camera_encoder
    B, N = 1, ccfg.num_cams
    Hc, Wc = ccfg.final_dim
    rng = np.random.RandomState(0)
    imgs = rng.randn(B, S, N, Hc, Wc, 3).astype(np.float32)
    per_sweep = [_mats(rng, B, N, Hc, Wc, sweep_shift=0.5 * s) for s in range(S)]
    mats = stack_sweeps(per_sweep)
    jm = JaxLSSFPN(ccfg, dtype=jnp.float32)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.asarray(imgs),
                                            jax.tree.map(jnp.asarray, mats), False))
    rng = np.random.RandomState(1)
    params, stats = randomize(shapes["params"], rng), randomize(shapes["batch_stats"], rng, True)
    want = jax.jit(lambda v, x, m: jm.apply(v, x, m, False))(
        {"params": params, "batch_stats": stats}, jnp.asarray(imgs), jax.tree.map(jnp.asarray, mats))
    cfg = dataclasses.replace(tiny_model(with_lidar=False), compute_dtype="float32")
    port = port_module(LSSFPN(cfg.camera_encoder), params, stats, "camera_encoder", cfg)
    return imgs, per_sweep, mats, np.asarray(want), port


def test_lss_multisweep_matches_jax_and_single_sweeps():
    imgs, per_sweep, mats, want, port = lss_case()
    t = lambda m: {k: torch.from_numpy(v) for k, v in m.items()}
    with torch.no_grad():
        got = port.eval()(torch.from_numpy(imgs), t(mats))
        C = got.shape[1] // S
        assert got.shape[1] == S * 256
        np.testing.assert_allclose(nhwc(got), want, rtol=RTOL, atol=ATOL_BEV)
        for s in range(S):
            single = port(torch.from_numpy(np.ascontiguousarray(imgs[:, s])), t(per_sweep[s]))
            assert torch.equal(got[:, s * C:(s + 1) * C], single), s
    # the sweeps differ, so the blocks do
    assert not torch.equal(got[:, :C], got[:, C:])
    assert np.abs(want).max() > 1e-2


# ---- the 2-sweep camera detector -----------------------------------------------

def detector_batch(cfg, B, seed):
    """Normalised random images of S sweeps; sweep 0 has the golden test's
    rich camera matrices, sweep 1 the same cameras 0.5 m further back."""
    n = cfg.camera_encoder.num_cams
    H, W = cfg.camera_encoder.final_dim
    key = _rich_mats(B, n, H, W)
    earlier = dict(key, sensor2ego_mats=key["sensor2ego_mats"].copy())
    earlier["sensor2ego_mats"][..., 0, 3] -= 0.5
    rng = np.random.RandomState(seed)
    return dict(imgs=rng.randn(B, S, n, H, W, 3).astype(np.float32), mats=stack_sweeps([key, earlier]))


@functools.lru_cache(maxsize=1)
def detector_case():
    """Tamed random weights; JAX's train-mode forward and updated batch
    statistics; the port's state dict."""
    jcfg = dataclasses.replace(jax_tiny_model(with_lidar=False), compute_dtype="float32")
    pcfg = dataclasses.replace(tiny_model(with_lidar=False), compute_dtype="float32")
    batch = detector_batch(pcfg, B=2, seed=3)
    jb = jax.tree.map(jnp.asarray, batch)
    model = JaxModel(jcfg)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0), imgs=jb["imgs"], mats=jb["mats"],
                                               train=False))
    rng = np.random.RandomState(5)
    params = tame(randomize(shapes["params"], rng))
    stats = randomize(shapes["batch_stats"], rng, True)
    out, new = jax.jit(lambda v, b: model.apply(v, imgs=b["imgs"], mats=b["mats"], train=True,
                                                mutable=["batch_stats"]))(
        {"params": params, "batch_stats": stats}, jb)
    port_sd = state_dict_from_jax(params, stats, pcfg)
    want_stats = state_dict_from_jax({}, jax.tree.map(np.asarray, new["batch_stats"]), pcfg)
    return pcfg, batch, port_sd, jax.tree.map(np.asarray, out), want_stats


def port_detector(pcfg, port_sd):
    model = BEVFusionCenterHead(pcfg, sweeps_from_state_dict(pcfg, port_sd))
    model.load_state_dict(port_sd, strict=True)
    return model


def test_two_sweep_detector_train_forward_and_statistics_match_jax():
    pcfg, batch, port_sd, ref, want_stats = detector_case()
    model = port_detector(pcfg, port_sd)
    assert model.sweeps == S and model.bev_encoder.block0_conv0.weight.shape[1] == S * 256
    with torch.no_grad():
        out = model.train()(**model_inputs(batch, pcfg, "cpu", training=True))
    np.testing.assert_allclose(nhwc(out["model_output"]), ref["model_output"], rtol=RTOL, atol=ATOL_BEV)
    np.testing.assert_allclose(nhwc(out["bev_feature"]), ref["bev_feature"], rtol=RTOL, atol=ATOL_HEAD)
    for tid, r in enumerate(ref["multi_head_features"]):
        for name, v in r.items():
            np.testing.assert_allclose(nhwc(out["multi_head_features"][tid][name]), v,
                                       rtol=RTOL, atol=ATOL_HEAD, err_msg=f"task{tid}/{name}")
    got = model.state_dict()
    assert want_stats.keys() <= got.keys()
    for k, v in want_stats.items():
        if k.endswith("num_batches_tracked"):
            continue
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **STATS_TOL)
    # the camera encoder's BatchNorms took both sweeps: two updates each
    assert got["camera_encoder.img_backbone.bn1.num_batches_tracked"].item() == S
    assert got["bev_encoder.block0_bn0.num_batches_tracked"].item() == 1


def test_only_the_key_sweep_carries_a_gradient():
    pcfg, batch, port_sd, _, _ = detector_case()
    model = port_detector(pcfg, port_sd).train()
    kw = model_inputs(batch, pcfg, "cpu", training=True)
    kw["imgs"].requires_grad_(True)
    out = model(**kw)
    # the sweeps' concatenation has a graph behind the key sweep's block only
    cat = out["model_output"].grad_fn
    assert cat.name() == "CatBackward0"
    assert cat.next_functions[0][0] is not None and cat.next_functions[1][0] is None
    (out["model_output"].square().sum() + out["bev_feature"].sum()).backward()
    g = kw["imgs"].grad
    assert g[:, 0].abs().max() > 0
    assert torch.all(g[:, 1] == 0)


def test_sweep_count_mismatch_raises():
    pcfg, batch, port_sd, _, _ = detector_case()
    model = port_detector(pcfg, port_sd).eval()
    single = dict(imgs=batch["imgs"][:, 0], mats={k: (v if k == "bda_mat" else v[:, 0])
                                                  for k, v in batch["mats"].items()})
    with pytest.raises(ValueError, match="sweep"):
        model(**model_inputs(single, pcfg, "cpu", training=False))
    det = Detector(pcfg, port_sd, device="cpu")
    assert det.model.sweeps == S
    with pytest.raises(ValueError, match="imgs"):
        det.predict(single)
    rois = det.predict(batch)
    assert rois["boxes"].shape[0] == 2
    # a one-sweep model refuses two sweeps
    one = BEVFusionCenterHead(pcfg)
    with pytest.raises(ValueError, match="sweep"):
        one.eval()(**model_inputs(batch, pcfg, "cpu", training=False))


def test_two_sweep_detector_exports(tmp_path):
    pcfg, batch, port_sd, _, _ = detector_case()
    batch = dict(batch, gt_boxes=np.zeros((2, pcfg.caps.max_gt_boxes, 10), np.float32))
    export_detector(pcfg, port_sd, str(tmp_path), batch_size=2, device="cpu")
    loaded = load_detector(str(tmp_path))
    spec = loaded.meta["batch_spec"]
    n = pcfg.camera_encoder.num_cams
    assert spec["imgs"]["shape"] == [2, S, n, *pcfg.camera_encoder.final_dim, 3]
    assert spec["mats/ida_mats"]["shape"] == [2, S, n, 4, 4] and spec["mats/bda_mat"]["shape"] == [2, 4, 4]
    live = Detector(pcfg, port_sd, device="cpu").predict(batch)
    got = loaded.predict(batch)
    for k, v in live.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    assert live["mask"].sum() > 0
    with pytest.raises(ValueError, match="imgs"):
        loaded.predict(dict(batch, imgs=batch["imgs"][:, 0]))


def test_synthetic_multisweep_batch():
    """`nuscenes_batch` with sweeps: [B, S, N, H, W, 3] images, per-sweep
    matrices, each earlier sweep's cameras one ego step back; the seeded
    weights of a 2-sweep model load strictly."""
    cfg = tiny_model(with_lidar=False)
    one, two = nuscenes_batch(cfg, 2, seed=0), nuscenes_batch(cfg, 2, seed=0, sweeps=S)
    n = cfg.camera_encoder.num_cams
    assert two["imgs"].shape == (2, S, n) + cfg.camera_encoder.final_dim + (3,)
    for k in ("sensor2ego_mats", "intrin_mats", "ida_mats"):
        assert two["mats"][k].shape == (2, S, n, 4, 4)
    np.testing.assert_array_equal(two["mats"]["sensor2ego_mats"][:, 0], one["mats"]["sensor2ego_mats"])
    step = two["mats"]["sensor2ego_mats"][:, 1] - two["mats"]["sensor2ego_mats"][:, 0]
    np.testing.assert_allclose(step[..., 0, 3], -0.5)
    assert np.count_nonzero(step) == step[..., 0, 3].size
    assert two["mats"]["bda_mat"].shape == (2, 4, 4)
    sd = random_state_dict(cfg, seed=0, sweeps=S)
    assert sweeps_from_state_dict(cfg, sd) == S
    BEVFusionCenterHead(cfg, S).load_state_dict(sd, strict=True)
