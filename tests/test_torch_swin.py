"""The port's Swin-T image backbone (`unidistill_torch/layers/swin.py`), its
import map and the Swin camera detector against the JAX package.

  * `SwinTransformer` at embed 8, depths (2, 1), heads (2, 4), window 4,
    float32, on images whose patch grid the window divides and on one it
    does not (stage padding, the shifted mask, merge padding and the patch
    embed's SAME padding run): tolerance 2e-4 (tests/test_swin.py);
  * the shift mask equals JAX's;
  * the mmdet-style Swin dict of tests/test_swin.py through the port's
    `torch_import.convert_state_dict` equals JAX `_import_swin` followed by
    `jax_weights.state_dict_from_jax`, tensor for tensor; the same for a
    whole Swin camera detector's reference state dict (Swin-T at full width);
  * the Swin camera detector (`tiny_model(with_lidar=False)` with the
    reference's Swin neck overrides, applied by each package's
    `apply_overrides`) forward and eval step against JAX, float32, at the
    tolerances of tests/test_torch_camera_detector.py; its export
    (`serving/export.py`) predicts bit-equal to the live detector.
JAX modules run through `Module.apply` under `jax.jit`; no JAX train step
is compiled.
"""
import dataclasses
import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from unidistill_tpu.configs.nuscenes import apply_overrides as jax_apply_overrides
from unidistill_tpu.configs.nuscenes import camera_exp as jax_camera_exp
from unidistill_tpu.configs.nuscenes import tiny_model as jax_tiny_model
from unidistill_tpu.layers import swin as jax_swin
from unidistill_tpu.models.bevfusion import BEVFusionCenterHead as JaxModel
from unidistill_tpu.training import steps as jax_steps
from unidistill_tpu.training.torch_import import TreeBuilder, _import_swin
from unidistill_tpu.training.torch_import import convert_state_dict as jax_convert_state_dict

from unidistill_torch.configs.nuscenes import SWIN_CAMERA_OVERRIDES, apply_overrides, camera_exp, tiny_model
from unidistill_torch.layers import swin
from unidistill_torch.models.bevfusion import BEVFusionCenterHead
from unidistill_torch.serving.export import export_detector, load_detector
from unidistill_torch.serving.predictor import Detector
from unidistill_torch.serving.synthetic import random_state_dict
from unidistill_torch.training.jax_weights import state_dict_from_jax
from unidistill_torch.training.loop import init_params
from unidistill_torch.training.steps import eval_step, model_inputs
from unidistill_torch.training.torch_import import _Converter, _swin, convert_state_dict

from tests.test_torch_camera_detector import ATOL_BEV, ATOL_HEAD, RTOL, _assert_rois_equal, camera_batch, nhwc
from tests.test_torch_data import _two_threads  # noqa: F401 (autouse fixture)
from tests.test_torch_import_full import build_reference_state_dict
from tests.test_torch_weights import PCFG

SMALL = dict(embed_dim=8, depths=(2, 1), num_heads=(2, 4), window_size=4)
SWIN_TOL = dict(rtol=2e-4, atol=2e-4)


def mmdet_swin_state_dict(prefix, embed_dim, depths, heads, ws, out_indices, rng):
    """Random weights under mmdet's SwinTransformer names (the dict of
    tests/test_swin.py, drawn with numpy): weights at 1/sqrt(fan_in),
    LayerNorm scales near 1."""
    sd = {}

    def w(*shape):
        return (rng.randn(*shape) / np.sqrt(np.prod(shape[1:]) if len(shape) > 1 else 1)).astype(np.float32)

    def ln(name, c):
        sd[f"{name}.weight"] = (1 + 0.1 * rng.randn(c)).astype(np.float32)
        sd[f"{name}.bias"] = (0.1 * rng.randn(c)).astype(np.float32)

    def lin(name, cout, cin, bias=True):
        sd[f"{name}.weight"] = w(cout, cin)
        if bias:
            sd[f"{name}.bias"] = (0.1 * rng.randn(cout)).astype(np.float32)

    sd[f"{prefix}.patch_embed.projection.weight"] = w(embed_dim, 3, 4, 4)
    sd[f"{prefix}.patch_embed.projection.bias"] = (0.1 * rng.randn(embed_dim)).astype(np.float32)
    ln(f"{prefix}.patch_embed.norm", embed_dim)
    dim = embed_dim
    for st, depth in enumerate(depths):
        for blk in range(depth):
            p = f"{prefix}.stages.{st}.blocks.{blk}"
            ln(f"{p}.norm1", dim)
            ln(f"{p}.norm2", dim)
            sd[f"{p}.attn.w_msa.relative_position_bias_table"] = (
                0.2 * rng.randn((2 * ws - 1) ** 2, heads[st])).astype(np.float32)
            lin(f"{p}.attn.w_msa.qkv", 3 * dim, dim)
            lin(f"{p}.attn.w_msa.proj", dim, dim)
            lin(f"{p}.ffn.layers.0.0", 4 * dim, dim)
            lin(f"{p}.ffn.layers.1", dim, 4 * dim)
        if st < len(depths) - 1:
            d = f"{prefix}.stages.{st}.downsample"
            ln(f"{d}.norm", 4 * dim)
            lin(f"{d}.reduction", 2 * dim, 4 * dim, bias=False)
            dim *= 2
    for st in out_indices:
        ln(f"{prefix}.norm{st}", embed_dim * 2 ** st)
    return sd


@pytest.mark.parametrize("H,W,ws,shift", [(14, 14, 7, 3), (8, 12, 4, 2), (70, 182, 7, 3)])
def test_shift_attn_mask_matches_jax(H, W, ws, shift):
    np.testing.assert_array_equal(swin._shift_attn_mask(H, W, ws, shift),
                                  jax_swin._shift_attn_mask(H, W, ws, shift))


@functools.lru_cache(maxsize=1)
def small_weights():
    """The small Swin's JAX params, from the mmdet dict through JAX's
    importer, and the port's state dict from the same dict."""
    sd = mmdet_swin_state_dict("bb", 8, (2, 1), (2, 4), 4, (0, 1), np.random.RandomState(0))
    b = TreeBuilder()
    _import_swin(b, sd, "bb", "swin", embed_dim=8, depths=(2, 1), out_indices=(0, 1))
    conv = _Converter({k: torch.from_numpy(v) for k, v in sd.items()})
    _swin(conv, "bb", "swin", embed_dim=8, depths=(2, 1), out_indices=(0, 1))
    return b.params["swin"], {k[len("swin."):]: v for k, v in conv.out.items()}


def test_swin_import_map_matches_jax():
    """The port's map of the mmdet dict equals JAX's importer composed with
    `state_dict_from_jax`, and loads strictly."""
    params, got = small_weights()
    want = state_dict_from_jax(params, {}, PCFG)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    swin.SwinTransformer(**SMALL, out_indices=(0, 1)).load_state_dict(got, strict=True)


# 32 x 32: an 8 x 8 patch grid, which the window divides at both stages;
# 42 x 58: SAME padding of the patch embed (11 x 15), stage padding to 12 x 16,
# an odd merge (6 x 8) and stage 1 padded to 8 x 8
@pytest.mark.parametrize("H,W", [(32, 32), (42, 58)])
def test_swin_backbone_matches_jax(H, W):
    params, sd = small_weights()
    x = np.random.RandomState(H).randn(2, H, W, 3).astype(np.float32)
    jm = jax_swin.SwinTransformer(**SMALL, out_indices=(0, 1), dtype=jnp.float32)
    want = jax.jit(lambda p, v: jm.apply({"params": p}, v))(params, jnp.asarray(x))
    pm = swin.SwinTransformer(**SMALL, out_indices=(0, 1))
    pm.load_state_dict(sd, strict=True)
    with torch.no_grad():
        got = pm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert len(got) == len(want) == 2
    for g, r in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(nhwc(g), np.asarray(r), **SWIN_TOL)


# ---- the Swin camera detector ------------------------------------------------

def swin_cfgs():
    jcfg = jax_apply_overrides(dataclasses.replace(jax_camera_exp(), model=jax_tiny_model(with_lidar=False)),
                               SWIN_CAMERA_OVERRIDES).model
    pcfg = apply_overrides(dataclasses.replace(camera_exp(), model=tiny_model(with_lidar=False)),
                           SWIN_CAMERA_OVERRIDES).model
    return (dataclasses.replace(jcfg, compute_dtype="float32"),
            dataclasses.replace(pcfg, compute_dtype="float32"))


def swin_reference_state_dict(jcfg, seed):
    """A reference camera detector's state dict with an mmdet Swin-T image
    backbone at full width (the JAX importer takes Swin-T's widths)."""
    sd = {k: v for k, v in build_reference_state_dict(jcfg, rng=np.random.RandomState(seed)).items()
          if not k.startswith("camera_encoder.backbone.img_backbone.")}
    sd.update(mmdet_swin_state_dict("camera_encoder.backbone.img_backbone", 96, (2, 2, 6, 2),
                                    (3, 6, 12, 24), 7, (1, 2, 3), np.random.RandomState(seed + 1)))
    return sd


@functools.lru_cache(maxsize=1)
def detector_case():
    jcfg, pcfg = swin_cfgs()
    sd = swin_reference_state_dict(jcfg, seed=7)
    params, stats = jax_convert_state_dict(sd, jcfg)
    port_sd = state_dict_from_jax(params, stats, pcfg)
    return jcfg, pcfg, sd, params, stats, port_sd, camera_batch(pcfg, B=2, seed=3)


@functools.lru_cache(maxsize=1)
def jax_detector_outputs():
    jcfg, _, _, params, stats, _, batch = detector_case()
    model = JaxModel(jcfg)
    kw = jax_steps.model_inputs(jax.tree.map(jnp.asarray, batch), jcfg, training=False)
    # the parameters go in as arguments: as closure constants they stay numpy
    # arrays, which the bias-table lookup cannot index with a tracer
    variables = jax.tree.map(jnp.asarray, {"params": params, "batch_stats": stats})
    out = jax.jit(lambda v: model.apply(v, **kw, train=False))(variables)

    class State:
        pass

    def rois_fn(v, b):
        state = State()
        state.params, state.batch_stats = v["params"], v["batch_stats"]
        return jax_steps.eval_step(state, b, model, jcfg)

    rois = jax.jit(rois_fn)(variables, jax.tree.map(jnp.asarray, batch))
    return jax.tree.map(np.asarray, out), jax.tree.map(np.asarray, rois)


def test_swin_config_overrides_match_jax():
    jcfg, pcfg = swin_cfgs()
    assert dataclasses.asdict(pcfg.camera_encoder) == dataclasses.asdict(jcfg.camera_encoder)
    assert pcfg.camera_encoder.img_backbone == "swin"


def test_swin_detector_import_matches_jax():
    """The Swin camera detector's reference state dict: the port's direct
    map equals JAX `convert_state_dict` -> `state_dict_from_jax`, and the
    detector loads it strictly."""
    _, pcfg, sd, _, _, want, _ = detector_case()
    got = convert_state_dict({k: torch.from_numpy(np.asarray(v)) for k, v in sd.items()}, pcfg)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
    assert any(".stage2_block5.attn.relative_position_bias_table" in k for k in got)
    BEVFusionCenterHead(pcfg).load_state_dict(got, strict=True)


def test_swin_detector_forward_matches_jax():
    _, pcfg, _, _, _, port_sd, batch = detector_case()
    ref, _ = jax_detector_outputs()
    model = BEVFusionCenterHead(pcfg)
    model.load_state_dict(port_sd, strict=True)
    with torch.no_grad():
        out = model.eval()(**model_inputs(batch, pcfg, "cpu", training=False))
    np.testing.assert_allclose(nhwc(out["model_output"]), ref["model_output"], rtol=RTOL, atol=ATOL_BEV)
    np.testing.assert_allclose(nhwc(out["bev_feature"]), ref["bev_feature"], rtol=RTOL, atol=ATOL_HEAD)
    for tid, r in enumerate(ref["multi_head_features"]):
        for name, v in r.items():
            np.testing.assert_allclose(nhwc(out["multi_head_features"][tid][name]), v,
                                       rtol=RTOL, atol=ATOL_HEAD, err_msg=f"task{tid}/{name}")
    assert np.abs(ref["model_output"]).max() > 1e-2


def test_swin_detector_eval_step_matches_jax():
    _, pcfg, _, _, _, port_sd, batch = detector_case()
    _, ref = jax_detector_outputs()
    _assert_rois_equal(Detector(pcfg, port_sd, device="cpu").predict(batch), ref)
    model = BEVFusionCenterHead(pcfg)
    model.load_state_dict(port_sd, strict=True)
    _assert_rois_equal(eval_step(model.eval(), batch, pcfg), ref)
    assert (ref["mask"].sum(1) > 0).all()


def test_swin_detector_exports(tmp_path):
    """The Swin camera detector through `serving/export.py` on the CPU:
    the loaded program predicts bit-equal to the live detector (the shift
    masks are constants of the program)."""
    _, pcfg, _, _, _, port_sd, batch = detector_case()
    batch = dict(batch, gt_boxes=np.zeros((2, pcfg.caps.max_gt_boxes, 10), np.float32))
    export_detector(pcfg, port_sd, str(tmp_path), batch_size=2, device="cpu")
    live = Detector(pcfg, port_sd, device="cpu").predict(batch)
    got = load_detector(str(tmp_path)).predict(batch)
    for k, v in live.items():
        np.testing.assert_array_equal(got[k], v.numpy(), err_msg=k)
    assert live["mask"].sum() > 0


def test_swin_init_params_draws_as_flax():
    """`init_params` on a Swin detector: linear layers lecun_normal
    (truncated, variance 1/fan_in), LayerNorms 1 and 0, the bias tables
    truncated at ±2·0.02; `random_state_dict` has a rule for every tensor."""
    _, pcfg = swin_cfgs()
    model = init_params(BEVFusionCenterHead(pcfg), seed=0)
    bb = model.camera_encoder.img_backbone
    qkv = bb.stage2_block0.attn.qkv.weight  # [1152, 384]
    assert abs(qkv.std().item() * np.sqrt(384) - 1.0) < 0.05
    assert qkv.abs().max().item() <= 2 / 0.87962566103423978 / np.sqrt(384) + 1e-6
    assert torch.all(bb.stage2_block0.attn.qkv.bias == 0)
    table = bb.stage2_block0.attn.relative_position_bias_table
    assert table.abs().max().item() <= 0.04 and abs(table.std().item() - 0.02 * 0.8796) < 0.003
    assert torch.all(bb.stage2_block0.norm1.weight == 1) and torch.all(bb.stage2_block0.norm1.bias == 0)
    BEVFusionCenterHead(pcfg).load_state_dict(random_state_dict(pcfg, seed=0), strict=True)
