"""The plain reference against the port's CPU path at tiny sizes: in
float32 the two compute the same thing, so they agree to rounding; the
fp8 control does not."""
from __future__ import annotations

import dataclasses

import pytest
import torch

from benchmark.harness import compare
from benchmark.harness import setup as su
from benchmark.inputs import synthetic


@pytest.fixture(autouse=True)
def _threads():
    torch.set_num_threads(2)


def _configs(with_lidar: bool, with_camera: bool, dtype="float32"):
    from unidistill_torch.configs import nuscenes

    from benchmark.harness.spec import build_dataclass
    from benchmark.reference import config as rconfig

    p = dataclasses.replace(nuscenes.tiny_model(with_lidar=with_lidar, with_camera=with_camera), compute_dtype=dtype)
    return p, build_dataclass(rconfig.ModelConfig, dataclasses.asdict(p))


def _models(pcfg, rcfg, seed, precision="float32"):
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead as Port

    from benchmark.reference.model import BEVFusionCenterHead as Ref

    sd = su.weights(rcfg, seed, su.STREAM_WEIGHTS, "cpu")
    port, ref = Port(pcfg), Ref(rcfg, precision=precision)
    port.load_state_dict(sd)
    ref.load_state_dict(sd)
    return port, ref


@pytest.mark.parametrize("modality", ["camera", "lidar"])
def test_eval_forward_and_rois_agree(modality):
    from unidistill_torch.training import steps as psteps

    from benchmark.reference import steps as rsteps

    pcfg, rcfg = _configs(modality == "lidar", modality == "camera")
    port, ref = _models(pcfg, rcfg, 3)
    g = synthetic.generator(3, su.STREAM_POOL, "cpu")
    batch = synthetic.train_batch(pcfg.camera_encoder, pcfg.caps.max_points, pcfg.caps.max_gt_boxes, 2, g, "cpu",
                                  with_points=True)
    synthetic.calibrate_batchnorm(port, psteps.model_inputs(batch, pcfg, "cpu", training=False))
    synthetic.calibrate_batchnorm(ref, rsteps.model_inputs(batch, rcfg, "cpu", training=False))
    with torch.no_grad():
        po = port(**psteps.model_inputs(batch, pcfg, "cpu", training=False))
        ro = ref(**rsteps.model_inputs(batch, rcfg, "cpu", training=False))
    assert compare.rel_l2(po["model_output"], ro["model_output"]) < 1e-6
    for p, r in zip(po["multi_head_features"], ro["multi_head_features"]):
        assert compare.worst_map_gap(p, r)[0] < 1e-5
    rois_p = psteps.eval_step(port.eval(), batch, pcfg)
    rois_r = rsteps.eval_step(ref.eval(), batch, rcfg)
    assert compare.roi_mismatch(rois_p, rois_r, 1e-5) == 0


@pytest.mark.parametrize("distill", [False, True], ids=["train", "distill"])
def test_train_steps_agree(distill):
    from unidistill_torch.configs import nuscenes
    from unidistill_torch.training import steps as psteps
    from unidistill_torch.training.train_state import TrainState as PState, make_optimizer as popt

    from benchmark.harness.spec import build_dataclass
    from benchmark.reference import config as rconfig
    from benchmark.reference import steps as rsteps
    from benchmark.reference.optim import TrainState as RState, make_optimizer as ropt

    pcfg, rcfg = _configs(False, True)
    port, ref = _models(pcfg, rcfg, 4)
    g = synthetic.generator(4, su.STREAM_POOL, "cpu")
    ptcfg, rtcfg = _configs(True, False)
    batch = synthetic.train_batch(pcfg.camera_encoder, ptcfg.caps.max_points, pcfg.caps.max_gt_boxes, 2, g, "cpu",
                                  with_points=distill)
    exp = nuscenes.distill_exp("lidar", "camera")
    po, ro = popt(port, exp.train), ropt(ref, build_dataclass(rconfig.TrainConfig, dataclasses.asdict(exp.train)))
    if distill:
        tp, tr_ = _models(ptcfg, rtcfg, 5)
        tp.requires_grad_(False), tr_.requires_grad_(False)
        synthetic.calibrate_batchnorm(tp, psteps.model_inputs(batch, ptcfg, "cpu", training=False))
        synthetic.calibrate_batchnorm(tr_, rsteps.model_inputs(batch, rtcfg, "cpu", training=False))
        mp = psteps.distill_train_step(PState(), batch, port, tp, po, pcfg, ptcfg, exp.distill)
        mr = rsteps.distill_train_step(RState(), batch, ref, tr_, ro, rcfg, rtcfg,
                                       build_dataclass(rconfig.DistillConfig, dataclasses.asdict(exp.distill)))
    else:
        mp = psteps.train_step(PState(), batch, port, po, pcfg)
        mr = rsteps.train_step(RState(), batch, ref, ro, rcfg)
    for k in mr:
        assert float(mp[k]) == pytest.approx(float(mr[k]), rel=1e-4, abs=1e-6), k
    params_r = dict(ref.named_parameters())
    for k, p in port.named_parameters():
        assert torch.allclose(p, params_r[k], rtol=1e-4, atol=1e-6), k


def test_fp8_control_departs():
    """The control computes in fp8: its maps lie far from float32's, the
    port's float32 path does not."""
    from benchmark.reference import steps as rsteps

    pcfg, rcfg = _configs(False, True)
    _, ref = _models(pcfg, rcfg, 6)
    _, low = _models(pcfg, rcfg, 6, precision="fp8")
    batch = synthetic.camera_batch(pcfg.camera_encoder, 2, synthetic.generator(6, su.STREAM_POOL, "cpu"), "cpu")
    for m in (ref, low):
        synthetic.calibrate_batchnorm(m, rsteps.model_inputs(batch, rcfg, "cpu", training=False))
    with torch.no_grad():
        a = ref(**rsteps.model_inputs(batch, rcfg, "cpu", training=False))
        b = low(**rsteps.model_inputs(batch, rcfg, "cpu", training=False))
    assert compare.rel_l2(b["model_output"], a["model_output"]) > 1e-2
