"""The port's launchers end to end on the CPU: the camera←LiDAR distill CLI
trains one epoch from a saved LiDAR teacher, resumes to a second epoch
(with validation), then the camera CLI evaluates (`-e`) and predicts (`-p`)
from the checkpoint, at `tiny_model` on the synthetic on-disk mini-nuScenes
of `tests/test_data_pipeline.py` (no JAX step is compiled). Also the
launcher files and the JAX CLI's option parsing."""
import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from unidistill_tpu.exps.base_cli import parse_exp_options as jax_parse_exp_options

from unidistill_torch.configs import nuscenes as cfgs
from unidistill_torch.exps import base_cli
from unidistill_torch.exps.base_cli import parse_exp_options
from unidistill_torch.exps.distill_cli import load_teacher, run_distill_cli
from unidistill_torch.models.bevfusion import BEVFusionCenterHead
from unidistill_torch.training import checkpoint as ckpt_lib
from unidistill_torch.training.loop import init_params

from tests.test_data_pipeline import build_synth_nusc
from tests.test_torch_data import _two_threads  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
N_FRAMES = 2
BATCH = 2
LAUNCHERS = sorted((ROOT / "unidistill_torch" / "exps" / "nuscenes").glob("BEVFusion_*.py"))


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    root = build_synth_nusc(tmp_path_factory.mktemp("nusc_cli"), N_FRAMES)
    shutil.copy(os.path.join(root, "val_info.pkl"), os.path.join(root, "test_info.pkl"))
    return root


def _tiny_exp(root, with_lidar, with_camera, name):
    return cfgs.ExpConfig(
        exp_name=name,
        model=cfgs.tiny_model(with_lidar=with_lidar, with_camera=with_camera),
        data=cfgs.DataConfig(root_path=root, num_lidar_sweeps=2, use_cbgs=False),
        train=cfgs.TrainConfig(batch_size_per_device=1, max_epochs=1),
    )


@pytest.fixture
def tiny_exps(synth_root, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(cfgs, "lidar_exp", lambda: _tiny_exp(synth_root, True, False, "tiny_lidar"))
    monkeypatch.setattr(cfgs, "camera_exp", lambda: _tiny_exp(synth_root, False, True, "tiny_camera"))
    monkeypatch.setattr(cfgs, "fusion_exp", lambda: _tiny_exp(synth_root, True, True, "tiny_fusion"))
    return tmp_path


def _records(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_distill_cli_trains_resumes_evaluates_and_predicts(tiny_exps):
    tmp = tiny_exps
    teacher = init_params(BEVFusionCenterHead(cfgs.lidar_exp().model), seed=5)
    ckpt_lib.save_checkpoint(str(tmp / "teacher"), 0, teacher)
    common = ["-b", str(BATCH), "--num_workers", "0", "--device", "cpu"]

    # ---- one epoch from the saved teacher -----------------------------------
    tr1 = run_distill_cli("lidar", "camera", argv=common + [
        "--max_epochs", "1", "--teacher_ckpt", str(tmp / "teacher" / "step_0"),
        "--exp_options", "train.eval_interval=2"])
    steps_per_epoch = N_FRAMES // BATCH
    out1 = tr1.output_dir
    assert Path(out1).parent.name == "BEVFusion_nuscenes_centerhead_camera_exp_distill_lidar"
    assert os.path.realpath(os.path.join(Path(out1).parent, "latest")) == os.path.realpath(out1)
    assert sorted(os.listdir(os.path.join(out1, "ckpt"))) == [f"step_{steps_per_epoch}"]
    recs = _records(out1)
    assert recs[0]["event"] == "init" and recs[0]["n_params"] > 0
    steps = [r for r in recs if "step" in r]
    assert [r["step"] for r in steps] == [steps_per_epoch]
    for key in ("loss", "loss_det", "loss_feature", "loss_bev_rel", "loss_resp_cls", "loss_resp_reg",
                "grad_norm", "sec_per_step", "loader_wait_sec_per_step"):
        assert np.isfinite(steps[0][key]), key
    assert not any(r.get("event") == "val" for r in recs)  # eval_interval 2
    # the teacher trained nothing and is the saved one
    assert not tr1.teacher.training
    assert all(not p.requires_grad for p in tr1.teacher.parameters())
    for k, v in teacher.state_dict().items():
        assert torch.equal(tr1.teacher.state_dict()[k], v), k
    # the student moved away from its seeded start
    start = init_params(BEVFusionCenterHead(cfgs.camera_exp().model), seed=0).state_dict()
    trained = ckpt_lib.restore_checkpoint_any(os.path.join(out1, "ckpt"))
    assert trained["step"] == steps_per_epoch and "optimizer" in trained
    assert any(not torch.equal(trained["model"][k], v) for k, v in start.items() if v.is_floating_point())

    # ---- resume to two epochs: only the second epoch trains -----------------
    tr2 = run_distill_cli("lidar", "camera", argv=common + [
        "--max_epochs", "2", "--teacher_ckpt", str(tmp / "teacher"), "--ckpt_path",
        os.path.join(out1, "ckpt"), "--exp_options", "train.eval_interval=2"])
    out2 = tr2.output_dir
    assert out2 != out1
    assert sorted(os.listdir(os.path.join(out2, "ckpt"))) == [f"step_{2 * steps_per_epoch}"]
    recs = _records(out2)
    assert [r["step"] for r in recs if "step" in r] == [2 * steps_per_epoch]
    vals = [r for r in recs if r.get("event") == "val"]
    assert len(vals) == 1 and vals[0]["epoch"] == 1 and "eval_error" not in vals[0]
    assert np.isfinite(vals[0]["mean_ap"]) and np.isfinite(vals[0]["nd_score"])
    saved = ckpt_lib.restore_checkpoint_any(os.path.join(out2, "ckpt"))
    for k, v in tr2.model.state_dict().items():
        assert torch.equal(saved["model"][k], v.cpu()), k

    # ---- -e and -p with the camera launcher's CLI --------------------------
    camera = cfgs.camera_exp()
    tr3 = base_cli.run_cli(camera, argv=common + ["-e", "--ckpt_path", os.path.join(out2, "ckpt")])
    with open(os.path.join(tr3.output_dir, "nuscenes", "metrics_summary.json")) as f:
        metrics = json.load(f)
    for key in ("mean_ap", "nd_score"):
        assert np.isfinite(metrics[key]), key
    assert set(metrics["tp_errors"]) == {"trans_err", "scale_err", "orient_err", "vel_err", "attr_err"}
    assert all(np.isfinite(v) for v in metrics["tp_errors"].values())
    with open(os.path.join(tr3.output_dir, "nuscenes", "nuscenes_results.json")) as f:
        sub = json.load(f)
    assert set(sub["results"]) == {f"tok{i}" for i in range(N_FRAMES)}

    tr4 = base_cli.run_cli(camera, argv=common + ["-p", "--ckpt_path", os.path.join(out2, "ckpt")])
    sub_dir = os.path.join(tr4.output_dir, "nuscenes_submission")
    with open(os.path.join(sub_dir, "nuscenes_results.json")) as f:
        assert set(json.load(f)["meta"]) == {"use_camera", "use_lidar", "use_radar", "use_map", "use_external"}
    with open(os.path.join(sub_dir, "boxes.pkl"), "rb") as f:
        preds = pickle.load(f)
    assert [p["meta"]["token"] for p in preds] == [f"tok{i}" for i in range(N_FRAMES)]
    assert all(p["labels"].min(initial=0) >= 0 and p["boxes"].shape[1:] == (9,) for p in preds)


def test_load_teacher_from_a_reference_pth(tiny_exps):
    """A reference `.pth`: the names it has are used, a wrong shape is
    skipped, the rest keep the seeded init; the teacher comes back frozen."""
    t_cfg = cfgs.lidar_exp().model
    sd = {"det_head.dense_head.auto_loss.params": torch.full((12,), 2.0),
          "det_head.dense_head.shared_conv.0.weight": torch.zeros(64, 999, 3, 3)}
    torch.save({"model_state": sd}, tiny_exps / "teacher.pth")
    model = load_teacher(t_cfg, str(tiny_exps / "teacher.pth"), "cpu", seed=1)
    init = init_params(BEVFusionCenterHead(t_cfg), seed=1).state_dict()
    assert torch.equal(model.awl_params, torch.full((12,), 2.0))
    assert torch.equal(model.det_head.shared_conv.weight, init["det_head.shared_conv.weight"])
    assert not model.training and not any(p.requires_grad for p in model.parameters())


@pytest.mark.parametrize("pairs", [
    ["train.lr=0.0002", "model.det_head.iou_weight=2", "data.use_cbgs=False",
     "model.grid_size=(720,720,1)", "data.root_path=/some/path"],
    ["a=[1, 2]", "b=None", "c={'k': 1}", "d=1e-3", "e=x=y"],
    None,
])
def test_parse_exp_options_matches_jax(pairs):
    assert parse_exp_options(pairs) == jax_parse_exp_options(pairs)


def test_launchers_mirror_the_jax_ones_and_parse_the_flags():
    jax_names = sorted(p.name for p in (ROOT / "unidistill_tpu" / "exps" / "nuscenes").glob("BEVFusion_*.py"))
    assert [p.name for p in LAUNCHERS] == jax_names and len(LAUNCHERS) == 7
    res = subprocess.run([sys.executable, str(LAUNCHERS[0]), "--help"], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr
    for flag in ("--exp_options", "--ckpt_path", "--num_workers", "--device"):
        assert flag in res.stdout
    args = base_cli.build_parser().parse_args([])
    assert args.device == "cuda" and args.num_workers == 10 and not args.evaluate
