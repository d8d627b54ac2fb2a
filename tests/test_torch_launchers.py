"""The paper's teacher→student pipeline through the port's seven launchers on
the CPU, at `tiny_model` on the synthetic on-disk mini-nuScenes of
`tests/test_data_pipeline.py` (no JAX step is compiled): the LiDAR, camera
and fusion launchers train one epoch each; the four distill launchers train
one epoch each from their teacher launcher's checkpoint; then the LiDAR
launcher evaluates (`-e`) the fusion→LiDAR student and the fusion launcher
predicts (`-p`) from its own checkpoint. Each launcher is run through the
call its file's `__main__` block makes, read from the file, and that call
equals the JAX launcher's (`test_launcher_mirrors_the_jax_one`).

The slow test runs the JAX LiDAR launcher and the port's for one step on
the same frames from the same initial weights and holds the first step's
logged losses equal."""
import ast
import contextlib
import dataclasses
import io
import json
import os
import pickle
import re
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from unidistill_torch.configs import nuscenes as cfgs
from unidistill_torch.exps import base_cli, distill_cli
from unidistill_torch.models.bevfusion import BEVFusionCenterHead
from unidistill_torch.training import checkpoint as ckpt_lib
from unidistill_torch.training.loop import init_params

from tests.test_data_pipeline import build_synth_nusc
from tests.test_torch_data import _two_threads  # noqa: F401 (autouse fixture)

ROOT = Path(__file__).resolve().parents[1]
PORT_DIR = ROOT / "unidistill_torch" / "exps" / "nuscenes"
JAX_DIR = ROOT / "unidistill_tpu" / "exps" / "nuscenes"
LAUNCHERS = sorted(p.name for p in PORT_DIR.glob("BEVFusion_*.py"))
PREFIX = "BEVFusion_nuscenes_centerhead_"
N_FRAMES = 2
BATCH = 2
STEPS = N_FRAMES // BATCH
DETECTORS = ("lidar", "camera", "fusion")
# (teacher, student) of each distill launcher
PAIRS = (("lidar", "camera"), ("camera", "lidar"), ("fusion", "lidar"), ("fusion", "camera"))
COMMON = ["-b", str(BATCH), "--num_workers", "0", "--device", "cpu"]


def launcher_file(student, teacher=None):
    return f"{PREFIX}{student}_exp" + (f"_distill_{teacher}" if teacher else "") + ".py"


def main_call(path: Path):
    """The call a launcher's `if __name__ == "__main__":` block ends with,
    and the module each name it calls was imported from."""
    tree = ast.parse(path.read_text())
    (block,) = [n for n in tree.body if isinstance(n, ast.If) and ast.unparse(n.test) == "__name__ == '__main__'"]
    imports = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom):
            imports.update({a.asname or a.name: node.module for a in node.names})
    call = block.body[-1].value
    assert isinstance(call, ast.Call), ast.unparse(block.body[-1])
    called = [n.id for n in ast.walk(call) if isinstance(n, ast.Name)]
    return call, {name: imports[name] for name in called}


def run_launcher(name: str, argv):
    """Run the launcher file `name` as its `__main__` block does, with
    `argv` for the command line; returns the (closed) trainer."""
    call, _ = main_call(PORT_DIR / name)
    fn = call.func.id
    if fn == "run_cli":
        (exp,) = call.args
        return base_cli.run_cli(getattr(cfgs, exp.func.id)(), argv=argv)
    assert fn == "run_distill_cli" and not call.args, ast.unparse(call)
    kw = {k.arg: k.value.value for k in call.keywords}
    return distill_cli.run_distill_cli(kw["teacher"], kw["student"], argv=argv)


def _tiny_exp(root, with_lidar, with_camera, name):
    return cfgs.ExpConfig(
        exp_name=name,
        model=cfgs.tiny_model(with_lidar=with_lidar, with_camera=with_camera),
        data=cfgs.DataConfig(root_path=root, num_lidar_sweeps=2, use_cbgs=False),
        train=cfgs.TrainConfig(batch_size_per_device=1, max_epochs=1),
    )


class Pipeline:
    """Each launcher's run, made the first time a test asks for it and kept
    for the module's later tests."""

    def __init__(self, root):
        self.root, self.runs = root, {}

    def train(self, student, teacher=None):
        """The trainer of the launcher's one-epoch run and what it printed."""
        key = (student, teacher)
        if key not in self.runs:
            argv = COMMON + ["--max_epochs", "1", "--exp_options", "train.eval_interval=2"]
            if teacher:
                argv += ["--teacher_ckpt", self.ckpt(teacher)]
            with contextlib.redirect_stdout(io.StringIO()) as out:
                trainer = run_launcher(launcher_file(student, teacher), argv)
            print(out.getvalue())
            self.runs[key] = (trainer, out.getvalue())
        return self.runs[key]

    def ckpt(self, detector):
        trainer, _ = self.train(detector)
        return os.path.join(trainer.output_dir, "ckpt")


@pytest.fixture(scope="module")
def pipeline(tmp_path_factory):
    root = build_synth_nusc(tmp_path_factory.mktemp("nusc_launchers"), N_FRAMES)
    shutil.copy(os.path.join(root, "val_info.pkl"), os.path.join(root, "test_info.pkl"))
    with pytest.MonkeyPatch.context() as mp:
        mp.chdir(tmp_path_factory.mktemp("launcher_runs"))
        mp.setattr(cfgs, "lidar_exp", lambda: _tiny_exp(root, True, False, "tiny_lidar"))
        mp.setattr(cfgs, "camera_exp", lambda: _tiny_exp(root, False, True, "tiny_camera"))
        mp.setattr(cfgs, "fusion_exp", lambda: _tiny_exp(root, True, True, "tiny_fusion"))
        yield Pipeline(root)


def _records(out_dir):
    with open(os.path.join(out_dir, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _model_cfg(modality):
    return getattr(cfgs, f"{modality}_exp")().model


def check_trained(trainer, modality):
    """One epoch: the checkpoint at its last step, every logged metric
    finite, no validation, and the model moved from its seeded start.
    Returns the checkpoint's model and the seeded start."""
    recs = _records(trainer.output_dir)
    steps = [r for r in recs if "step" in r]
    assert [r["step"] for r in steps] == [STEPS]
    for k, v in steps[0].items():
        assert np.isfinite(v), k
    assert not any(r.get("event") == "val" for r in recs)
    assert sorted(os.listdir(os.path.join(trainer.output_dir, "ckpt"))) == [f"step_{STEPS}"]
    saved = ckpt_lib.restore_checkpoint_any(os.path.join(trainer.output_dir, "ckpt"))
    assert saved["step"] == STEPS and "optimizer" in saved
    start = init_params(BEVFusionCenterHead(_model_cfg(modality)), seed=0).state_dict()
    assert saved["model"].keys() == start.keys()
    assert any(not torch.equal(saved["model"][k], v) for k, v in start.items() if v.is_floating_point())
    return saved["model"], start


@pytest.mark.parametrize("modality", DETECTORS)
def test_detector_launcher_trains_a_teacher(pipeline, modality):
    trainer, _ = pipeline.train(modality)
    assert Path(trainer.output_dir).parent.name == f"tiny_{modality}"
    assert trainer.teacher is None
    model, start = check_trained(trainer, modality)
    encoders = {"lidar": ("lidar_encoder.",), "camera": ("camera_encoder.",),
                "fusion": ("lidar_encoder.", "camera_encoder.", "fusion_encoder.")}[modality]
    for prefix in encoders:
        assert any(not torch.equal(model[k], v) for k, v in start.items()
                   if k.startswith(prefix) and v.is_floating_point()), prefix


@pytest.mark.parametrize("teacher,student", PAIRS, ids=[f"{s}<-{t}" for t, s in PAIRS])
def test_distill_launcher_trains_from_its_teacher_launcher(pipeline, teacher, student):
    teacher_ckpt = ckpt_lib.restore_checkpoint_any(pipeline.ckpt(teacher))["model"]
    trainer, out = pipeline.train(student, teacher)
    assert Path(trainer.output_dir).parent.name == launcher_file(student, teacher)[:-3]
    # the teacher is the teacher launcher's checkpoint, every tensor, bit for bit
    n = len(teacher_ckpt)
    assert re.search(rf"teacher load: {n} tensors used, 0 kept from init", out), out
    got = trainer.teacher.state_dict()
    assert got.keys() == teacher_ckpt.keys()
    for k, v in teacher_ckpt.items():
        assert torch.equal(got[k], v), k
    assert not trainer.teacher.training
    assert all(not p.requires_grad and p.grad is None for p in trainer.teacher.parameters())
    model, start = check_trained(trainer, student)
    if student == "lidar":
        assert any(not torch.equal(model[k], v) for k, v in start.items()
                   if k.startswith("lidar_encoder.") and v.is_floating_point())
    recs = [r for r in _records(trainer.output_dir) if "step" in r]
    for key in ("loss_det", "loss_feature", "loss_bev_rel", "loss_resp_cls", "loss_resp_reg"):
        assert key in recs[0], key


def test_lidar_launcher_evaluates_the_fusion_student(pipeline):
    student, _ = pipeline.train("lidar", "fusion")
    ckpt = os.path.join(student.output_dir, "ckpt")
    trainer = run_launcher(launcher_file("lidar"), COMMON + ["-e", "--ckpt_path", ckpt])
    # restored strictly into the plain LiDAR model
    saved = ckpt_lib.restore_checkpoint_any(ckpt)["model"]
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(v, saved[k]), k
    with open(os.path.join(trainer.output_dir, "nuscenes", "metrics_summary.json")) as f:
        metrics = json.load(f)
    for key in ("mean_ap", "nd_score"):
        assert np.isfinite(metrics[key]), key
    assert set(metrics["tp_errors"]) == {"trans_err", "scale_err", "orient_err", "vel_err", "attr_err"}
    assert all(np.isfinite(v) for v in metrics["tp_errors"].values())
    with open(os.path.join(trainer.output_dir, "nuscenes", "nuscenes_results.json")) as f:
        assert set(json.load(f)["results"]) == {f"tok{i}" for i in range(N_FRAMES)}


def test_fusion_launcher_predicts_from_its_checkpoint(pipeline):
    trainer = run_launcher(launcher_file("fusion"), COMMON + ["-p", "--ckpt_path", pipeline.ckpt("fusion")])
    sub_dir = os.path.join(trainer.output_dir, "nuscenes_submission")
    tokens = [f"tok{i}" for i in range(N_FRAMES)]
    with open(os.path.join(sub_dir, "nuscenes_results.json")) as f:
        assert set(json.load(f)["results"]) == set(tokens)
    with open(os.path.join(sub_dir, "boxes.pkl"), "rb") as f:
        preds = pickle.load(f)
    assert [p["meta"]["token"] for p in preds] == tokens
    assert all(p["boxes"].shape[1:] == (9,) and p["labels"].min(initial=0) >= 0 for p in preds)


@pytest.mark.parametrize("name", LAUNCHERS)
def test_launcher_mirrors_the_jax_one(name):
    """The port's launcher makes its JAX counterpart's `__main__` call, on
    names imported from the same modules of its own package."""
    assert len(LAUNCHERS) == 7 and sorted(p.name for p in JAX_DIR.glob("BEVFusion_*.py")) == LAUNCHERS
    call, imports = main_call(PORT_DIR / name)
    jax_call, jax_imports = main_call(JAX_DIR / name)
    assert ast.dump(call) == ast.dump(jax_call)
    assert {k: v.replace("unidistill_torch.", "unidistill_tpu.", 1) for k, v in imports.items()} == jax_imports
    kw = {k.arg: k.value.value for k in call.keywords}
    assert name == (launcher_file(kw["student"], kw["teacher"]) if kw
                    else launcher_file(call.args[0].func.id[: -len("_exp")]))


@pytest.mark.slow
def test_lidar_launcher_first_step_matches_jax(tmp_path, monkeypatch):
    """The JAX LiDAR launcher's `run_cli(lidar_exp())` and the port's, one
    step on the same frames (one JAX device, no loader workers, float32),
    the port started from the JAX trainer's initial weights: the loss and
    every per-task term the first step logs within the train-step parity
    tolerance (rtol 1e-4)."""
    import jax

    from unidistill_tpu.configs import nuscenes as jax_cfgs
    from unidistill_tpu.exps import base_cli as jax_base_cli
    from unidistill_tpu.training import loop as jax_loop

    from unidistill_torch.training import loop
    from unidistill_torch.training.jax_weights import state_dict_from_jax
    from tests.test_torch_lidar_detector import RAISED_CAPS

    root = build_synth_nusc(tmp_path / "nusc", N_FRAMES)
    monkeypatch.chdir(tmp_path)

    def exp(c, raise_caps):
        model = dataclasses.replace(c.tiny_model(with_camera=False), compute_dtype="float32")
        if raise_caps:
            model = dataclasses.replace(model, lidar_encoder=dataclasses.replace(model.lidar_encoder, **RAISED_CAPS))
        return c.ExpConfig(exp_name="tiny_lidar", model=model,
                           data=c.DataConfig(root_path=str(root), num_lidar_sweeps=2, use_cbgs=False),
                           train=c.TrainConfig(batch_size_per_device=BATCH, max_epochs=1))

    argv = ["-b", str(BATCH), "--num_workers", "0", "--exp_options", "train.eval_interval=2"]
    init = {}
    jax_init_state = jax_loop.Trainer.init_state

    def keep_init(self, *a, **kw):
        state = jax_init_state(self, *a, **kw)
        # on the host: the jitted step donates the state's buffers
        init["params"], init["stats"] = jax.device_get((state.params, state.batch_stats))
        return state

    monkeypatch.setattr(jax_loop.Trainer, "init_state", keep_init)
    monkeypatch.setattr(jax_base_cli, "Trainer",
                        lambda exp_cfg: jax_loop.Trainer(exp_cfg, devices=jax.devices()[:1]))
    monkeypatch.setattr(sys, "argv", ["lidar_exp"] + argv)
    jax_trainer = jax_base_cli.run_cli(exp(jax_cfgs, True))
    jax_step = [r for r in _records(jax_trainer.output_dir) if "step" in r][0]
    jax_trainer.metrics_file.close()

    params, stats = init["params"], init["stats"]
    port_init_state = loop.Trainer.init_state

    def from_jax(self, steps_per_epoch):
        out = port_init_state(self, steps_per_epoch)
        self.model.load_state_dict(state_dict_from_jax(params, stats, self.cfg), strict=True)
        return out

    monkeypatch.setattr(loop.Trainer, "init_state", from_jax)
    port_fit = loop.Trainer.fit

    def fit_after_a_draw(self, train_loader, *a, **kw):
        # the JAX Trainer's fit draws one batch for its init's shapes first,
        # which advances the loader's shuffle and the dataset's augmentation
        # generators; the port's init needs no batch: draw it here so that
        # both first steps train on the same frames
        next(iter(train_loader))
        return port_fit(self, train_loader, *a, **kw)

    monkeypatch.setattr(loop.Trainer, "fit", fit_after_a_draw)
    trainer = base_cli.run_cli(exp(cfgs, False), argv=argv + ["--device", "cpu"])
    step = [r for r in _records(trainer.output_dir) if "step" in r][0]
    assert step["step"] == jax_step["step"] == STEPS
    assert jax_step.pop("s0_slots_dropped") == 0  # no JAX cap bound
    metrics = sorted(set(jax_step) - {"step", "sec_per_step"})
    assert "loss" in metrics and "task_1/loc_loss" in metrics and set(metrics) <= set(step), sorted(step)
    print({k: (step[k], jax_step[k]) for k in metrics})
    for k in metrics:
        np.testing.assert_allclose(step[k], jax_step[k], rtol=1e-4, atol=1e-6, err_msg=k)
