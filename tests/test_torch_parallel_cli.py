"""The port's data parallelism on the CPU, without JAX: worlds of two gloo
ranks spawned by `parallel.launch.run_ranks`.

  * the eval gather: a 2-rank `Trainer.predict` over an odd number of tiny
    frames (the last global batch short, one rank's share of it empty)
    equals the one-process `predict`, frame for frame, bit for bit;
  * the camera<-LiDAR launcher over two ranks on the synthetic on-disk
    mini-nuScenes: one epoch, then a resume to two with validation; one
    output directory, one metrics.jsonl, one checkpoint an epoch, the
    parameters equal on both ranks, rank 0's model equal to the last
    checkpoint;
  * a LiDAR-student pair (LiDAR<-camera, K4's input gradient and K6 in
    their plain versions under the gradient average): both ranks hold the
    same parameters bit for bit, and the logged loss is the mean of the
    ranks' totals;
  * a world fails loudly: a rank that raises, or one that hangs, ends the
    world with an error instead of blocking the suite.

The rank-side functions (`rank_*`) live here, in a module that imports no
JAX, so that a spawned rank imports only the port; `tests/test_torch_parallel.py`
(the port against the JAX package) uses them too. Every world has a join
timeout, and every rank runs two intra-op threads.
"""
import dataclasses
import json
import os
import pickle
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from unidistill_torch.configs import nuscenes as cfgs
from unidistill_torch.parallel import mesh as parallel
from unidistill_torch.parallel.launch import run_ranks

# seconds a test's world may take before it is killed
WORLD_TIMEOUT_S = 420
THREADS = 2
PREDICT_FRAMES = 5  # odd: global batches of 4 leave a short last one
LAUNCHER_FRAMES = 4


def rows(tree, rank, b):
    """Rank `rank`'s rows [rank·b, (rank+1)·b) of a batch (nested dicts of
    arrays; lists as they are)."""
    if isinstance(tree, dict):
        return {k: rows(v, rank, b) for k, v in tree.items()}
    return tree[rank * b : (rank + 1) * b]


def to_numpy(sd):
    return {k: v.detach().cpu().numpy() for k, v in sd.items()}


def from_numpy(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def nchw(a):
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(np.asarray(a), -1, 1)))


def port_loss(name, args, group, voxel_size, response_args):
    """One of the six normalised losses on (NHWC numpy) `args`, its
    normaliser `pmean`'d over `group`."""
    from unidistill_torch.losses import det as pdet
    from unidistill_torch.losses import distill as pdist

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a))

    if name == "focal":
        return pdet.focal_loss(t(args[0]), t(args[1]), 0.25, 2.0, group)
    if name == "reg":
        return pdet.reg_loss(nchw(args[0]), t(args[1]), t(args[2]), t(args[3]), group)
    if name == "iou":
        return pdet.iou_losses(nchw(args[0]), t(args[1]), t(args[2]), t(args[3]), 8, voxel_size, group)
    if name in ("feature", "bev_rel"):
        fn = pdist.feature_distill_loss if name == "feature" else pdist.bev_distill_loss
        return fn(nchw(args[0]), nchw(args[1]), t(args[2]), t(args[3]), group)
    student, teacher, gt = args
    return pdist.response_distill_loss([{k: nchw(v) for k, v in h.items()} for h in student],
                                       [{k: nchw(v) for k, v in h.items()} for h in teacher],
                                       t(gt), *response_args, group=group)


def rank_losses(rank, inputs, per_rank, voxel_size, response_args):
    """{(case, loss): value} of each case's losses (`inputs[case][name]`,
    the whole batch) on this rank's `per_rank` rows."""
    group = parallel.init_from_env("cpu")
    out = {}
    for case, losses in inputs.items():
        for name, args in losses.items():
            if name == "response":
                mine = tuple([rows(h, rank, per_rank) for h in heads] for heads in args[:2]) \
                    + (rows(args[2], rank, per_rank),)
            else:
                mine = tuple(rows(a, rank, per_rank) for a in args)
            got = port_loss(name, mine, group, voxel_size, response_args)
            out[case, name] = np.asarray([x.item() for x in got] if isinstance(got, tuple) else got.numpy())
    return out


def distill_step_on_ranks(rank, s_cfg, t_cfg, s_sd, t_sd, batch, pair, train_cfg, per_rank):
    """One distill step of the student on this rank's rows of `batch`
    (`per_rank` frames), data-parallel over the default group; returns the
    host metrics, the averaged gradients before the clip, the student's new
    state and its local total."""
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.training.steps import distill_train_step, metrics_to_host
    from unidistill_torch.training.train_state import TrainState, make_optimizer

    group = parallel.init_from_env("cpu")
    assert group is not None and parallel.world_size(group) == 2
    student = BEVFusionCenterHead(s_cfg)
    student.load_state_dict(from_numpy(s_sd))
    teacher = BEVFusionCenterHead(t_cfg)
    teacher.load_state_dict(from_numpy(t_sd))
    teacher.requires_grad_(False)
    opt = make_optimizer(student, train_cfg)
    dcfg = cfgs.DISTILL_VARIANTS[pair]
    m = metrics_to_host(distill_train_step(TrainState(), rows(batch, rank, per_rank), student, teacher, opt,
                                           s_cfg, t_cfg, dcfg, group))
    unclip = max(1.0, m["grad_norm"] / opt.grad_clip)  # .grad holds the clipped average
    total = m["loss_det"] + dcfg.w_feature * m["loss_feature"] + dcfg.w_rel * m["loss_bev_rel"] \
        + dcfg.w_resp * (m["loss_resp_cls"] + m["loss_resp_reg"])
    return dict(metrics=m, local_total=total, state=to_numpy(student.state_dict()),
                grads={k: (p.grad * unclip).numpy() for k, p in student.named_parameters()},
                teacher_grads=[p.grad is None for p in teacher.parameters()])


def _tiny_exp(root, with_lidar, with_camera, name, batch=1):
    return cfgs.ExpConfig(
        exp_name=name,
        model=cfgs.tiny_model(with_lidar=with_lidar, with_camera=with_camera),
        data=cfgs.DataConfig(root_path=root, num_lidar_sweeps=2, use_cbgs=False),
        train=cfgs.TrainConfig(batch_size_per_device=batch, max_epochs=1),
    )


def _patch_tiny_exps(root):
    cfgs.lidar_exp = lambda: _tiny_exp(root, True, False, "tiny_lidar")
    cfgs.camera_exp = lambda: _tiny_exp(root, False, True, "tiny_camera")
    cfgs.fusion_exp = lambda: _tiny_exp(root, True, True, "tiny_fusion")


def predict_with_trainer(root, out_dir, batch):
    """The tiny camera detector's seeded weights, `predict` over the
    validation split at `batch` frames a rank; the trainer joins the group
    of its process, if there is one."""
    from unidistill_torch.data.collate import DataLoader
    from unidistill_torch.data.dataset import NuScenesDataset
    from unidistill_torch.training.loop import Trainer

    exp = _tiny_exp(root, False, True, "tiny_camera", batch)
    trainer = Trainer(exp, output_dir=out_dir, device="cpu")
    try:
        trainer.init_state(steps_per_epoch=1)
        ds = NuScenesDataset(exp.data, exp.model, "validation", seed=0)
        dl = DataLoader(ds, batch, rank=trainer.rank, world_size=trainer.world_size)
        return trainer.world_size, len(dl), trainer.predict(dl)
    finally:
        trainer.close()


def rank_predict(rank, root, out_dir, batch):
    return predict_with_trainer(root, out_dir, batch)


def rank_launcher(rank, workdir, root, teacher_ckpt):
    """The camera<-LiDAR launcher's CLI: one epoch, then a resume to two
    with validation at its end."""
    from unidistill_torch.exps.distill_cli import run_distill_cli

    os.chdir(workdir)
    _patch_tiny_exps(root)
    common = ["-b", "1", "--num_workers", "0", "--device", "cpu", "--teacher_ckpt", teacher_ckpt,
              "--exp_options", "train.eval_interval=2"]
    tr1 = run_distill_cli("lidar", "camera", argv=common + ["--max_epochs", "1"])
    tr2 = run_distill_cli("lidar", "camera", argv=common + [
        "--max_epochs", "2", "--ckpt_path", os.path.join(tr1.output_dir, "ckpt")])
    return dict(world=(tr1.world_size, tr2.world_size), rank=(tr1.rank, tr2.rank),
                out=(os.path.abspath(tr1.output_dir), os.path.abspath(tr2.output_dir)),
                state=to_numpy(tr2.model.state_dict()),
                params=sorted(n for n, _ in tr2.model.named_parameters()))


def rank_trainer_from_env(rank, out_dir):
    """A `Trainer` where no group exists yet: it makes one from the
    environment (gloo for the CPU), as under `torchrun`, and destroys it at
    `close`."""
    from unidistill_torch.training.loop import Trainer

    assert not parallel.is_initialized()
    trainer = Trainer(_tiny_exp(out_dir, False, True, "tiny_camera"), output_dir=out_dir, device="cpu")
    made = (torch.distributed.get_backend(trainer.group), trainer.rank, trainer.world_size, str(trainer.device))
    stamp = parallel.broadcast_stamp(f"stamp{rank}", trainer.group)
    trainer.close()
    return made, stamp, parallel.is_initialized()


def rank_fails(rank):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()  # rank 0 waits for a peer that is gone


def rank_hangs(rank):
    time.sleep(3600)


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(THREADS)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def synth_root(tmp_path_factory):
    from tests.test_data_pipeline import build_synth_nusc  # the JAX package's test helper

    return build_synth_nusc(tmp_path_factory.mktemp("nusc_dp"), PREDICT_FRAMES)


def test_one_process_is_the_identity():
    """Without a process group the collectives are the identity."""
    x = torch.tensor(3.0)
    assert parallel.pmean(x, None) is x
    p = torch.nn.Parameter(torch.ones(3))
    p.grad = torch.full((3,), 2.0)
    parallel.average_gradients([p], None)
    assert torch.equal(p.grad, torch.full((3,), 2.0))
    assert parallel.broadcast_stamp("2026", None) == "2026"
    assert parallel.all_gather_host_objects([[1], [2, 3]], group=None) == [[1], [2, 3]]
    assert parallel.init_from_env("cpu") is None and parallel.world_size() == 1 and parallel.rank() == 0
    assert parallel.local_device("cpu") == torch.device("cpu")


def test_gradient_buckets_keep_order_and_dtype(monkeypatch):
    monkeypatch.setattr(parallel, "BUCKET_BYTES", 64)
    ps = [torch.zeros(10), torch.zeros(10), torch.zeros(3, dtype=torch.float64), torch.zeros(20), torch.zeros(1)]
    buckets = parallel._buckets(ps)
    assert [len(b) for b in buckets] == [2, 1, 1, 1]
    assert [p for b in buckets for p in b] == ps


def test_eval_gather_equals_one_process(synth_root, tmp_path):
    """Two ranks at 2 frames each over 5 frames: global batches [0-3] and
    [4], rank 1's share of the last empty; the gathered predictions equal
    the one-process predictions at batch 2, in order and bit for bit."""
    world, n_batches, ref = predict_with_trainer(synth_root, str(tmp_path / "one"), 2)
    assert world == 1 and n_batches == 3
    assert [p["meta"]["token"] for p in ref] == [f"tok{i}" for i in range(PREDICT_FRAMES)]
    got = run_ranks(rank_predict, 2, (synth_root, str(tmp_path / "dp"), 2), timeout_s=WORLD_TIMEOUT_S,
                    threads=THREADS)
    for world, n_batches, preds in got:
        assert world == 2 and n_batches == 2
        assert len(preds) == len(ref)
        for p, r in zip(preds, ref):
            assert p["meta"] == r["meta"]
            for k in ("boxes", "scores", "labels"):
                np.testing.assert_array_equal(p[k], r[k], err_msg=k)
    assert sum(len(p["scores"]) for p in ref) > 0


def test_launcher_over_two_ranks_trains_resumes_and_validates(synth_root, tmp_path):
    """`run_distill_cli` on each of two ranks at `-b 1` (global batch 2):
    both ranks share one output directory a run; rank 0's metrics.jsonl
    logs 2 steps an epoch; one checkpoint an epoch; the resumed run trains
    the second epoch and validates; the trained parameters are equal on both
    ranks and rank 0's model (with its BatchNorm statistics) to the last
    checkpoint."""
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead
    from unidistill_torch.training import checkpoint as ckpt_lib
    from unidistill_torch.training.loop import init_params

    root = str(tmp_path / "nusc")
    shutil.copytree(synth_root, root)
    for split in ("train", "val"):  # four frames: two global batches of 2 an epoch
        with open(os.path.join(root, f"{split}_info.pkl"), "rb") as f:
            infos = pickle.load(f)
        with open(os.path.join(root, f"{split}_info.pkl"), "wb") as f:
            pickle.dump(infos[:LAUNCHER_FRAMES], f)
    teacher = init_params(BEVFusionCenterHead(cfgs.tiny_model(with_camera=False)), seed=5)
    ckpt_lib.save_checkpoint(str(tmp_path / "teacher"), 0, teacher)
    work = tmp_path / "work"
    work.mkdir()
    got = run_ranks(rank_launcher, 2, (str(work), root, str(tmp_path / "teacher" / "step_0")),
                    timeout_s=WORLD_TIMEOUT_S, threads=THREADS)
    assert [g["world"] for g in got] == [(2, 2)] * 2 and [g["rank"] for g in got] == [(0, 0), (1, 1)]
    assert got[0]["out"] == got[1]["out"]
    out1, out2 = got[0]["out"]
    assert out1 != out2
    exp_dir = work / "outputs" / "BEVFusion_nuscenes_centerhead_camera_exp_distill_lidar"
    assert sorted(os.listdir(exp_dir)) == sorted(["latest", Path(out1).name, Path(out2).name])
    steps_per_epoch = LAUNCHER_FRAMES // 2
    for out, epochs in ((out1, 1), (out2, 2)):
        # (tb/: tensorboard, where tensorboardX is installed)
        assert sorted(set(os.listdir(out)) - {"tb"}) == ["ckpt", "metrics.jsonl"] + (["nuscenes"] if epochs == 2 else [])
        assert sorted(os.listdir(os.path.join(out, "ckpt"))) == [f"step_{epochs * steps_per_epoch}"]
        with open(os.path.join(out, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        assert [r["step"] for r in recs if "step" in r] == [epochs * steps_per_epoch]
        assert [r["event"] for r in recs if "event" in r] == ["init"] + (["val"] if epochs == 2 else [])
    val = recs[-1]
    assert val["epoch"] == 1 and "eval_error" not in val and np.isfinite(val["nd_score"])
    saved = ckpt_lib.restore_checkpoint_any(os.path.join(out2, "ckpt"))["model"]
    for k, v in got[0]["state"].items():
        np.testing.assert_array_equal(saved[k].numpy(), v, err_msg=k)  # rank 0's, statistics included
    for k in got[0]["params"]:
        np.testing.assert_array_equal(got[1]["state"][k], got[0]["state"][k], err_msg=k)
    # each rank keeps the BatchNorm statistics of its own rows, as each JAX device does
    assert any(not np.array_equal(got[1]["state"][k], v) for k, v in got[0]["state"].items()
               if k.endswith("running_mean"))


def test_lidar_student_pair_over_two_ranks():
    """LiDAR<-camera, tiny f32, global batch 4 over two ranks: the sparse
    convs' backward (K4 over the transposed map, K6; plain versions on the
    CPU) under the gradient average. Both ranks end with the same
    parameters bit for bit; the logged loss is the mean of the ranks'
    totals (rtol 1e-6: the totals are summed again on the host in float64)."""
    from unidistill_torch.serving.synthetic import random_state_dict, train_batch

    s_cfg = dataclasses.replace(cfgs.tiny_model(with_camera=False), compute_dtype="float32")
    t_cfg = dataclasses.replace(cfgs.tiny_model(with_lidar=False), compute_dtype="float32")
    batch = train_batch(t_cfg, s_cfg, 4, seed=7)
    got = run_ranks(distill_step_on_ranks, 2,
                    (s_cfg, t_cfg, to_numpy(random_state_dict(s_cfg, seed=1)),
                     to_numpy(random_state_dict(t_cfg, seed=2)), batch, ("camera", "lidar"),
                     cfgs.distill_exp("camera", "lidar").train, 2),
                    timeout_s=WORLD_TIMEOUT_S, threads=THREADS)
    for k in got[0]["grads"]:  # the parameters; each rank keeps its own BatchNorm statistics
        np.testing.assert_array_equal(got[1]["state"][k], got[0]["state"][k], err_msg=k)
    totals = [g["local_total"] for g in got]
    assert totals[0] != totals[1]
    for g in got:
        np.testing.assert_allclose(g["metrics"]["loss"], np.mean(totals), rtol=1e-6)
        assert all(g["teacher_grads"])
    assert any(np.abs(g).max() > 0 for k, g in got[0]["grads"].items() if "lidar_encoder" in k)


def test_trainer_makes_its_group_from_the_environment(tmp_path):
    got = run_ranks(rank_trainer_from_env, 2, (str(tmp_path),), timeout_s=WORLD_TIMEOUT_S, threads=1,
                    init_group=False)
    assert got == [(("gloo", r, 2, "cpu"), "stamp0", False) for r in range(2)]


def test_a_failing_rank_fails_the_world():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 fails on purpose"):
        run_ranks(rank_fails, 2, timeout_s=60, threads=1)
    assert time.monotonic() - t0 < 60


def test_a_hanging_rank_times_out():
    with pytest.raises(TimeoutError):
        run_ranks(rank_hangs, 2, timeout_s=8, threads=1)
