"""Training and eval loop; the port's counterpart of the JAX package's
`training/loop.py` (itself the replacement of the reference's PyTorch
Lightning wiring, ref exps/base_cli.py:12-59, base_exp.py:19-187).

One `Trainer` owns the model on its device, the optimizer, the epoch loop,
metric logging (console + metrics.jsonl + tensorboardX when it is
installed), checkpoints (`training/checkpoint.py`) under a timestamped
output directory with a `latest` symlink, validation every `eval_interval`
epochs, and the eval path that writes `nuscenes_results.json` and scores it.

Data parallelism: under `torchrun` (or in a process group its caller has
made) the `Trainer` runs one rank a process, each on its own device
(`parallel.mesh.local_device`) with its rows of every global batch (the
loader's `rank` and `world_size`); its steps are the data-parallel steps of
`training/steps.py` over the group, the JAX package's `shard_map` over its
`dp` mesh. Every rank builds the same seeded weights, loads the same
checkpoint and teacher, and so holds the same parameters. All ranks share
rank 0's timestamped output directory (`parallel.mesh.broadcast_stamp`);
rank 0 alone writes `metrics.jsonl`, tensorboard, checkpoints and scores,
and a barrier follows each checkpoint. `predict` gathers every rank's
predictions in the global batches' order. Without a group (one process)
all of this is the identity.

Spatial sharding (`train.spatial_bev` = b > 1, the JAX Trainer's
`_compile_train_step_spatial`): the world of dp × b ranks splits into dp
shards of b bev peers (`parallel.mesh.spatial_groups`); each rank loads
its dp shard's rows of every global batch (`dp_rank`, `dp_size`: the
loader's rank and world), and the steps are those of `parallel/spatial.py`:
the BEV backbone and head split by rows over the peers, every BatchNorm
statistic global, the loss that of the global batch. `predict` runs the
spatial eval step and gathers each dp shard's frames once, in the global
batches' order. With b = 1 the steps are the data-parallel ones above.

`fit(profile_steps=(start, stop))` traces steps start..stop with
`torch.profiler` into `<output_dir>/profile/` (the JAX Trainer's
`jax.profiler` hook), one Chrome trace a rank. The JAX s0 slot-drop audit
has no counterpart: the port's LiDAR encoder keeps every active site, so
no frame loses slots to a cap.
"""
from __future__ import annotations

import datetime
import json
import math
import os
import time
from typing import Any, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from unidistill_torch.configs.nuscenes import ExpConfig
from unidistill_torch.layers.lidar_encoder import SubMConv
from unidistill_torch.models.bevfusion import BEVFusionCenterHead
from unidistill_torch.parallel import mesh as parallel
from unidistill_torch.parallel import spatial
from unidistill_torch.serving.predictor import resolve_device
from unidistill_torch.training import checkpoint as ckpt_lib
from unidistill_torch.training.steps import distill_train_step, eval_step, metrics_to_host, train_step
from unidistill_torch.training.train_state import TrainState, make_optimizer

BatchNorm = nn.modules.batchnorm._BatchNorm
# flax's truncated_normal variance scaling: a standard normal cut at ±2 has
# standard deviation 0.8796, which the initializer divides out
_TRUNC_STD = 0.87962566103423978
# a training step is logged (one metrics read-back) every this many steps
# and at each epoch's last step
PRINT_INTERVAL = 50


@torch.no_grad()
def init_params(model: nn.Module, seed: int) -> nn.Module:
    """Seeded initial weights, each tensor drawn as the JAX module's
    initializer draws it (from one `torch.Generator`, in module order):
      * sparse convs [K, Cin, Cout]: normal, std sqrt(2 / (K·Cin)) (the JAX
        encoder's `_kaiming`); their biases 0;
      * every dense conv: flax's default lecun_normal, a normal truncated
        at ±2 std with variance 1/fan_in, fan_in = the kernel's input
        channels × taps (the CenterHead's grouped out conv included: its
        `out_kernel_init` takes fan_in over (kh, kw, hc) too); biases 0;
      * the CenterHead's `out_bias`: the heatmap rows at `init_bias`, the
        rest 0 (`out_bias_init`, as the module builds it);
      * every linear layer (Swin's): lecun_normal as the convs, fan_in its
        input width; biases 0;
      * Swin's relative position bias tables: normal truncated at ±2 std,
        std 0.02 (flax's `truncated_normal(0.02)`);
      * BatchNorm and LayerNorm scale 1, bias 0, running statistics 0 and 1;
      * `awl_params` 1.
    Returns the model."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, SubMConv):
            K, cin, _ = mod.weight.shape
            mod.weight.normal_(0.0, math.sqrt(2.0 / (K * cin)), generator=g)
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
            w = mod.weight
            taps = w[0, 0].numel()
            fan_in = (w.shape[0] if isinstance(mod, nn.ConvTranspose2d) else w.shape[1]) * taps
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
        elif hasattr(mod, "relative_position_bias_table"):  # the leaf, as in random_state_dict
            nn.init.trunc_normal_(mod.relative_position_bias_table, 0.0, 0.02, -0.04, 0.04, generator=g)
            continue
        elif isinstance(mod, (BatchNorm, nn.LayerNorm)):
            mod.reset_parameters()
        else:
            continue
        if getattr(mod, "bias", None) is not None and not isinstance(mod, BatchNorm):
            mod.bias.zero_()
    model.awl_params.fill_(1.0)
    return model


def exp_output_dir(exp_name: str, group=None) -> str:
    """Timestamped dir under ./outputs/<exp_name> + `latest` symlink (ref
    base_exp.py:142-167); the ranks of `group` share rank 0's timestamp,
    and rank 0 makes the directory and the link."""
    stamp = parallel.broadcast_stamp(datetime.datetime.now().strftime("%Y-%m-%dT%H:%M:%S"), group)
    d = os.path.join("outputs", exp_name, stamp)
    if parallel.rank(group) == 0:
        os.makedirs(d, exist_ok=True)
        latest = os.path.join("outputs", exp_name, "latest")
        if os.path.islink(latest):
            os.unlink(latest)
        if not os.path.exists(latest):
            os.symlink(stamp, latest)
    parallel.barrier(group)
    return d


class Trainer:
    """device: "cuda" (each rank on `cuda:LOCAL_RANK` under a process group)
    or "cpu". Joins the process group already made, or makes one from
    `torchrun`'s environment (NCCL on the card, gloo on the CPU;
    `parallel.mesh.init_from_env`), and destroys at `close` one it made."""

    def __init__(self, exp_cfg: ExpConfig, output_dir: Optional[str] = None, device="cuda"):
        self.exp_cfg = exp_cfg
        self.cfg = exp_cfg.model
        made_group = not parallel.is_initialized()
        self.group = parallel.init_from_env(device)
        self._owns_group = made_group and self.group is not None
        self.rank, self.world_size = parallel.rank(self.group), parallel.world_size(self.group)
        sb = exp_cfg.train.spatial_bev
        self.spatial = parallel.spatial_groups(self.group, sb) if sb > 1 else None
        # the loader's rank and world: the dp shard (the rank without spatial sharding)
        self.dp_rank, self.dp_size = ((self.spatial.dp_rank, self.spatial.dp_size) if self.spatial
                                      else (self.rank, self.world_size))
        self.device = resolve_device(parallel.local_device(device) if self.group is not None else device)
        self.model = BEVFusionCenterHead(self.cfg)
        self.optimizer = None
        self.teacher = None
        self.output_dir = output_dir or exp_output_dir(exp_cfg.exp_name, self.group)
        self.metrics_file = None
        self._tb = None
        if self.rank != 0:
            return
        os.makedirs(self.output_dir, exist_ok=True)
        self.metrics_file = open(os.path.join(self.output_dir, "metrics.jsonl"), "a")
        try:
            from tensorboardX import SummaryWriter  # optional
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(os.path.join(self.output_dir, "tb"))

    # ---- init / state -------------------------------------------------------
    def init_state(self, steps_per_epoch: int) -> TrainState:
        """Seeded initial weights (`init_params`, `train.seed`) on the
        trainer's device, a fresh optimizer, step 0."""
        tcfg = self.exp_cfg.train
        init_params(self.model, tcfg.seed).to(self.device)
        self.optimizer = make_optimizer(self.model, tcfg, steps_per_epoch)
        n_params = sum(p.numel() for p in self.model.parameters())
        self.log({"event": "init", "n_params": n_params})
        return TrainState()

    def restore(self, state: TrainState, path: str, with_optimizer: bool = True) -> None:
        """Load a checkpoint (step dir or its parent) into the model, the
        optimizer (when the checkpoint has its state) and `state`."""
        payload = ckpt_lib.restore_checkpoint_any(path)
        self.model.load_state_dict(payload["model"])
        if with_optimizer and "optimizer" in payload:
            self.optimizer.load_state_dict(payload["optimizer"])
        state.step = int(payload["step"])

    def close(self):
        """Release the metrics file / tensorboard writer, and the process
        group where the trainer made it."""
        if self.metrics_file is not None and not self.metrics_file.closed:
            self.metrics_file.close()
        if self._tb is not None:
            self._tb.close()
        if self._owns_group and parallel.is_initialized():
            torch.distributed.destroy_process_group()
            self._owns_group = False

    # ---- logging (rank 0) -------------------------------------------------------
    def log(self, rec: Dict[str, Any]):
        if self.metrics_file is None:
            return
        rec = {k: (float(v) if isinstance(v, (np.floating, torch.Tensor)) else v) for k, v in rec.items()}
        self.metrics_file.write(json.dumps(rec) + "\n")
        self.metrics_file.flush()

    def log_metrics(self, step: int, metrics: Dict[str, float]):
        self.log({"step": step, **metrics})
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)

    def save_checkpoint(self, step: int, keep_latest: Optional[int] = None) -> None:
        """Rank 0 saves the model and optimizer as `ckpt/step_<step>`; every
        rank waits for it."""
        if self.rank == 0:
            ckpt_lib.save_checkpoint(os.path.join(self.output_dir, "ckpt"), step, self.model, self.optimizer,
                                     keep_latest=keep_latest)
        parallel.barrier(self.group)

    def on_rank0(self, fn):
        """`fn()` on rank 0, its result (or the exception it raised) on every
        rank of the group."""
        if self.group is None:
            return fn()
        ok, out = True, None
        if self.rank == 0:
            try:
                out = fn()
            except Exception as e:  # re-raised on every rank below
                ok, out = False, e
        ok, out = parallel.broadcast_object((ok, out), self.group)
        if not ok:
            raise out
        return out

    # ---- train step ----------------------------------------------------------
    def train_step(self, state: TrainState, batch, teacher=None) -> Dict[str, torch.Tensor]:
        """One step of the model on this rank's rows `batch`, data-parallel
        over the trainer's group (or spatially sharded); `teacher` (model,
        cfg, dcfg) for distillation."""
        if self.spatial is not None:
            if teacher is None:
                return spatial.train_step_spatial(state, batch, self.model, self.optimizer, self.cfg, self.spatial)
            t_model, t_cfg, dcfg = teacher
            return spatial.distill_train_step_spatial(state, batch, self.model, t_model, self.optimizer, self.cfg,
                                                      t_cfg, dcfg, self.spatial)
        if teacher is None:
            return train_step(state, batch, self.model, self.optimizer, self.cfg, self.group)
        t_model, t_cfg, dcfg = teacher
        return distill_train_step(state, batch, self.model, t_model, self.optimizer, self.cfg, t_cfg, dcfg,
                                  self.group)

    # ---- fit ------------------------------------------------------------------
    def fit(self, train_loader, max_epochs: int, resume_from: Optional[str] = None, teacher=None,
            val_loader=None, val_dataset=None, eval_interval: int = 1,
            profile_steps: Optional[tuple] = None) -> TrainState:
        """teacher: optional (model, cfg, dcfg) for distillation training,
        the model frozen on the trainer's device.

        val_loader/val_dataset/eval_interval: the submission + scoring path
        on the validation split every `eval_interval` epochs (ref
        base_cli.py:53-58, …base_exp.py:406-417); none without a loader.

        A step is logged every `PRINT_INTERVAL` steps and at each epoch's
        last one (so short epochs still record a loss). A logged step records its metrics (one read-back from the device),
        `sec_per_step` and `loader_wait_sec_per_step` (the host's wait for
        the next batch), averaged over the steps since the last log.

        profile_steps: (start, stop): a `torch.profiler` trace of the steps
        from `start` through `stop` (global step numbers) in
        `<output_dir>/profile/`, one `trace_rank<r>.json` a rank."""
        steps_per_epoch = len(train_loader)
        state = self.init_state(steps_per_epoch)
        if resume_from:
            self.restore(state, resume_from)
        self.teacher = teacher[0] if teacher is not None else None

        step = last_logged = state.step
        # resume epoch accounting: a restored step means those epochs are
        # already trained; run only the remainder
        start_epoch = min(step // max(steps_per_epoch, 1), max_epochs)
        for epoch in range(start_epoch, max_epochs):
            t0 = time.perf_counter()
            wait = 0.0
            epoch_end = step + steps_per_epoch
            batches = iter(train_loader)
            while True:
                tw = time.perf_counter()
                batch = next(batches, None)
                wait += time.perf_counter() - tw
                if batch is None:
                    break
                if profile_steps and state.step == profile_steps[0]:
                    prof = self._start_profile()
                metrics = self.train_step(state, batch, teacher)
                if profile_steps and state.step - 1 == profile_steps[1]:
                    self._stop_profile(prof)
                step = state.step
                if self.rank == 0 and (step % PRINT_INTERVAL == 0 or step == epoch_end):
                    m = metrics_to_host(metrics)
                    n = max(step - last_logged, 1)
                    m["sec_per_step"] = (time.perf_counter() - t0) / n
                    m["loader_wait_sec_per_step"] = wait / n
                    t0, wait, last_logged = time.perf_counter(), 0.0, step
                    self.log_metrics(step, m)
                    print(f"epoch {epoch} step {step} loss {m['loss']:.4f} "
                          f"({m['sec_per_step']:.3f}s/it, loader wait "
                          f"{m['loader_wait_sec_per_step']:.3f}s/it)", flush=True)
            self.save_checkpoint(step, keep_latest=self.exp_cfg.train.num_keep_latest_ckpt)
            if val_loader is not None and (epoch + 1) % eval_interval == 0:
                self.validate(val_loader, val_dataset, epoch=epoch)
        return state

    def _start_profile(self):
        activities = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=activities)
        prof.start()
        return prof

    def _stop_profile(self, prof) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        prof.stop()
        out = os.path.join(self.output_dir, "profile")
        os.makedirs(out, exist_ok=True)
        prof.export_chrome_trace(os.path.join(out, f"trace_rank{self.rank}.json"))

    def validate(self, val_loader, val_dataset, epoch=None):
        """Epoch-boundary validation: the validation split's submission,
        scored."""
        t0 = time.time()
        try:
            res = self.evaluate(val_loader, val_dataset)
            rec = {"event": "val", "epoch": epoch, **(res or {})}
        except (ImportError, FileNotFoundError) as e:
            # devkit / data root absent: log and continue training.
            # Anything else (token misalignment, eval-path bug) fails loudly.
            rec = {"event": "val", "epoch": epoch, "eval_error": str(e)}
        rec["val_sec"] = time.time() - t0
        self.log(rec)
        if self.rank == 0:
            print(f"val[{epoch}]: " + json.dumps(rec), flush=True)
        return rec

    # ---- evaluate --------------------------------------------------------------
    def predict(self, loader) -> List[Dict]:
        """Run the eval step over a loader, the model in eval mode; returns
        per-frame prediction dicts (numpy) with the padding stripped, labels
        0-based and the frame's `meta` (ref …base_exp.py:419-434). Under a
        group every rank returns every rank's frames, gathered and put in
        the global batches' order (JAX `predict`'s multihost gather): rank
        r's share of each global batch follows rank r - 1's. Spatially
        sharded, each dp shard's frames are gathered once (over the ranks
        of this rank's bev index)."""
        self.model.eval()
        local: List[List[Dict]] = []
        for batch in loader:
            frames: List[Dict] = []
            if batch:  # a rank's share of a short last global batch may be empty
                rois = (eval_step(self.model, batch, self.cfg) if self.spatial is None
                        else spatial.eval_step_spatial(self.model, batch, self.cfg, self.spatial))
                rois = {k: v.cpu().numpy() for k, v in rois.items()}
                for b in range(rois["boxes"].shape[0]):
                    m = rois["mask"][b]
                    frames.append(dict(boxes=rois["boxes"][b][m], scores=rois["scores"][b][m],
                                       labels=rois["labels"][b][m] - 1, meta=batch["meta"][b]))
            local.append(frames)
        group = self.group if self.spatial is None else self.spatial.dp
        return [f for frames in parallel.all_gather_host_objects(local, group=group) for f in frames]

    def evaluate(self, loader, dataset) -> Optional[Dict]:
        """Predict the validation split, write its submission and score it
        (the nuScenes devkit where it is installed, else the native
        scorer); under a group rank 0 writes and scores, and every rank
        returns its scores."""
        from unidistill_torch.data.evaluate import generate_submission, run_detection_eval

        preds = self.predict(loader)
        infos = dataset.infos[: len(preds)]
        # hard alignment check: predict() order must match dataset.infos —
        # true for unshuffled eval loaders (CBGS is train-only); a shuffled
        # loader fails here instead of mis-tokening every frame
        for p, info in zip(preds, infos):
            ptok = p.get("meta", {}).get("token")
            itok = info.get("sample_token")
            if not (ptok is None or itok is None or ptok == itok):
                raise ValueError(f"prediction/info token mismatch: {ptok} vs {itok}: "
                                 "the eval loader must be unshuffled")
        def score():
            result_dir = os.path.join(self.output_dir, "nuscenes")
            path = generate_submission(preds, infos, result_dir)
            dcfg = self.exp_cfg.data
            metrics = run_detection_eval(path, result_dir, eval_set="val",
                                         version=dcfg.nusc_version, dataroot=dcfg.root_path)
            if metrics is None:
                # devkit absent: the native detection_cvpr_2019 scorer
                # against the info-pkl GT (data/detection_eval.py)
                from unidistill_torch.data.detection_eval import evaluate_submission_native

                metrics = evaluate_submission_native(
                    path, infos, output_path=os.path.join(result_dir, "metrics_summary.json"))
            return metrics

        return self.on_rank0(score)
