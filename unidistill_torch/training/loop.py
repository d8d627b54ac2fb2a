"""Training and eval loop; the port's counterpart of the JAX package's
`training/loop.py` (itself the replacement of the reference's PyTorch
Lightning wiring, ref exps/base_cli.py:12-59, base_exp.py:19-187).

One `Trainer` owns the model on its device, the optimizer, the epoch loop,
metric logging (console + metrics.jsonl + tensorboardX when it is
installed), checkpoints (`training/checkpoint.py`) under a timestamped
output directory with a `latest` symlink, validation every `eval_interval`
epochs, and the eval path that writes `nuscenes_results.json` and scores it.

One process, one card: the JAX package's device mesh, spatial sharding,
profiler hook and multihost gathers have no counterpart here yet. Neither
has its s0 slot-drop audit: the port's LiDAR encoder keeps every active
site, so no frame loses slots to a cap.
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
      * BatchNorm scale 1, bias 0, running statistics 0 and 1;
      * `awl_params` 1.
    Returns the model."""
    g = torch.Generator().manual_seed(seed)
    for mod in model.modules():
        if isinstance(mod, SubMConv):
            K, cin, _ = mod.weight.shape
            mod.weight.normal_(0.0, math.sqrt(2.0 / (K * cin)), generator=g)
        elif isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d)):
            w = mod.weight
            taps = w.shape[2] * w.shape[3]
            fan_in = (w.shape[0] if isinstance(mod, nn.ConvTranspose2d) else w.shape[1]) * taps
            std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
            nn.init.trunc_normal_(w, 0.0, std, -2.0 * std, 2.0 * std, generator=g)
        elif isinstance(mod, BatchNorm):
            mod.reset_parameters()
        else:
            continue
        if getattr(mod, "bias", None) is not None and not isinstance(mod, BatchNorm):
            mod.bias.zero_()
    model.awl_params.fill_(1.0)
    return model


def exp_output_dir(exp_name: str) -> str:
    """Timestamped dir under ./outputs/<exp_name> + `latest` symlink (ref
    base_exp.py:142-167)."""
    stamp = datetime.datetime.now().strftime("%Y-%m-%dT%H:%M:%S")
    d = os.path.join("outputs", exp_name, stamp)
    os.makedirs(d, exist_ok=True)
    latest = os.path.join("outputs", exp_name, "latest")
    if os.path.islink(latest):
        os.unlink(latest)
    if not os.path.exists(latest):
        os.symlink(stamp, latest)
    return d


class Trainer:
    def __init__(self, exp_cfg: ExpConfig, output_dir: Optional[str] = None, device="cuda"):
        self.exp_cfg = exp_cfg
        self.cfg = exp_cfg.model
        self.device = resolve_device(device)
        self.model = BEVFusionCenterHead(self.cfg)
        self.optimizer = None
        self.teacher = None
        self.output_dir = output_dir or exp_output_dir(exp_cfg.exp_name)
        os.makedirs(self.output_dir, exist_ok=True)
        self.metrics_file = open(os.path.join(self.output_dir, "metrics.jsonl"), "a")
        self._tb = None
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
        """Release the metrics file / tensorboard writer."""
        if not self.metrics_file.closed:
            self.metrics_file.close()
        if self._tb is not None:
            self._tb.close()

    # ---- logging -------------------------------------------------------------
    def log(self, rec: Dict[str, Any]):
        rec = {k: (float(v) if isinstance(v, (np.floating, torch.Tensor)) else v) for k, v in rec.items()}
        self.metrics_file.write(json.dumps(rec) + "\n")
        self.metrics_file.flush()

    def log_metrics(self, step: int, metrics: Dict[str, float]):
        self.log({"step": step, **metrics})
        if self._tb is not None:
            for k, v in metrics.items():
                self._tb.add_scalar(k, v, step)

    # ---- fit ------------------------------------------------------------------
    def fit(self, train_loader, max_epochs: int, resume_from: Optional[str] = None, teacher=None,
            val_loader=None, val_dataset=None, eval_interval: int = 1) -> TrainState:
        """teacher: optional (model, cfg, dcfg) for distillation training,
        the model frozen on the trainer's device.

        val_loader/val_dataset/eval_interval: the submission + scoring path
        on the validation split every `eval_interval` epochs (ref
        base_cli.py:53-58, …base_exp.py:406-417); none without a loader.

        A step is logged every `PRINT_INTERVAL` steps and at each epoch's
        last one (so short epochs still record a loss). A logged step records its metrics (one read-back from the device),
        `sec_per_step` and `loader_wait_sec_per_step` (the host's wait for
        the next batch), averaged over the steps since the last log."""
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
                if teacher is None:
                    metrics = train_step(state, batch, self.model, self.optimizer, self.cfg)
                else:
                    t_model, t_cfg, dcfg = teacher
                    metrics = distill_train_step(state, batch, self.model, t_model, self.optimizer,
                                                 self.cfg, t_cfg, dcfg)
                step = state.step
                if step % PRINT_INTERVAL == 0 or step == epoch_end:
                    m = metrics_to_host(metrics)
                    n = max(step - last_logged, 1)
                    m["sec_per_step"] = (time.perf_counter() - t0) / n
                    m["loader_wait_sec_per_step"] = wait / n
                    t0, wait, last_logged = time.perf_counter(), 0.0, step
                    self.log_metrics(step, m)
                    print(f"epoch {epoch} step {step} loss {m['loss']:.4f} "
                          f"({m['sec_per_step']:.3f}s/it, loader wait "
                          f"{m['loader_wait_sec_per_step']:.3f}s/it)", flush=True)
            ckpt_lib.save_checkpoint(os.path.join(self.output_dir, "ckpt"), step, self.model,
                                     self.optimizer, keep_latest=self.exp_cfg.train.num_keep_latest_ckpt)
            if val_loader is not None and (epoch + 1) % eval_interval == 0:
                self.validate(val_loader, val_dataset, epoch=epoch)
        return state

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
        print(f"val[{epoch}]: " + json.dumps(rec), flush=True)
        return rec

    # ---- evaluate --------------------------------------------------------------
    def predict(self, loader) -> List[Dict]:
        """Run the eval step over a loader, the model in eval mode; returns
        per-frame prediction dicts (numpy) with the padding stripped, labels
        0-based and the frame's `meta` (ref …base_exp.py:419-434)."""
        self.model.eval()
        out: List[Dict] = []
        for batch in loader:
            rois = {k: v.cpu().numpy() for k, v in eval_step(self.model, batch, self.cfg).items()}
            for b in range(rois["boxes"].shape[0]):
                m = rois["mask"][b]
                out.append(dict(boxes=rois["boxes"][b][m], scores=rois["scores"][b][m],
                                labels=rois["labels"][b][m] - 1, meta=batch["meta"][b]))
        return out

    def evaluate(self, loader, dataset) -> Optional[Dict]:
        """Predict the validation split, write its submission and score it
        (the nuScenes devkit where it is installed, else the native
        scorer)."""
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
        result_dir = os.path.join(self.output_dir, "nuscenes")
        path = generate_submission(preds, infos, result_dir)
        dcfg = self.exp_cfg.data
        metrics = run_detection_eval(path, result_dir, eval_set="val",
                                     version=dcfg.nusc_version, dataroot=dcfg.root_path)
        if metrics is None:
            # devkit absent: the native detection_cvpr_2019 scorer against
            # the info-pkl GT (data/detection_eval.py)
            from unidistill_torch.data.detection_eval import evaluate_submission_native

            metrics = evaluate_submission_native(
                path, infos, output_path=os.path.join(result_dir, "metrics_summary.json"))
        return metrics
