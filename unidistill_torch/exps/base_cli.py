"""Experiment CLI; the port's counterpart of the JAX package's
`exps/base_cli.py`, with the reference's `run_cli` ergonomics
(ref exps/base_cli.py:12-59; DictAction utils/__init__.py:4-93):

  python …_exp.py                   # train
  python …_exp.py -e --ckpt_path X  # evaluate on val
  python …_exp.py -p --ckpt_path X  # predict on test (submission dump)
  flags: -b/--batch_size_per_device, --max_epochs, --seed, --ckpt_path,
         --data_root, --num_workers, --exp_options k.l=v (nested config
         overrides), --device (default cuda; cpu to run on the CPU).

Outputs go under ./outputs/<exp_name>/<timestamp>/ (a `latest` symlink
beside): metrics.jsonl, ckpt/step_N/, nuscenes/ (the scored submission),
nuscenes_submission/ (-p: the submission and boxes.pkl).

Over N ranks: `torchrun --nproc_per_node N …_exp.py` (NCCL, a card a rank;
gloo with --device cpu). Each rank loads `-b` frames of every global batch
of `-b` × N (the JAX CLI's global batch over its devices); the ranks share
one output directory, which rank 0 writes. With `--exp_options
train.spatial_bev=b` the N ranks are N / b dp shards of b ranks that
split the BEV grid by rows (`parallel/spatial.py`): each rank loads its
shard's `-b` frames of every global batch of `-b` × N / b.
"""
from __future__ import annotations

import argparse
import ast
import dataclasses
import os
import pickle
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from unidistill_torch.configs import nuscenes as cfgs
from unidistill_torch.data.collate import DataLoader
from unidistill_torch.data.dataset import NuScenesDataset
from unidistill_torch.data.evaluate import generate_submission
from unidistill_torch.training.loop import Trainer


def parse_exp_options(pairs) -> Dict[str, object]:
    """`k=v` strings → python values (the reference's DictAction semantics)."""
    out = {}
    for pair in pairs or []:
        k, _, v = pair.partition("=")
        try:
            out[k] = ast.literal_eval(v)
        except (ValueError, SyntaxError):
            out[k] = v
    return out


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(add_help=True)
    p.add_argument("-e", "--evaluate", action="store_true",
                   help="evaluate model on validation set")
    p.add_argument("-p", "--predict", action="store_true",
                   help="predict model on testing set")
    p.add_argument("-b", "--batch_size_per_device", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--ckpt_path", type=str, default=None)
    p.add_argument("--max_epochs", type=int, default=None)
    p.add_argument("--data_root", type=str, default=None)
    p.add_argument("--num_workers", type=int, default=10)
    p.add_argument("--exp_options", nargs="+", default=None,
                   help="nested config overrides, e.g. model.det_head.iou_weight=2.0")
    p.add_argument("--device", type=str, default="cuda",
                   help="the device to run on: cuda (the default) or cpu")
    return p


def configure(exp_cfg: cfgs.ExpConfig, args) -> cfgs.ExpConfig:
    """The experiment config with the command line's overrides, and the
    global numpy and torch seeds set from --seed."""
    overrides = parse_exp_options(args.exp_options)
    if args.batch_size_per_device:
        overrides["train.batch_size_per_device"] = args.batch_size_per_device
    if args.max_epochs:
        overrides["train.max_epochs"] = args.max_epochs
    if args.data_root:
        overrides["data.root_path"] = args.data_root
    overrides["train.seed"] = args.seed
    np.random.seed(args.seed)
    torch.manual_seed(args.seed)
    return cfgs.apply_overrides(exp_cfg, overrides)


def make_loader(exp_cfg: cfgs.ExpConfig, model_cfg: cfgs.ModelConfig, split: str, args, trainer: Trainer):
    """(dataset, loader) of a split, the trainer's rank's rows of each
    global batch; shuffled with drop_last for training."""
    train = split == "training"
    ds = NuScenesDataset(exp_cfg.data, model_cfg, split, seed=args.seed)
    return ds, DataLoader(ds, exp_cfg.train.batch_size_per_device, shuffle=train, drop_last=train,
                          num_workers=args.num_workers, seed=args.seed, rank=trainer.dp_rank,
                          world_size=trainer.dp_size)


def val_loader(exp_cfg: cfgs.ExpConfig, model_cfg: cfgs.ModelConfig, args, trainer: Trainer):
    """The validation split, or (None, None) where the data root has none
    (per-epoch validation is then skipped)."""
    try:
        return make_loader(exp_cfg, model_cfg, "validation", args, trainer)
    except FileNotFoundError as e:
        if trainer.rank == 0:
            print(f"[base_cli] no validation split ({e}); per-epoch eval disabled")
        return None, None


def evaluate_or_predict(trainer: Trainer, exp_cfg: cfgs.ExpConfig, model_cfg: cfgs.ModelConfig, args):
    """-e: score the validation split; -p: write the test split's
    submission and the raw predictions (boxes.pkl)."""
    ds, dl = make_loader(exp_cfg, model_cfg, "validation" if args.evaluate else "testing", args, trainer)
    state = trainer.init_state(steps_per_epoch=1)
    if args.ckpt_path:
        trainer.restore(state, args.ckpt_path, with_optimizer=False)
    if args.evaluate:
        res = trainer.evaluate(dl, ds)
        if trainer.rank == 0:
            print(res)
        return
    preds = trainer.predict(dl)

    def write():
        sub_dir = os.path.join(trainer.output_dir, "nuscenes_submission")
        generate_submission(preds, ds.infos[: len(preds)], sub_dir)
        # raw prediction dump beside the json (ref
        # nuscenes_multimodal.py:395-415 dump_inference_results)
        with open(os.path.join(sub_dir, "boxes.pkl"), "wb") as f:
            pickle.dump(preds, f)

    trainer.on_rank0(write)


def run_cli(exp_cfg: cfgs.ExpConfig, exp_name: Optional[str] = None,
            argv: Optional[Sequence[str]] = None) -> Trainer:
    """Train (or with -e / -p evaluate / predict) one detector; `argv`
    defaults to the command line. Returns the trainer (closed)."""
    args = build_parser().parse_args(argv)
    if exp_name:
        exp_cfg = dataclasses.replace(exp_cfg, exp_name=exp_name)
    exp_cfg = configure(exp_cfg, args)
    trainer = Trainer(exp_cfg, device=args.device)
    try:
        if args.evaluate or args.predict:
            evaluate_or_predict(trainer, exp_cfg, exp_cfg.model, args)
            return trainer
        _, dl = make_loader(exp_cfg, exp_cfg.model, "training", args, trainer)
        val_ds, val_dl = val_loader(exp_cfg, exp_cfg.model, args, trainer)
        state = trainer.fit(dl, exp_cfg.train.max_epochs, resume_from=args.ckpt_path,
                            val_loader=val_dl, val_dataset=val_ds,
                            eval_interval=exp_cfg.train.eval_interval)
        trainer.save_checkpoint(state.step)
        return trainer
    finally:
        trainer.close()
