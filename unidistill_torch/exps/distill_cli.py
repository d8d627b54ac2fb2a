"""Distillation experiment CLI; the port's counterpart of the JAX package's
`exps/distill_cli.py`.

ref the 4 distill exp files (…BEVFusion_nuscenes_centerhead_camera_exp_distill_lidar.py:388-524
et al.): the teacher is built from its parent exp config, loaded from a
checkpoint with shape-mismatch filtering, and frozen in eval mode; the
student trains with det + feature/relation/response distill losses (weights
per teacher/student pair, `configs.nuscenes.DISTILL_VARIANTS`).

Extra flag beside the detector CLI's: --teacher_ckpt (the reference
hard-codes `tmp/{lidar,camera,fusion}_model.pth`): a port checkpoint (a
`ckpt/step_N` directory or its parent) or a reference `.pth`/`.pt`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

from unidistill_torch.configs import nuscenes as cfgs
from unidistill_torch.exps.base_cli import build_parser, configure, evaluate_or_predict, make_loader, val_loader
from unidistill_torch.models.bevfusion import BEVFusionCenterHead
from unidistill_torch.training import checkpoint as ckpt_lib
from unidistill_torch.training.loop import Trainer, init_params


def _teacher_cfg(teacher: str) -> cfgs.ModelConfig:
    if teacher == "lidar":
        return cfgs.lidar_exp().model
    if teacher == "camera":
        return cfgs.camera_exp().model
    return cfgs.fusion_exp().model


def load_teacher(teacher_cfg: cfgs.ModelConfig, ckpt_path: Optional[str], device, seed: int = 0
                 ) -> BEVFusionCenterHead:
    """The teacher: seeded initial weights (`init_params`) overlaid with the
    checkpoint's by name, skipping shape mismatches (ref …distill_lidar.py:
    403-416), on `device`, frozen (no gradients) and in eval mode. Every
    rank loads its own."""
    model = init_params(BEVFusionCenterHead(teacher_cfg), seed)
    if ckpt_path:
        if ckpt_path.endswith((".pth", ".pt")):
            from unidistill_torch.training.torch_import import load_torch_checkpoint

            loaded = load_torch_checkpoint(ckpt_path, teacher_cfg)
        else:
            loaded = ckpt_lib.restore_checkpoint_any(ckpt_path)["model"]
        merged, used, skipped = ckpt_lib.shape_filtered_merge(model.state_dict(), loaded)
        model.load_state_dict(merged)
        print(f"teacher load: {used} tensors used, {skipped} kept from init")
    return model.to(device).requires_grad_(False).eval()


def run_distill_cli(teacher: str, student: str, argv: Optional[Sequence[str]] = None) -> Trainer:
    """Train (or with -e / -p evaluate / predict) the `student` from the
    frozen `teacher`; `argv` defaults to the command line. Returns the
    trainer (closed; `trainer.teacher` is the teacher it trained from)."""
    p = build_parser()
    p.add_argument("--teacher_ckpt", type=str, default=None)
    args = p.parse_args(argv)
    exp_cfg = configure(cfgs.distill_exp(teacher, student), args)
    trainer = Trainer(exp_cfg, device=args.device)
    # the batch carries BOTH modalities (student + teacher inputs)
    both_cfg = dataclasses.replace(cfgs.fusion_exp().model, with_lidar=True, with_camera=True)
    try:
        if args.evaluate or args.predict:
            evaluate_or_predict(trainer, exp_cfg, exp_cfg.model, args)
            return trainer
        _, dl = make_loader(exp_cfg, both_cfg, "training", args, trainer)
        t_cfg = _teacher_cfg(teacher)
        t_model = load_teacher(t_cfg, args.teacher_ckpt, trainer.device, args.seed)
        val_ds, val_dl = val_loader(exp_cfg, both_cfg, args, trainer)
        state = trainer.fit(dl, exp_cfg.train.max_epochs, resume_from=args.ckpt_path,
                            teacher=(t_model, t_cfg, exp_cfg.distill),
                            val_loader=val_dl, val_dataset=val_ds,
                            eval_interval=exp_cfg.train.eval_interval)
        trainer.save_checkpoint(state.step)
        return trainer
    finally:
        trainer.close()
