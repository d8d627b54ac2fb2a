"""Train state and optimizer; counterpart of the JAX `training/train_state.py`.

The JAX optimizer is `optax.chain(clip_by_global_norm(grad_clip),
adamw(multistep_lr, weight_decay))`, optionally followed by a per-module
scale of the whole update. Here, step by step as optax does it:
  1. clip: g <- g if ‖g‖ < clip else g / ‖g‖ · clip (‖g‖ the global norm
     over every gradient, taken before Adam sees them);
  2. AdamW with b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay on every
     parameter (BatchNorm scale and bias and `awl_params` included):
     `torch.optim.AdamW`, whose update −lr·(m̂ / (√v̂ + eps) + wd·p) is
     optax's (tests/test_torch_train_step.py holds it to optax over three
     steps);
  3. the learning rate of step s (counted from 0) is
     lr·γ^#{milestone·steps_per_epoch <= s} (MultiStepLR in steps);
  4. `lr_scale_factor` {top-level module: factor} multiplies that module's
     whole update, i.e. its learning rate.
A parameter without a gradient gets a zero one, as in optax, where every
leaf has one.

`TrainState` holds the step count; the parameters and BatchNorm statistics
live in the model, Adam's moments in the optimizer.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, Optional, Tuple

import torch
from torch import nn


@dataclass
class TrainState:
    step: int = 0


def multistep_lr(step: int, base_lr: float, milestones_epochs: Iterable[int], gamma: float,
                 steps_per_epoch: int) -> float:
    boundaries = {int(m * steps_per_epoch) for m in milestones_epochs}
    return base_lr * gamma ** sum(step >= b for b in boundaries)


class Optimizer:
    def __init__(
        self,
        model: nn.Module,
        lr: float,
        weight_decay: float,
        grad_clip: float,
        milestones_epochs: Tuple[int, ...] = (10, 15),
        gamma: float = 0.1,
        steps_per_epoch: int = 1,
        lr_scale_factor: Optional[Dict[str, float]] = None,
    ):
        self.base_lr, self.grad_clip = lr, grad_clip
        self.milestones, self.gamma, self.steps_per_epoch = tuple(milestones_epochs), gamma, steps_per_epoch
        scales = dict(lr_scale_factor or {})
        groups: Dict[float, list] = {}
        for name, p in model.named_parameters():
            if p.requires_grad:
                groups.setdefault(scales.get(name.split(".")[0], 1.0), []).append(p)
        self.params = [p for ps in groups.values() for p in ps]
        self.adamw = torch.optim.AdamW(
            [dict(params=ps, scale=s) for s, ps in groups.items()],
            lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=weight_decay,
        )

    def lr(self, step: int) -> float:
        return multistep_lr(step, self.base_lr, self.milestones, self.gamma, self.steps_per_epoch)

    @torch.no_grad()
    def step(self, step: int) -> torch.Tensor:
        """Clip the gradients, then one AdamW update at the lr of `step`.
        Returns the global gradient norm before clipping (a device tensor)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        clip = torch.where(norm < self.grad_clip, torch.ones_like(norm), self.grad_clip / norm)
        torch._foreach_mul_(grads, clip)
        lr = self.lr(step)
        for group in self.adamw.param_groups:
            group["lr"] = lr * group["scale"]
        self.adamw.step()
        return norm

    def zero_grad(self) -> None:
        self.adamw.zero_grad(set_to_none=True)


def make_optimizer(model: nn.Module, train_cfg, steps_per_epoch: int = 1) -> Optimizer:
    """The optimizer of a `TrainConfig` (lr, weight decay, clip, milestones,
    γ, lr_scale_factor)."""
    return Optimizer(
        model, train_cfg.lr, train_cfg.weight_decay, train_cfg.grad_clip_value,
        train_cfg.lr_milestones, train_cfg.lr_gamma, steps_per_epoch,
        dict(train_cfg.lr_scale_factor) if train_cfg.lr_scale_factor else None,
    )
