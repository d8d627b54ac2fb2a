"""Building blocks of the reference's layers (a frozen copy of the port's),
with the JAX modules' numerics.

  * `Conv2d`, `ConvTranspose2d`, `Linear`: parameters held in float32
    (flax's default `param_dtype`); the input, the weight and the bias are
    cast to the module's `compute_dtype` at the call, as flax's `dtype`
    does. The reference's model sets `compute_dtype` to float32, or to fp8
    for the control (`cast`).
  * `BatchNorm`: flax's `nn.BatchNorm` in training. Its `momentum` argument
    is flax's (running = m·running + (1 − m)·batch; torch's own `momentum`
    attribute holds 1 − m). Training normalises with the biased batch
    variance, as torch does, and also moves the running variance towards
    that biased variance, as flax does (torch would use the unbiased one).
    Each instance takes the momentum of the JAX module it mirrors. In eval
    it normalises with the running statistics.
  * `conv_bn_act`: conv in the compute dtype, then BN (and ReLU) in float32.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


FP8 = torch.float8_e4m3fn
FP8_MAX = 448.0


def cast(x: torch.Tensor, dt: torch.dtype) -> torch.Tensor:
    """`x` in the compute dtype `dt`. For fp8 (the control), `x` rounded to
    e4m3 under one scale for the tensor (its largest magnitude to 448) and
    returned in float32, where the product then runs; the gradient passes
    the rounding unchanged, so that the backward's products take the rounded
    operands and a float32 gradient."""
    if dt != FP8:
        return x.to(dt)
    x = x.float()
    scale = x.detach().abs().amax().clamp_min(1e-30) / FP8_MAX
    q = (x.detach() / scale).to(FP8).float() * scale
    return x + (q - x.detach())


def cast_bias(b, dt: torch.dtype):
    """A bias in the compute dtype; float32 under the fp8 control."""
    return None if b is None else (b.float() if dt == FP8 else b.to(dt))


class Conv2d(nn.Conv2d):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return self._conv_forward(cast(x, dt), cast(self.weight, dt), cast_bias(self.bias, dt))


class ConvTranspose2d(nn.ConvTranspose2d):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv_transpose2d(cast(x, dt), cast(self.weight, dt), cast_bias(self.bias, dt),
                                  self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


class Linear(nn.Linear):
    """flax `nn.Dense`: weight [out, in] (the transpose of flax's kernel)."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(cast(x, dt), cast(self.weight, dt), cast_bias(self.bias, dt))


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Over the channels of [N, C] or [N, C, H, W]; `momentum` in flax terms."""

    def __init__(self, num_features: int, eps: float, momentum: float):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() not in (2, 4):
            raise ValueError(f"BatchNorm expects a 2D or 4D input, got {x.dim()}D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias, False, 0.0,
                                self.eps)
        self.num_batches_tracked.add_(1)
        # momentum None (used by calibration): the cumulative average
        f = self.momentum if self.momentum is not None else 1.0 / float(self.num_batches_tracked)
        # torch updates the statistics it is given inside the op and autograd
        # keeps them, so it gets copies, and the buffers take the result
        mean, var = self.running_mean.clone(), self.running_var.clone()
        out = F.batch_norm(x, mean, var, self.weight, self.bias, True, f, self.eps)
        # torch moved the variance by f·var_b·n/(n−1); take f·var_b instead
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            kept = self.running_var * (1.0 - f)
            self.running_mean.copy_(mean)
            self.running_var.copy_(kept + (var - kept) * ((n - 1) / n))
        return out


def conv_bn_act(conv: nn.Module, bn: nn.Module, x: torch.Tensor, relu: bool = True) -> torch.Tensor:
    """conv in its compute dtype, then BN (and ReLU) in float32."""
    y = bn(conv(x).float())
    return F.relu(y) if relu else y
