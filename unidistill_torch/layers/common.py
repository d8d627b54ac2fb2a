"""Building blocks shared by the port's layers, with the JAX modules' numerics.

  * `Conv2d`, `ConvTranspose2d`: parameters held in float32 (flax's default
    `param_dtype`); the input, the weight and the bias are cast to the
    module's `compute_dtype` at the call, as flax's `dtype` does. The model
    sets `compute_dtype` from `ModelConfig.compute_dtype`.
  * `BatchNorm`: flax's `nn.BatchNorm` in training. Its `momentum` argument
    is flax's (running = m·running + (1 − m)·batch; torch's own `momentum`
    attribute holds 1 − m). Training normalises with the biased batch
    variance, as torch does, and also moves the running variance towards
    that biased variance, as flax does (torch would use the unbiased one).
    Each instance takes the momentum of the JAX module it mirrors.
  * `conv_bn_act`: conv in the compute dtype, then BN (and ReLU) in float32.
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F


class Conv2d(nn.Conv2d):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return self._conv_forward(x.to(dt), self.weight.to(dt), bias)


class ConvTranspose2d(nn.ConvTranspose2d):
    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.conv_transpose2d(x.to(dt), self.weight.to(dt), bias, self.stride, self.padding,
                                  self.output_padding, self.groups, self.dilation)


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
            return F.batch_norm(x, self.running_mean, self.running_var, self.weight, self.bias,
                                False, 0.0, self.eps)
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
