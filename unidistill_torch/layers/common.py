"""Building blocks shared by the port's layers, with the JAX modules' numerics.

  * `Conv2d`, `ConvTranspose2d`, `Linear`: parameters held in float32
    (flax's default `param_dtype`); the input, the weight and the bias are
    cast to the module's `compute_dtype` at the call, as flax's `dtype`
    does. The model sets `compute_dtype` from `ModelConfig.compute_dtype`.
  * `LayerNorm`: flax's `nn.LayerNorm(dtype=float32)`: the input is cast to
    float32, and so is the output.
  * `BatchNorm`: flax's `nn.BatchNorm` in training. Its `momentum` argument
    is flax's (running = m·running + (1 − m)·batch; torch's own `momentum`
    attribute holds 1 − m). Training normalises with the biased batch
    variance, as torch does, and also moves the running variance towards
    that biased variance, as flax does (torch would use the unbiased one).
    Each instance takes the momentum of the JAX module it mirrors. In eval
    it runs torch's own kernel (cuDNN off), as an exported program does.
    With `stats_group` set (a process group; the spatial step sets it,
    `parallel.spatial.global_batch_stats`), training takes its statistics
    over every rank of the group: Σx, Σx² and the row count all-reduced in
    float32, then flax's mean(x²) − mean(x)² (`global_batch_norm`); the
    backward all-reduces Σdy and Σdy·x̂ in turn, so the input gradient is
    that of one BatchNorm over the whole batch.
  * `conv_bn_act`: conv in the compute dtype, then BN (and ReLU) in float32.
"""
from __future__ import annotations

import torch
import torch.distributed as dist
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


class Linear(nn.Linear):
    """flax `nn.Dense`: weight [out, in] (the transpose of flax's kernel)."""

    compute_dtype = torch.float32

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class LayerNorm(nn.LayerNorm):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)


class _GlobalBatchNorm(torch.autograd.Function):
    """y = (x − μ)·rsqrt(σ² + eps)·w + b with μ, σ² over every rank of
    `group`; returns (y, μ, σ²), the statistics without a gradient."""

    @staticmethod
    def forward(ctx, x, weight, bias, group, eps):
        C = x.shape[1]
        dims = [0, *range(2, x.dim())]
        shape = (1, C) + (1,) * (x.dim() - 2)
        stats = torch.cat([x.sum(dims), (x * x).sum(dims), x.new_full((1,), x.numel() // C)])
        dist.all_reduce(stats, group=group)
        n = stats[2 * C]
        mean = stats[:C] / n
        var = (stats[C : 2 * C] / n - mean * mean).clamp_min(0.0)
        invstd = torch.rsqrt(var + eps)
        y = (x - mean.view(shape)) * (invstd * weight).view(shape) + bias.view(shape)
        ctx.save_for_backward(x, weight, mean, invstd, n)
        ctx.group, ctx.dims, ctx.shape = group, dims, shape
        ctx.mark_non_differentiable(mean, var)
        return y, mean, var

    @staticmethod
    def backward(ctx, gy, _gmean, _gvar):
        x, weight, mean, invstd, n = ctx.saved_tensors
        dims, shape = ctx.dims, ctx.shape
        xhat = (x - mean.view(shape)) * invstd.view(shape)
        gb = gy.sum(dims)
        gw = (gy * xhat).sum(dims)
        sums = torch.cat([gb, gw])
        dist.all_reduce(sums, group=ctx.group)
        C = gb.numel()
        sb, sw = sums[:C] / n, sums[C:] / n
        gx = (gy - sb.view(shape) - xhat * sw.view(shape)) * (weight * invstd).view(shape)
        return gx, gw, gb, None, None


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    """Over the channels of [N, C] or [N, C, H, W]; `momentum` in flax terms."""

    # a process group: training statistics over its ranks (see the module docstring)
    stats_group = None

    def __init__(self, num_features: int, eps: float, momentum: float):
        super().__init__(num_features, eps=eps, momentum=1.0 - momentum)

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() not in (2, 4):
            raise ValueError(f"BatchNorm expects a 2D or 4D input, got {x.dim()}D")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        self._check_input_dim(x)
        if not self.training:
            # torch's own kernel (no cuDNN), the op `torch.export` lowers an
            # eval batch_norm to; it has no branch on an empty input, which a
            # program traced with symbolic site counts could not take. The
            # live model and its exported program run the same kernel. On an
            # H100 it also served each detector faster than cuDNN's
            # (`tools/op_times.py bn`). The op's name and signature are
            # internal to torch: checked on torch 2.11 (CUDA 12.8) and 2.13
            # (CPU).
            return torch.ops.aten._native_batch_norm_legit_no_training(
                x, self.weight, self.bias, self.running_mean, self.running_var, 0.0, self.eps)[0]
        self.num_batches_tracked.add_(1)
        # momentum None (used by calibration): the cumulative average
        f = self.momentum if self.momentum is not None else 1.0 / float(self.num_batches_tracked)
        if self.stats_group is not None:
            return self.global_batch_norm(x, f)
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


    def global_batch_norm(self, x: torch.Tensor, f: float) -> torch.Tensor:
        """Training over the ranks of `stats_group`; the running statistics
        move by f towards the global mean and biased variance, the same on
        every rank."""
        y, mean, var = _GlobalBatchNorm.apply(x.float(), self.weight, self.bias, self.stats_group, self.eps)
        with torch.no_grad():
            self.running_mean.lerp_(mean, f)
            self.running_var.lerp_(var, f)
        return y


def conv_bn_act(conv: nn.Module, bn: nn.Module, x: torch.Tensor, relu: bool = True, rows=None) -> torch.Tensor:
    """conv in its compute dtype, then BN (and ReLU) in float32; with `rows`
    (a `parallel.spatial.RowSplit`), the conv on this rank's block of rows
    with its halo rows (`RowSplit.conv`)."""
    y = bn((conv(x) if rows is None else rows.conv(conv, x)).float())
    return F.relu(y) if relu else y
