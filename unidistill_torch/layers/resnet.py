"""ResNet-50 image backbone (NCHW), counterpart of the JAX `layers/resnet.py`.

Submodule names follow the JAX parameter tree (`conv1`, `bn1`,
`layer{s}_{b}.conv1` ...) so that `training/jax_weights.py` maps one onto the
other by name. Convolutions run in the module's compute dtype; BatchNorm
(flax momentum 0.9, eps 1e-5) and the residual sums run in float32, as in the
JAX module.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
from torch import nn
import torch.nn.functional as F

from unidistill_torch.layers.common import BatchNorm, Conv2d, conv_bn_act


class Bottleneck(nn.Module):
    def __init__(self, cin: int, planes: int, stride: int, downsample: bool):
        super().__init__()
        bn = lambda c: BatchNorm(c, eps=1e-5, momentum=0.9)
        self.conv1 = Conv2d(cin, planes, 1, bias=False)
        self.bn1 = bn(planes)
        self.conv2 = Conv2d(planes, planes, 3, stride=stride, padding=1, bias=False)
        self.bn2 = bn(planes)
        self.conv3 = Conv2d(planes, planes * 4, 1, bias=False)
        self.bn3 = bn(planes * 4)
        self.downsample = downsample
        if downsample:
            self.downsample_conv = Conv2d(cin, planes * 4, 1, stride=stride, bias=False)
            self.downsample_bn = bn(planes * 4)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = conv_bn_act(self.conv1, self.bn1, x)
        out = conv_bn_act(self.conv2, self.bn2, out)
        out = conv_bn_act(self.conv3, self.bn3, out, relu=False)
        identity = x
        if self.downsample:
            identity = conv_bn_act(self.downsample_conv, self.downsample_bn, x, relu=False)
        return F.relu(out + identity.float())


class ResNet(nn.Module):
    """Returns the feature maps after the stages in `out_indices`
    (0 -> layer1 / stride 4 ... 3 -> layer4 / stride 32)."""

    def __init__(self, block_counts: Sequence[int] = (3, 4, 6, 3),
                 out_indices: Tuple[int, ...] = (0, 1, 2, 3)):
        super().__init__()
        self.out_indices = tuple(out_indices)
        self.conv1 = Conv2d(3, 64, 7, stride=2, padding=3, bias=False)
        self.bn1 = BatchNorm(64, eps=1e-5, momentum=0.9)
        self.stages: List[List[str]] = []
        cin, planes = 64, 64
        for stage, n_blocks in enumerate(block_counts):
            names = []
            for b in range(n_blocks):
                name = f"layer{stage + 1}_{b}"
                self.add_module(name, Bottleneck(
                    cin, planes, (1 if stage == 0 else 2) if b == 0 else 1, b == 0))
                cin = planes * 4
                names.append(name)
            self.stages.append(names)
            planes *= 2

    def forward(self, x: torch.Tensor) -> List[torch.Tensor]:
        x = conv_bn_act(self.conv1, self.bn1, x)
        x = F.max_pool2d(x, 3, stride=2, padding=1)  # -inf padding, as in JAX
        outs = []
        for stage, names in enumerate(self.stages):
            for name in names:
                x = getattr(self, name)(x)
            if stage in self.out_indices:
                outs.append(x)
        return outs
