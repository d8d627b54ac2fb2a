"""Self-calibrated convolution (SCNet) blocks, counterpart of the JAX
`layers/sc_conv.py` (the reference BEV backbone's optional `use_scconv`
path; off in every configuration). NCHW.

Numerics kept from the JAX module: convolutions in the compute dtype
(`common.Conv2d`), every BatchNorm in float32 with flax momentum 0.99 and
eps 1e-3 (`common.BatchNorm`: the running variance moves towards the biased
batch variance); the average pool floors; the "bilinear" resize of the JAX
module is `jax.image.resize(..., "nearest")`, a nearest resize with
half-pixel centres, which is torch's "nearest-exact" (not "nearest").
"""
from __future__ import annotations

import torch
from torch import nn
import torch.nn.functional as F

from unidistill_torch.layers.common import BatchNorm, Conv2d


def _bn(c: int) -> BatchNorm:
    return BatchNorm(c, eps=1e-3, momentum=0.99)


def _conv3(cin: int, cout: int, stride: int = 1) -> Conv2d:
    return Conv2d(cin, cout, 3, stride=stride, padding=1, bias=False)


class SCConv(nn.Module):
    def __init__(self, planes: int, stride: int = 1, pooling_r: int = 4):
        super().__init__()
        self.pooling_r = pooling_r
        self.k2_conv, self.k2_bn = _conv3(planes, planes), _bn(planes)
        self.k3_conv, self.k3_bn = _conv3(planes, planes), _bn(planes)
        self.k4_conv, self.k4_bn = _conv3(planes, planes, stride), _bn(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        identity = x
        r = self.pooling_r
        k2 = self.k2_bn(self.k2_conv(F.avg_pool2d(x, r, r)).float())
        k2 = F.interpolate(k2, size=identity.shape[2:], mode="nearest-exact")
        gate = torch.sigmoid(identity + k2.to(identity.dtype))
        k3 = self.k3_bn(self.k3_conv(x).float())
        out = k3.to(gate.dtype) * gate
        return self.k4_bn(self.k4_conv(out).float())


class SCBottleneck(nn.Module):
    def __init__(self, inplanes: int, planes: int, stride: int = 1, bottleneck_width: int = 32):
        super().__init__()
        gw = int(planes * (bottleneck_width / 64.0))
        self.conv1_a, self.bn1_a = Conv2d(inplanes, gw, 1, bias=False), _bn(gw)
        self.conv1_b, self.bn1_b = Conv2d(inplanes, gw, 1, bias=False), _bn(gw)
        self.k1_conv, self.k1_bn = _conv3(gw, gw, stride), _bn(gw)
        self.scconv = SCConv(gw, stride)
        self.conv3, self.bn3 = Conv2d(2 * gw, planes, 1, bias=False), _bn(planes)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        a = F.relu(self.bn1_a(self.conv1_a(x).float()))
        b = F.relu(self.bn1_b(self.conv1_b(x).float()))
        a = F.relu(self.k1_bn(self.k1_conv(a).float()))
        b = F.relu(self.scconv(b))
        out = self.bn3(self.conv3(torch.cat([a, b], dim=1)).float())
        return F.relu(out + x.to(out.dtype))
