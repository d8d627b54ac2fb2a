"""SECOND-style dense 2D BEV backbone (NCHW), counterpart of the JAX
`layers/bev_backbone.py`: per branch one strided 3×3 conv and `layer_nums`
3×3 convs (BN eps 1e-3, flax momentum 0.99, + ReLU), then a deblock to
stride 1; the branches are concatenated on channels."""
from __future__ import annotations

from typing import Dict, Sequence, Tuple

import torch
from torch import nn

from unidistill_torch.layers.common import BatchNorm, Conv2d, ConvTranspose2d, conv_bn_act


class BaseBEVBackbone(nn.Module):
    def __init__(self, in_channels: int, layer_nums: Sequence[int] = (5, 5),
                 layer_strides: Sequence[int] = (1, 2),
                 num_filters: Sequence[int] = (128, 256),
                 upsample_strides: Sequence[float] = (1, 2),
                 num_upsample_filters: Sequence[int] = (256, 256)):
        super().__init__()
        self.layer_nums = tuple(layer_nums)
        bn = lambda c: BatchNorm(c, eps=1e-3, momentum=0.99)
        cin = in_channels
        for i, (n, s, f) in enumerate(zip(layer_nums, layer_strides, num_filters)):
            self.add_module(f"block{i}_conv0", Conv2d(cin, f, 3, stride=s, padding=1, bias=False))
            self.add_module(f"block{i}_bn0", bn(f))
            for k in range(n):
                self.add_module(f"block{i}_conv{k + 1}", Conv2d(f, f, 3, padding=1, bias=False))
                self.add_module(f"block{i}_bn{k + 1}", bn(f))
            us, uf = upsample_strides[i], num_upsample_filters[i]
            if us >= 1:
                u = ConvTranspose2d(f, uf, int(us), stride=int(us), bias=False)
            else:
                ds = int(round(1 / us))
                u = Conv2d(f, uf, ds, stride=ds, bias=False)
            self.add_module(f"deblock{i}_conv", u)
            self.add_module(f"deblock{i}_bn", bn(uf))
            cin = f

    def forward(self, x: torch.Tensor) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        in_h = x.shape[2]
        ups = []
        pyramid = {}
        for i, n in enumerate(self.layer_nums):
            for k in range(n + 1):
                x = conv_bn_act(getattr(self, f"block{i}_conv{k}"), getattr(self, f"block{i}_bn{k}"), x)
            pyramid[f"spatial_features_{in_h // x.shape[2]}x"] = x
            ups.append(conv_bn_act(getattr(self, f"deblock{i}_conv"), getattr(self, f"deblock{i}_bn"), x))
        out = torch.cat(ups, dim=1) if len(ups) > 1 else ups[0]
        return out, pyramid
