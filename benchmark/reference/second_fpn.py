"""SECONDFPN neck (NCHW), counterpart of the JAX `layers/second_fpn.py`.

Each level gets one deblock: a transposed conv with k = s = stride when the
upsample stride s >= 1, a VALID conv with k = s = 1/stride when it is below 1;
then BN (eps 1e-3, flax momentum 0.99) + ReLU in float32; the levels are concatenated on channels.
"""
from __future__ import annotations

from typing import List, Sequence

import torch
from torch import nn

from .common import BatchNorm, Conv2d, ConvTranspose2d, conv_bn_act


class SECONDFPN(nn.Module):
    def __init__(self, in_channels: Sequence[int], out_channels: Sequence[int],
                 upsample_strides: Sequence[float]):
        super().__init__()
        self.n = len(out_channels)
        for i, (cin, c, s) in enumerate(zip(in_channels, out_channels, upsample_strides)):
            if s >= 1:
                k = int(s)
                conv = ConvTranspose2d(cin, c, k, stride=k, bias=False)
            else:
                k = int(round(1 / s))
                conv = Conv2d(cin, c, k, stride=k, bias=False)
            self.add_module(f"deblock{i}_conv", conv)
            self.add_module(f"deblock{i}_bn", BatchNorm(c, eps=1e-3, momentum=0.99))

    def forward(self, feats: List[torch.Tensor]) -> torch.Tensor:
        assert len(feats) == self.n
        ups = [
            conv_bn_act(getattr(self, f"deblock{i}_conv"), getattr(self, f"deblock{i}_bn"), x)
            for i, x in enumerate(feats)
        ]
        return torch.cat(ups, dim=1)
