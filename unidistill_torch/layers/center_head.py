"""CenterPoint-style multi-task detection head (NCHW), branch-fused,
counterpart of the JAX `layers/center_head.py`.

One shared 3×3 conv (+BN+ReLU; BN flax momentum 0.9); then all G = tasks ×
heads branches at once:
  * `branches_conv0`: one 3×3 conv hc -> G·hc (+BN+ReLU);
  * `out_conv`: the JAX block-diagonal dense 3×3 conv G·hc -> G·o_max, which
    is exactly a grouped conv with groups=G; each branch keeps the first
    `ch` of its o_max outputs. `out_bias` [G·o_max] is added in float32
    after the conv, as the JAX head adds its [G, o_max] bias.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import torch
from torch import nn

from unidistill_torch.layers.common import BatchNorm, Conv2d, conv_bn_act


def branch_list(
    tasks: Tuple[Tuple[str, ...], ...],
    common_heads: Tuple[Tuple[str, Tuple[int, int]], ...],
) -> List[Tuple[int, str, int]]:
    """(task_id, head_name, out_channels) of every branch, in the fused order."""
    out = []
    for tid, classes in enumerate(tasks):
        for name, (ch, _num_conv) in tuple(common_heads) + (("hm", (len(classes), 2)),):
            out.append((tid, name, ch))
    return out


class CenterHead(nn.Module):
    def __init__(self, in_channels: int, tasks, common_heads,
                 share_conv_channel: int = 64, init_bias: float = -2.19,
                 head_conv: int = 64):
        super().__init__()
        self.tasks = tuple(tasks)
        self.branches = branch_list(self.tasks, tuple(common_heads))
        G = len(self.branches)
        self.o_max = max(ch for _, _, ch in self.branches)
        self.shared_conv = Conv2d(in_channels, share_conv_channel, 3, padding=1, bias=True)
        self.shared_bn = BatchNorm(share_conv_channel, eps=1e-5, momentum=0.9)
        self.branches_conv0 = Conv2d(share_conv_channel, G * head_conv, 3, padding=1, bias=True)
        self.branches_bn0 = BatchNorm(G * head_conv, eps=1e-5, momentum=0.9)
        self.out_conv = Conv2d(G * head_conv, G * self.o_max, 3, padding=1, groups=G, bias=False)
        bias = torch.zeros(G, self.o_max)
        for g, (_tid, name, ch) in enumerate(self.branches):
            if name == "hm":
                bias[g, :ch] = init_bias
        self.out_bias = nn.Parameter(bias.reshape(-1))

    def forward(self, x: torch.Tensor) -> List[Dict[str, torch.Tensor]]:
        x = conv_bn_act(self.shared_conv, self.shared_bn, x)
        h = conv_bn_act(self.branches_conv0, self.branches_bn0, x)
        y = self.out_conv(h).float()
        y = y + self.out_bias.float()[None, :, None, None]
        B, _, H, W = y.shape
        y = y.reshape(B, len(self.branches), self.o_max, H, W)
        preds: List[Dict[str, torch.Tensor]] = [dict() for _ in self.tasks]
        for g, (tid, name, ch) in enumerate(self.branches):
            preds[tid][name] = y[:, g, :ch]
        return preds
