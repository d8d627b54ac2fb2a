"""BEVFusion-CenterHead detector, camera subset; counterpart of the JAX
`models/bevfusion.py`.

camera_encoder (LSS -> [B, 256, ny, nx]) -> bev_encoder (SECOND 2D backbone
-> [B, 512, ny, nx]) -> det_head (CenterHead -> per-task dicts of NCHW maps).
The LiDAR encoder and the fusion encoder are not ported yet.

Convolution weights are held in `cfg.compute_dtype`; BatchNorm, the head's
output bias, `awl_params` and every output stay float32, as in the JAX model.
The JAX model's `nn.remat` wrappers save TPU memory in training and change
no math, so they have no counterpart here.
"""
from __future__ import annotations

from typing import Dict

import torch
from torch import nn

from unidistill_torch.configs.nuscenes import ModelConfig
from unidistill_torch.layers.bev_backbone import BaseBEVBackbone
from unidistill_torch.layers.center_head import CenterHead
from unidistill_torch.layers.lss import LSSFPN

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class BEVFusionCenterHead(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.with_lidar:
            raise NotImplementedError("the LiDAR encoder and fusion are not ported yet")
        if not cfg.with_camera:
            raise ValueError("the model needs at least one modality")
        self.cfg = cfg
        self.camera_encoder = LSSFPN(cfg.camera_encoder)
        be = cfg.bev_encoder
        self.bev_encoder = BaseBEVBackbone(
            cfg.camera_encoder.output_channels, be.layer_nums, be.layer_strides,
            be.num_filters, be.upsample_strides, be.num_upsample_filters,
        )
        self.det_head = CenterHead(
            sum(be.num_upsample_filters), cfg.tasks, cfg.det_head.common_heads,
            cfg.det_head.share_conv_channel, cfg.det_head.init_bias,
        )
        self.awl_params = nn.Parameter(torch.ones(len(cfg.det_head.code_weights) + 2))
        dtype = DTYPES[cfg.compute_dtype]
        for m in self.modules():
            if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
                m.to(dtype)

    def forward(self, imgs: torch.Tensor, mats: Dict[str, torch.Tensor]) -> Dict:
        model_output = self.camera_encoder(imgs, mats)
        bev, _pyramid = self.bev_encoder(model_output)
        preds = self.det_head(bev)
        return dict(
            model_output=model_output.float(),
            bev_feature=bev.float(),
            multi_head_features=preds,
            awl_params=self.awl_params,
        )
