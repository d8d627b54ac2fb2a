"""BEVFusion-CenterHead detector with one modality; counterpart of the JAX
`models/bevfusion.py`.

lidar_encoder (sparse voxel encoder -> [B, 256, ny, nx]) or camera_encoder
(LSS -> [B, 256, ny, nx]) -> bev_encoder (SECOND 2D backbone ->
[B, 512, ny, nx]) -> det_head (CenterHead -> per-task dicts of NCHW maps).
The LiDAR-only and the camera-only detectors run; fusion (both modalities
and the fusion encoder) is not ported yet and raises.

Every parameter is held in float32 (flax's default `param_dtype`); each
convolution, the sparse ones included, casts its input and weights to
`cfg.compute_dtype` at the call. BatchNorm, the head's output bias,
`awl_params` and every output stay float32, as in the JAX model.
The JAX model's `nn.remat` wrappers save TPU memory in training and change
no math, so they have no counterpart here.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from unidistill_torch.configs.nuscenes import ModelConfig
from unidistill_torch.layers.bev_backbone import BaseBEVBackbone
from unidistill_torch.layers.center_head import CenterHead
from unidistill_torch.layers.common import Conv2d, ConvTranspose2d
from unidistill_torch.layers.lidar_encoder import LidarEncoder, SubMConv
from unidistill_torch.layers.lss import LSSFPN

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class BEVFusionCenterHead(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        if cfg.with_lidar and cfg.with_camera:
            raise NotImplementedError("fusion (LiDAR + camera) is not ported yet")
        if not (cfg.with_lidar or cfg.with_camera):
            raise ValueError("the model needs at least one modality")
        self.cfg = cfg
        be = cfg.bev_encoder
        if cfg.with_lidar:
            self.lidar_encoder = LidarEncoder(cfg.lidar_encoder)
            bev_in = be.num_bev_features
        else:
            self.camera_encoder = LSSFPN(cfg.camera_encoder)
            bev_in = cfg.camera_encoder.output_channels
        self.bev_encoder = BaseBEVBackbone(
            bev_in, be.layer_nums, be.layer_strides,
            be.num_filters, be.upsample_strides, be.num_upsample_filters,
        )
        self.det_head = CenterHead(
            sum(be.num_upsample_filters), cfg.tasks, cfg.det_head.common_heads,
            cfg.det_head.share_conv_channel, cfg.det_head.init_bias,
        )
        self.awl_params = nn.Parameter(torch.ones(len(cfg.det_head.code_weights) + 2))
        dtype = DTYPES[cfg.compute_dtype]
        for m in self.modules():
            if isinstance(m, (Conv2d, ConvTranspose2d, SubMConv)):
                m.compute_dtype = dtype

    def forward(self, voxel_feats: Optional[torch.Tensor] = None,
                voxel_coords: Optional[torch.Tensor] = None,
                imgs: Optional[torch.Tensor] = None,
                mats: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
        if self.cfg.with_lidar:
            model_output = self.lidar_encoder(voxel_feats, voxel_coords)
        else:
            model_output = self.camera_encoder(imgs, mats)
        bev, _pyramid = self.bev_encoder(model_output)
        preds = self.det_head(bev)
        return dict(
            model_output=model_output.float(),
            bev_feature=bev.float(),
            multi_head_features=preds,
            awl_params=self.awl_params,
        )
