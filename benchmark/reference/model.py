"""BEVFusion-CenterHead detector; counterpart of the JAX
`models/bevfusion.py`.

lidar_encoder (sparse voxel encoder -> [B, 256, ny, nx]) or camera_encoder
(LSS -> [B, 256, ny, nx]), then bev_encoder (SECOND 2D backbone -> [B, 512,
ny, nx]) -> det_head (CenterHead -> per-task dicts of NCHW maps).
`model_output` is the encoder's map that the BEV backbone reads. The cells
run one modality a model, a single camera sweep: fusion and multi-sweep input
have no counterpart here.

Every parameter is held in float32 (flax's default `param_dtype`); each
convolution, the sparse ones included, casts its input and weights to
`cfg.compute_dtype` at the call. BatchNorm, the head's output bias,
`awl_params` and every output stay float32, as in the JAX model.
The JAX model's `nn.remat` wrappers save TPU memory in training and change
no math, so they have no counterpart here.

`precision` chooses float32 or the fp8 control (`common.cast`).
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

from .config import ModelConfig
from .bev_backbone import BaseBEVBackbone
from .center_head import CenterHead
from .common import Conv2d, ConvTranspose2d, Linear
from .lidar_encoder import LidarEncoder, SubMConv
from .lss import LSSFPN

# the reference runs in float32; its control rounds every product's
# operands to fp8 (e4m3), the precision below the configuration's bfloat16
DTYPES = {"float32": torch.float32, "fp8": torch.float8_e4m3fn}


class BEVFusionCenterHead(nn.Module):
    def __init__(self, cfg: ModelConfig, precision: str = "float32"):
        super().__init__()
        if cfg.with_lidar == cfg.with_camera:
            raise ValueError("the reference holds the single-modality detectors: LiDAR or camera")
        self.cfg = cfg
        be = cfg.bev_encoder
        if cfg.with_lidar:
            self.lidar_encoder = LidarEncoder(cfg.lidar_encoder)
            bev_in = be.num_bev_features
        if cfg.with_camera:
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
        dtype = DTYPES[precision]
        for m in self.modules():
            if isinstance(m, (Conv2d, ConvTranspose2d, Linear, SubMConv)):
                m.compute_dtype = dtype

    def forward(self, voxel_feats: Optional[torch.Tensor] = None,
                voxel_coords: Optional[torch.Tensor] = None,
                imgs: Optional[torch.Tensor] = None,
                mats: Optional[Dict[str, torch.Tensor]] = None) -> Dict:
        if self.cfg.with_lidar:
            model_output = self.lidar_encoder(voxel_feats, voxel_coords)
        else:
            model_output = self.camera_encoder(imgs, mats)
        awl = self.awl_params
        bev, _pyramid = self.bev_encoder(model_output)
        preds = self.det_head(bev)
        return dict(
            model_output=model_output.float(),
            bev_feature=bev.float(),
            multi_head_features=preds,
            awl_params=awl,
        )
