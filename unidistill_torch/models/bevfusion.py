"""BEVFusion-CenterHead detector; counterpart of the JAX
`models/bevfusion.py`.

lidar_encoder (sparse voxel encoder -> [B, 256, ny, nx]) and/or
camera_encoder (LSS -> [B, 256, ny, nx]); with both, fusion_encoder (concat
[lidar, camera] -> squeeze-excite gate -> 3×3 reduce -> [B, 256, ny, nx]);
then bev_encoder (SECOND 2D backbone -> [B, 512, ny, nx]) -> det_head
(CenterHead -> per-task dicts of NCHW maps). `model_output` is the
encoders' map that the BEV backbone reads: the fused map for fusion.

Multi-sweep camera input: a model built with `sweeps` S takes images
[B, S, N, H, W, 3]; its camera map has S·256 channels (the key sweep's
first), so the BEV backbone takes S·256 input channels and the fusion
encoder 256 + S·256, as JAX infers from its input. The configuration has
no field for S (it is the JAX one field for field): the constructor takes
it (default 1), and `sweeps_from_state_dict` reads it off carried-across
weights. A batch with another S raises.

Every parameter is held in float32 (flax's default `param_dtype`); each
convolution, the sparse ones included, casts its input and weights to
`cfg.compute_dtype` at the call. BatchNorm, the head's output bias,
`awl_params` and every output stay float32, as in the JAX model.
The JAX model's `nn.remat` wrappers save TPU memory in training and change
no math, so they have no counterpart here.

Spatial sharding (`spatial`, the `parallel.mesh.SpatialGroups` of a (dp,
bev) world; `parallel/spatial.py`): the encoders and the fusion encoder
(its gate a mean over the whole map) run on the rank's dp shard; the BEV
backbone and the head run on the rank's block of rows with halos; the head
maps and `bev_feature` come back whole. `model_output` and `awl_params`,
which the losses read whole on every bev peer, pass 1/b of their gradient.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

from unidistill_torch.configs.nuscenes import ModelConfig
from unidistill_torch.layers.bev_backbone import BaseBEVBackbone
from unidistill_torch.layers.center_head import CenterHead
from unidistill_torch.layers.common import BatchNorm, Conv2d, ConvTranspose2d, Linear
from unidistill_torch.layers.lidar_encoder import LidarEncoder, SubMConv
from unidistill_torch.layers.lss import LSSFPN
from unidistill_torch.parallel.spatial import RowSplit, scale_grad

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


class FusionEncoder(nn.Module):
    """Concat + squeeze-excite gate + 3×3 reduce (the JAX `FusionEncoder`,
    use_elementwise=False): x = [lidar, camera] along the channels, in the
    compute dtype; att = sigmoid(att_conv(mean over H, W of x)) (1×1, with
    bias); y = relu(reduce_bn(reduce_conv(x · att))) (3×3, padding 1, no
    bias; BatchNorm flax momentum 0.9, eps 1e-5, in float32). As in JAX, x
    is cast to the compute dtype before the mean and the gate multiply."""

    def __init__(self, in_channels: int, out_channels: int = 256):
        super().__init__()
        self.att_conv = Conv2d(in_channels, in_channels, 1, bias=True)
        self.reduce_conv = Conv2d(in_channels, out_channels, 3, padding=1, bias=False)
        self.reduce_bn = BatchNorm(out_channels, eps=1e-5, momentum=0.9)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
        x = torch.cat([x1, x2], 1).to(self.att_conv.compute_dtype)
        att = torch.sigmoid(self.att_conv(x.mean((2, 3), keepdim=True)))
        return torch.relu(self.reduce_bn(self.reduce_conv(x * att).float()))


def sweeps_from_state_dict(cfg: ModelConfig, state_dict) -> int:
    """The camera sweeps S of a model's weights: from the input channels of
    the fusion encoder's gate (256 + S·C) or, without LiDAR, of the BEV
    backbone's first conv (S·C). 1 for a LiDAR-only model."""
    if not cfg.with_camera:
        return 1
    C = cfg.camera_encoder.output_channels
    if cfg.with_lidar:
        return (state_dict["fusion_encoder.att_conv.weight"].shape[1] - cfg.bev_encoder.num_bev_features) // C
    return state_dict["bev_encoder.block0_conv0.weight"].shape[1] // C


class BEVFusionCenterHead(nn.Module):
    def __init__(self, cfg: ModelConfig, sweeps: int = 1):
        super().__init__()
        if not (cfg.with_lidar or cfg.with_camera):
            raise ValueError("the model needs at least one modality")
        self.cfg, self.sweeps = cfg, sweeps
        be = cfg.bev_encoder
        if cfg.with_lidar:
            self.lidar_encoder = LidarEncoder(cfg.lidar_encoder)
            bev_in = be.num_bev_features
        if cfg.with_camera:
            self.camera_encoder = LSSFPN(cfg.camera_encoder)
            bev_in = sweeps * cfg.camera_encoder.output_channels
        if cfg.with_lidar and cfg.with_camera:
            self.fusion_encoder = FusionEncoder(be.num_bev_features + bev_in)
            bev_in = 256  # the JAX FusionEncoder's out_channels
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
            if isinstance(m, (Conv2d, ConvTranspose2d, Linear, SubMConv)):
                m.compute_dtype = dtype

    def forward(self, voxel_feats: Optional[torch.Tensor] = None,
                voxel_coords: Optional[torch.Tensor] = None,
                imgs: Optional[torch.Tensor] = None,
                mats: Optional[Dict[str, torch.Tensor]] = None, spatial=None) -> Dict:
        if self.cfg.with_lidar:
            model_output = lidar_out = self.lidar_encoder(voxel_feats, voxel_coords)
        if self.cfg.with_camera:
            S = imgs.shape[1] if imgs.dim() == 6 else 1
            if S != self.sweeps:
                raise ValueError(f"imgs has shape {tuple(imgs.shape)}: {S} sweep(s), "
                                 f"and the model takes {self.sweeps}")
            model_output = self.camera_encoder(imgs, mats)
        if self.cfg.with_lidar and self.cfg.with_camera:
            model_output = self.fusion_encoder(lidar_out, model_output)
        awl = self.awl_params
        if spatial is None:
            bev, _pyramid = self.bev_encoder(model_output)
            preds = self.det_head(bev)
        else:
            rows = RowSplit(spatial, model_output.shape[2], math.prod(self.bev_encoder.layer_strides))
            bev, _pyramid = self.bev_encoder(rows.split(model_output), rows)
            preds = self.det_head(bev, rows)
            bev = rows.gather(bev)
            model_output = scale_grad(model_output, 1.0 / rows.size)
            awl = scale_grad(awl, 1.0 / rows.size)
        return dict(
            model_output=model_output.float(),
            bev_feature=bev.float(),
            multi_head_features=preds,
            awl_params=awl,
        )
