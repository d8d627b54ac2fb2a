"""Lift-Splat-Shoot camera -> BEV encoder, counterpart of the JAX
`layers/lss.py`.

ResNet-50 (`cfg.img_backbone` "resnet50") -> SECONDFPN
-> 1×1 depth net (D depth logits + C context channels, in float32 from
there on) -> softmax over depth -> frustum geometry (ida⁻¹, intrin⁻¹,
sensor2ego, bda) -> fused depth x context BEV pooling (`ops/bev_pool.py`,
summed per BEV cell).

Numerics kept from the JAX module:
  * the frustum is built in numpy float32 exactly as there;
  * 4×4 inverses use the same closed-form adjugate (`inv44`);
  * the 4×4 transforms are elementwise products summed over the last axis,
    never a matmul, so TF32 settings cannot move a point across a cell;
  * cell coordinates truncate toward zero (the reference's `.int()`).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
from torch import nn

from .config import CameraEncoderConfig
from .common import Conv2d
from .resnet import ResNet
from .second_fpn import SECONDFPN
from .bev_pool import bev_pool_outer


def make_frustum(cfg: CameraEncoderConfig) -> np.ndarray:
    """[D, fH, fW, 4] homogeneous (u, v, d, 1) image-space frustum."""
    ogfH, ogfW = cfg.final_dim
    fH, fW = cfg.feat_hw
    d = np.arange(*cfg.d_bound, dtype=np.float32)  # [D]
    D = d.shape[0]
    u = np.linspace(0, ogfW - 1, fW, dtype=np.float32)
    v = np.linspace(0, ogfH - 1, fH, dtype=np.float32)
    uu = np.broadcast_to(u[None, None, :], (D, fH, fW))
    vv = np.broadcast_to(v[None, :, None], (D, fH, fW))
    dd = np.broadcast_to(d[:, None, None], (D, fH, fW))
    ones = np.ones_like(dd)
    return np.stack([uu, vv, dd, ones], axis=-1)


def inv44(m: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of batched 4×4 matrices (cofactor / adjugate)."""
    a = [[m[..., i, j] for j in range(4)] for i in range(4)]

    def det3(r0, r1, r2, c0, c1, c2):
        return (
            a[r0][c0] * (a[r1][c1] * a[r2][c2] - a[r1][c2] * a[r2][c1])
            - a[r0][c1] * (a[r1][c0] * a[r2][c2] - a[r1][c2] * a[r2][c0])
            + a[r0][c2] * (a[r1][c0] * a[r2][c1] - a[r1][c1] * a[r2][c0])
        )

    rows = (0, 1, 2, 3)
    cof = [[None] * 4 for _ in range(4)]
    for i in range(4):
        ri = tuple(r for r in rows if r != i)
        for j in range(4):
            cj = tuple(c for c in rows if c != j)
            minor = det3(ri[0], ri[1], ri[2], cj[0], cj[1], cj[2])
            cof[i][j] = minor if (i + j) % 2 == 0 else -minor
    det = sum(a[0][j] * cof[0][j] for j in range(4))
    adj = torch.stack(
        [torch.stack([cof[i][j] for i in range(4)], dim=-1) for j in range(4)],
        dim=-2,
    )  # transpose of the cofactors
    return adj / det[..., None, None]


def _apply44(m: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """out[..., i] = Σ_j m[..., i, j] p[..., j], broadcast over leading axes."""
    return (m * p[..., None, :]).sum(-1)


def get_geometry(
    frustum: torch.Tensor,
    sensor2ego: torch.Tensor,
    intrin: torch.Tensor,
    ida: torch.Tensor,
    bda: Optional[torch.Tensor],
) -> torch.Tensor:
    """Frustum [D, fH, fW, 4] and [B, N, 4, 4] camera matrices (bda [B, 4, 4])
    -> ego-frame xyz [B, N, D, fH, fW, 3]."""
    ex = lambda t: t[:, :, None, None, None]  # [B, N, 1, 1, 1, 4, 4]
    pts = _apply44(ex(inv44(ida)), frustum)
    pts = torch.cat([pts[..., :2] * pts[..., 2:3], pts[..., 2:]], dim=-1)
    # sensor2ego @ intrin⁻¹, as a broadcast product summed over j
    combine = (sensor2ego[..., :, :, None] * inv44(intrin)[..., None, :, :]).sum(-2)
    pts = _apply44(ex(combine), pts)
    if bda is not None:
        pts = _apply44(bda[:, None, None, None, None], pts)
    return pts[..., :3]


class LSSFPN(nn.Module):
    def __init__(self, cfg: CameraEncoderConfig):
        super().__init__()
        if cfg.img_backbone != "resnet50":
            raise ValueError(f"img_backbone {cfg.img_backbone!r}: the reference holds ResNet-50 only")
        self.cfg = cfg
        self.img_backbone = ResNet()
        self.img_neck = SECONDFPN(cfg.img_neck_in_channels, cfg.img_neck_out_channels,
                                  cfg.img_neck_upsample_strides)
        self.depth_net = Conv2d(sum(cfg.img_neck_out_channels),
                                   cfg.depth_channels + cfg.output_channels, 1, bias=True)
        self.register_buffer("frustum", torch.from_numpy(make_frustum(cfg)), persistent=False)

    def forward(self, imgs: torch.Tensor, mats: Dict[str, torch.Tensor]) -> torch.Tensor:
        """imgs [B, N, H, W, 3] (normalised); mats: sensor2ego_mats /
        intrin_mats / ida_mats [B, N, 4, 4], bda_mat [B, 4, 4] (optional).
        Returns the BEV feature [B, C, ny, nx] f32."""
        cfg = self.cfg
        B, N, H, W, _ = imgs.shape
        x = imgs.reshape(B * N, H, W, 3).permute(0, 3, 1, 2)
        fpn = self.img_neck(self.img_backbone(x))  # [B*N, 512, fH, fW]
        D, C = cfg.depth_channels, cfg.output_channels
        dc = self.depth_net(fpn).float()
        fH, fW = dc.shape[2:]
        depth = torch.softmax(dc[:, :D], dim=1).reshape(B, N, D, fH, fW)
        context = dc[:, D:].permute(0, 2, 3, 1).reshape(B, N, fH, fW, C)

        geom_idx = voxel_coords(cfg, self.frustum, mats)
        ny, nx = cfg.bev_hw
        bev = bev_pool_outer(geom_idx, depth, context.contiguous(), (nx, ny, 1))
        return bev.permute(0, 3, 1, 2)


def voxel_coords(cfg: CameraEncoderConfig, frustum: torch.Tensor, mats: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The frustum points' BEV voxel coordinates [B, N, D, fH, fW, 3] int32
    (x, y, z), for the camera matrices `mats` (as `LSSFPN.forward`)."""
    geom = get_geometry(
        frustum, mats["sensor2ego_mats"].float(), mats["intrin_mats"].float(),
        mats["ida_mats"].float(),
        mats["bda_mat"].float() if mats.get("bda_mat") is not None else None,
    )
    dev = geom.device
    lower = torch.tensor([cfg.x_bound[0], cfg.y_bound[0], cfg.z_bound[0]], dtype=torch.float32, device=dev)
    vsize = torch.tensor([cfg.x_bound[2], cfg.y_bound[2], cfg.z_bound[2]], dtype=torch.float32, device=dev)
    return ((geom - lower) / vsize).to(torch.int32)  # truncation toward zero
