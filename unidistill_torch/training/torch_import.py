"""Checkpoints of the reference PyTorch code -> the port's state dict.

The reference ships raw torch `{"model_state": ...}` dicts
(…camera_exp_distill_lidar.py:403-416). `convert_state_dict(sd, cfg)` maps
their names onto the port's (`models.bevfusion.BEVFusionCenterHead(cfg)`),
as the JAX package's `training/torch_import.convert_state_dict` maps them
onto its flax tree; composed with `jax_weights.state_dict_from_jax` that
gives the same tensors (tests/test_torch_checkpoint.py). The port keeps
PyTorch layouts, so most tensors keep theirs:
  * Conv2d, ConvTranspose2d, BatchNorm            -> as they are (each BN
    also gets a zero `num_batches_tracked`)
  * spconv 3D conv [O, kz, ky, kx, I] (spconv ≥2.x KRSC; the other two
    layouts are recognised by shape)              -> [K = kz·ky·kx, I, O]
  * an mmdet Swin image backbone (`patch_embed.projection`,
    `stages.{i}.blocks.{j}` with `attn.w_msa.*`, `ffn.layers.0.0` /
    `ffn.layers.1`, `stages.{i}.downsample.{norm,reduction}`, out
    `norm{i}`)                                    -> `layers/swin.py`'s
    names, Linear and LayerNorm as they are; the patch merge's norm and the
    reduction's input columns permuted from mmdet's channel-major Unfold
    order (c·4 + p) to the port's position-major one (p·C + c)
  * the CenterHead's per-branch SepHeads          -> the fused head: conv0
    weights, biases and BNs stacked along the output channels, the out
    convs zero-padded to o_max rows each and stacked (the grouped
    `out_conv`), their biases likewise (`out_bias`)
Missing names are skipped, not errors: the reference loads teachers with
strict=False + shape filtering, so partial state dicts convert partially
(the head's branches all or none).
"""
from __future__ import annotations

from typing import Dict, Mapping

import torch
import torch.nn.functional as F

from unidistill_torch.configs.nuscenes import ModelConfig
from unidistill_torch.layers.center_head import branch_list


def spconv3d(w: torch.Tensor, cin: int, cout: int) -> torch.Tensor:
    """spconv kernel -> [K, Cin, Cout], the layout recognised by shape."""
    if w.ndim != 5:
        raise ValueError(f"unexpected spconv weight ndim {w.ndim}")
    if w.shape[0] == cout and w.shape[-1] == cin:  # (O, kz, ky, kx, I)
        w = w.permute(1, 2, 3, 4, 0)
    elif w.shape[-1] == cout and w.shape[-2] == cin:  # (kz, ky, kx, I, O)
        pass
    elif w.shape[0] == cin and w.shape[-1] == cout:  # (I, kz, ky, kx, O)
        w = w.permute(1, 2, 3, 0, 4)
    else:
        raise ValueError(f"unrecognized spconv layout {tuple(w.shape)}")
    return w.reshape(-1, cin, cout)


class _Converter:
    def __init__(self, sd: Mapping[str, torch.Tensor]):
        self.sd = sd
        self.out: Dict[str, torch.Tensor] = {}

    def put(self, name: str, value) -> None:
        self.out[name] = torch.as_tensor(value).to(torch.float32).contiguous()

    def conv(self, t: str, p: str, bias: bool = False) -> None:
        if f"{t}.weight" not in self.sd:
            return
        self.put(f"{p}.weight", self.sd[f"{t}.weight"])
        if bias and f"{t}.bias" in self.sd:
            self.put(f"{p}.bias", self.sd[f"{t}.bias"])

    def bn(self, t: str, p: str) -> None:
        if f"{t}.weight" not in self.sd:
            return
        for leaf in ("weight", "bias", "running_mean", "running_var"):
            self.put(f"{p}.{leaf}", self.sd[f"{t}.{leaf}"])
        self.out[f"{p}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)

    def spconv(self, t: str, p: str, cin: int, cout: int, bias: bool = False) -> None:
        if f"{t}.weight" not in self.sd:
            return
        self.put(f"{p}.weight", spconv3d(torch.as_tensor(self.sd[f"{t}.weight"]), cin, cout))
        if bias and f"{t}.bias" in self.sd:
            self.put(f"{p}.bias", self.sd[f"{t}.bias"])


def _sparse_backbone(b: _Converter, t: str, j: str) -> None:
    """VoxelResBackBone8x (ref spconv_backbone.py:253-343)."""
    b.spconv(f"{t}.conv_input.0", f"{j}.conv_input", 5, 16)
    b.bn(f"{t}.conv_input.1", f"{j}.bn_input")
    stages = (("conv1", None, None, 16, 16, ("res1a", "res1b")),
              ("conv2", "down2", "bn2", 16, 32, ("res2a", "res2b")),
              ("conv3", "down3", "bn3", 32, 64, ("res3a", "res3b")),
              ("conv4", "down4", "bn4", 64, 128, ("res4a", "res4b")))
    for tname, jdown, jbn, cin, cout, res_names in stages:
        first = 0
        if jdown is not None:  # conv1 is two blocks; the others start with a strided conv
            b.spconv(f"{t}.{tname}.0.0", f"{j}.{jdown}", cin, cout)
            b.bn(f"{t}.{tname}.0.1", f"{j}.{jbn}")
            first = 1
        for blk, name in enumerate(res_names):
            tb = f"{t}.{tname}.{blk + first}"
            for c in ("conv1", "conv2"):
                b.spconv(f"{tb}.{c}", f"{j}.{name}.{c}", cout, cout, bias=True)
            b.bn(f"{tb}.bn1", f"{j}.{name}.bn1")
            b.bn(f"{tb}.bn2", f"{j}.{name}.bn2")
    b.spconv(f"{t}.conv_out.0", f"{j}.conv_out", 128, 128)
    b.bn(f"{t}.conv_out.1", f"{j}.bn_out")


def _resnet50(b: _Converter, t: str, j: str) -> None:
    b.conv(f"{t}.conv1", f"{j}.conv1")
    b.bn(f"{t}.bn1", f"{j}.bn1")
    for stage, n in enumerate((3, 4, 6, 3)):
        for blk in range(n):
            tb, jb = f"{t}.layer{stage + 1}.{blk}", f"{j}.layer{stage + 1}_{blk}"
            for c in ("conv1", "conv2", "conv3"):
                b.conv(f"{tb}.{c}", f"{jb}.{c}")
            for c in ("bn1", "bn2", "bn3"):
                b.bn(f"{tb}.{c}", f"{jb}.{c}")
            if f"{tb}.downsample.0.weight" in b.sd:
                b.conv(f"{tb}.downsample.0", f"{jb}.downsample_conv")
                b.bn(f"{tb}.downsample.1", f"{jb}.downsample_bn")


def _swin(b: _Converter, t: str, j: str, embed_dim: int = 96, depths=(2, 2, 6, 2),
          out_indices=(1, 2, 3)) -> None:
    """mmdet SwinTransformer (the reference's Swin-T camera variant); its
    LayerNorms and Linears keep torch's layout, so they copy as a conv does."""
    b.conv(f"{t}.patch_embed.projection", f"{j}.patch_embed", bias=True)
    b.conv(f"{t}.patch_embed.norm", f"{j}.patch_norm", bias=True)
    dim = embed_dim
    for st, depth in enumerate(depths):
        for blk in range(depth):
            tb, jb = f"{t}.stages.{st}.blocks.{blk}", f"{j}.stage{st}_block{blk}"
            for n in ("norm1", "norm2"):
                b.conv(f"{tb}.{n}", f"{jb}.{n}", bias=True)
            table = f"{tb}.attn.w_msa.relative_position_bias_table"
            if table in b.sd:
                b.put(f"{jb}.attn.relative_position_bias_table", b.sd[table])
            b.conv(f"{tb}.attn.w_msa.qkv", f"{jb}.attn.qkv", bias=True)
            b.conv(f"{tb}.attn.w_msa.proj", f"{jb}.attn.proj", bias=True)
            b.conv(f"{tb}.ffn.layers.0.0", f"{jb}.mlp_fc1", bias=True)
            b.conv(f"{tb}.ffn.layers.1", f"{jb}.mlp_fc2", bias=True)
        down = f"{t}.stages.{st}.downsample"
        if f"{down}.reduction.weight" in b.sd:
            perm = torch.tensor([c * 4 + p for p in range(4) for c in range(dim)])
            b.put(f"{j}.merge_norm{st}.weight", torch.as_tensor(b.sd[f"{down}.norm.weight"])[perm])
            b.put(f"{j}.merge_norm{st}.bias", torch.as_tensor(b.sd[f"{down}.norm.bias"])[perm])
            b.put(f"{j}.merge_reduction{st}.weight", torch.as_tensor(b.sd[f"{down}.reduction.weight"])[:, perm])
        dim *= 2
    for st in out_indices:
        b.conv(f"{t}.norm{st}", f"{j}.out_norm{st}", bias=True)


def _bev_backbone(b: _Converter, t: str, j: str, layer_nums) -> None:
    for i, n in enumerate(layer_nums):
        # torch Sequential: [ZeroPad, Conv, BN, ReLU, (Conv, BN, ReLU) * n]
        b.conv(f"{t}.blocks.{i}.1", f"{j}.block{i}_conv0")
        b.bn(f"{t}.blocks.{i}.2", f"{j}.block{i}_bn0")
        for k in range(n):
            b.conv(f"{t}.blocks.{i}.{4 + 3 * k}", f"{j}.block{i}_conv{k + 1}")
            b.bn(f"{t}.blocks.{i}.{5 + 3 * k}", f"{j}.block{i}_bn{k + 1}")
        b.conv(f"{t}.deblocks.{i}.0", f"{j}.deblock{i}_conv")
        b.bn(f"{t}.deblocks.{i}.1", f"{j}.deblock{i}_bn")


def _center_head(b: _Converter, t: str, j: str, tasks, common_heads) -> None:
    """The reference's per-branch SepHeads packed into the fused head, in
    `center_head.branch_list` order."""
    b.conv(f"{t}.shared_conv.0", f"{j}.shared_conv", bias=True)
    b.bn(f"{t}.shared_conv.1", f"{j}.shared_bn")
    branches = branch_list(tuple(tasks), tuple(common_heads))
    if any(f"{t}.tasks.{tid}.{name}.0.weight" not in b.sd for tid, name, _ch in branches):
        return
    o_max = max(ch for _, _, ch in branches)
    num_convs = {n: nc for n, (_c, nc) in common_heads}
    parts: Dict[str, list] = {k: [] for k in ("w0", "b0", "s0", "be0", "m0", "v0", "wo", "bo")}
    for tid, name, ch in branches:
        if num_convs.get(name, 2) != 2:
            raise ValueError(f"the fused head takes num_conv=2 (the reference's value); "
                             f"{name} has {num_convs[name]}")
        tb = f"{t}.tasks.{tid}.{name}"
        g = lambda k: torch.as_tensor(b.sd[f"{tb}.{k}"])
        # torch Sequential layout: 0 conv, 1 bn, 2 relu, 3 out conv
        for key, src in (("w0", "0.weight"), ("b0", "0.bias"), ("s0", "1.weight"), ("be0", "1.bias"),
                         ("m0", "1.running_mean"), ("v0", "1.running_var")):
            parts[key].append(g(src))
        parts["wo"].append(F.pad(g("3.weight"), (0, 0, 0, 0, 0, 0, 0, o_max - ch)))
        parts["bo"].append(F.pad(g("3.bias"), (0, o_max - ch)))
    cat = {k: torch.cat(v) for k, v in parts.items()}
    b.put(f"{j}.branches_conv0.weight", cat["w0"])
    b.put(f"{j}.branches_conv0.bias", cat["b0"])
    b.put(f"{j}.branches_bn0.weight", cat["s0"])
    b.put(f"{j}.branches_bn0.bias", cat["be0"])
    b.put(f"{j}.branches_bn0.running_mean", cat["m0"])
    b.put(f"{j}.branches_bn0.running_var", cat["v0"])
    b.out[f"{j}.branches_bn0.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    b.put(f"{j}.out_conv.weight", cat["wo"])
    b.put(f"{j}.out_bias", cat["bo"])


def convert_state_dict(sd: Mapping[str, torch.Tensor], cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """Reference BEVFusionCenterHead state dict -> the port's state dict
    (f32; only the names the reference dict has)."""
    b = _Converter(sd)
    if cfg.with_lidar and any(k.startswith("lidar_encoder") for k in sd):
        _sparse_backbone(b, "lidar_encoder.backbone_3d", "lidar_encoder.backbone_3d")
    if cfg.with_camera and any(k.startswith("camera_encoder") for k in sd):
        cam = "camera_encoder.backbone"
        backbone = _swin if cfg.camera_encoder.img_backbone == "swin" else _resnet50
        backbone(b, f"{cam}.img_backbone", "camera_encoder.img_backbone")
        for i in range(len(cfg.camera_encoder.img_neck_upsample_strides)):
            b.conv(f"{cam}.img_neck.deblocks.{i}.0", f"camera_encoder.img_neck.deblock{i}_conv")
            b.bn(f"{cam}.img_neck.deblocks.{i}.1", f"camera_encoder.img_neck.deblock{i}_bn")
        b.conv(f"{cam}.depth_net.0", "camera_encoder.depth_net", bias=True)
    if cfg.with_lidar and cfg.with_camera and any(k.startswith("fusion_encoder") for k in sd):
        b.conv("fusion_encoder.att.1", "fusion_encoder.att_conv", bias=True)
        b.conv("fusion_encoder.reduce_conv.0", "fusion_encoder.reduce_conv")
        b.bn("fusion_encoder.reduce_conv.1", "fusion_encoder.reduce_bn")
    _bev_backbone(b, "bev_encoder.backbone_2d", "bev_encoder", cfg.bev_encoder.layer_nums)
    _center_head(b, "det_head.dense_head", "det_head", cfg.tasks, cfg.det_head.common_heads)
    if "det_head.dense_head.auto_loss.params" in sd:
        b.put("awl_params", sd["det_head.dense_head.auto_loss.params"])
    return b.out


def load_torch_checkpoint(path: str, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    """A reference `.pth` (`{"model_state": ...}`, `{"state_dict": ...}` or a
    bare state dict), read with `weights_only=True`, converted."""
    ckpt = torch.load(path, map_location="cpu", weights_only=True)
    sd = ckpt.get("model_state", ckpt.get("state_dict", ckpt))
    return convert_state_dict(sd, cfg)
