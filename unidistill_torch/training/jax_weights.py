"""JAX parameter trees -> the port's state dict.

`state_dict_from_jax(params, batch_stats, cfg)` takes the JAX package's
flax `params` and `batch_stats` trees (nested mappings of arrays, e.g. after
`jax.device_get`) and returns the state dict that
`models.bevfusion.BEVFusionCenterHead(cfg)` loads with `strict=True`. The
port's module names are the JAX ones, so most keys are the JAX path joined
with dots. Layouts:
  * Conv kernel [kh, kw, I, O]               -> Conv2d weight [O, I, kh, kw]
  * ConvTranspose kernel [kh, kw, I, O]      -> ConvTranspose2d weight
    [I, O, kh, kw], spatially flipped (torch mirrors the kernel, flax does
    not; the inverse of the JAX importer's `conv_transpose2d`)
  * BatchNorm scale/bias + mean/var          -> weight/bias + running_*
  * det_head out_kernel [3, 3, G, hc, o_max] -> grouped out_conv weight
    [G·o_max, hc, 3, 3]; out_bias [G, o_max] -> [G·o_max]
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch

from unidistill_torch.configs.nuscenes import ModelConfig


def _flatten(tree: Any, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (str(k),))
    else:
        yield prefix, np.asarray(tree, dtype=np.float32)


def transposed_convs(cfg: ModelConfig) -> set:
    """Dotted names of the modules that are transposed convs."""
    out = set()
    for i, s in enumerate(cfg.camera_encoder.img_neck_upsample_strides):
        if s >= 1:
            out.add(f"camera_encoder.img_neck.deblock{i}_conv")
    for i, s in enumerate(cfg.bev_encoder.upsample_strides):
        if s >= 1:
            out.add(f"bev_encoder.deblock{i}_conv")
    return out


def state_dict_from_jax(params: Mapping, batch_stats: Mapping, cfg: ModelConfig) -> Dict[str, torch.Tensor]:
    deconvs = transposed_convs(cfg)
    sd: Dict[str, np.ndarray] = {}
    for path, a in _flatten(params):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if path == ("det_head", "out_kernel"):
            _, _, G, hc, o_max = a.shape
            sd["det_head.out_conv.weight"] = a.transpose(2, 4, 3, 0, 1).reshape(G * o_max, hc, 3, 3)
        elif path == ("det_head", "out_bias"):
            sd["det_head.out_bias"] = a.reshape(-1)
        elif path == ("awl_params",):
            sd["awl_params"] = a
        elif leaf == "kernel":
            if mod in deconvs:
                sd[f"{mod}.weight"] = a[::-1, ::-1].transpose(2, 3, 0, 1)
            else:
                sd[f"{mod}.weight"] = a.transpose(3, 2, 0, 1)
        elif leaf == "scale":
            sd[f"{mod}.weight"] = a
        elif leaf == "bias":
            sd[f"{mod}.bias"] = a
        else:
            raise KeyError(f"unexpected JAX parameter {'/'.join(path)}")
    # a fresh copy: a flipped size-1 axis keeps a negative stride that numpy
    # still calls contiguous and torch refuses
    out = {k: torch.from_numpy(np.array(v, order="C", copy=True)) for k, v in sd.items()}
    for path, a in _flatten(batch_stats):
        mod, leaf = ".".join(path[:-1]), path[-1]
        if leaf not in ("mean", "var"):
            raise KeyError(f"unexpected JAX batch stat {'/'.join(path)}")
        out[f"{mod}.running_{leaf}"] = torch.from_numpy(np.array(a, order="C", copy=True))
        out[f"{mod}.num_batches_tracked"] = torch.zeros((), dtype=torch.int64)
    return out
