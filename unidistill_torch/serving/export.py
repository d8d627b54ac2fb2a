"""Serving export: the eval step as a `torch.export` program with its weights.

Counterpart of the JAX package's `serving/export.py`. `export_detector`
traces the WHOLE eval step -- voxelise → encoders → BEV backbone → heads →
decode + NMS -- with `torch.export.export` and saves it with its weights, so
a serving host needs only `load_detector(path).predict(batch)` and no model
code: the loader imports the kernels' op registrations (`ops/bev_pool.py`,
`ops/nms.py`, `ops/sparse_conv.py`, which load `kernels/build.py`), never
`models`, `layers` or `training`. The program calls the kernels as the
custom ops `unidistill::bev_pool` (K1), `unidistill::rotated_iou_mask` (K2),
`unidistill::nms_greedy_select` (K3) and `unidistill::sparse_conv` (K4); on
the card they launch the kernels, on the CPU their plain versions.

The sizes that depend on the data stay symbolic: the active voxels of each
stage of the LiDAR encoder, its rulebooks' rows and K1's plan. So a program
traced once serves any batch of the exported shape, whatever its points.
The batch size and the input shapes (the caps) are fixed at export.

Artifact layout (a directory):
  model.pt2   `torch.export.save` of the eval step, weights included; it
              runs on the device it was exported on (`meta.json`'s
              `platforms`) and loads only under the torch that saved it
  meta.json   modality flags, class names, the device, the torch version
              and the expected input shapes and dtypes (`batch_spec`,
              flattened by '/'-joined path, e.g. "mats/ida_mats")

Input modes (`_batch_spec`): "points", the padded point clouds, voxelised
in the program; "host_voxels", loader-side voxels `voxel_feats` and
`voxel_coords` at `caps.max_voxels_eval` (the JAX package's `topo_*` tables
have no counterpart: the port's encoder builds its rulebooks from the
coordinates). A camera detector also takes `imgs` and the four `mats`;
`gt_boxes` stays in the spec, as in the JAX package.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, NamedTuple, Tuple

import numpy as np
import torch

# the kernels' op registrations: `torch.export.load` needs them
from unidistill_torch.ops import bev_pool, nms, sparse_conv  # noqa: F401

MODEL_FILE = "model.pt2"
META_FILE = "meta.json"
INPUT_MODES = ("points", "host_voxels")


class Spec(NamedTuple):
    shape: Tuple[int, ...]
    dtype: str  # numpy's name: "float32", "int32", "bool"


def _batch_spec(cfg, batch_size: int, input_mode: str = "points", sweeps: int = 1) -> Dict[str, Any]:
    """Shapes and dtypes of the eval input batch at the configured caps, as
    the JAX `_batch_spec` (without its `topo_*` tables); with `sweeps` > 1
    (weights of a multi-sweep camera encoder), imgs and the three per-camera
    mats carry a sweep axis after the batch."""
    if input_mode not in INPUT_MODES:
        raise ValueError(f"unknown input_mode {input_mode!r}")
    spec: Dict[str, Any] = {}
    if cfg.with_lidar:
        C = cfg.lidar_encoder.use_num_point_features
        if input_mode == "host_voxels":
            V = cfg.caps.max_voxels_eval
            spec["voxel_feats"] = Spec((batch_size, V, C), "float32")
            spec["voxel_coords"] = Spec((batch_size, V, 3), "int32")
        else:
            P = cfg.caps.max_points
            spec["points"] = Spec((batch_size, P, 5), "float32")
            spec["points_mask"] = Spec((batch_size, P), "bool")
    if cfg.with_camera:
        n = cfg.camera_encoder.num_cams
        h, w = cfg.camera_encoder.final_dim
        lead = (batch_size,) if sweeps == 1 else (batch_size, sweeps)
        spec["imgs"] = Spec(lead + (n, h, w, 3), "float32")
        m44 = Spec(lead + (n, 4, 4), "float32")
        spec["mats"] = dict(sensor2ego_mats=m44, intrin_mats=m44, ida_mats=m44,
                            bda_mat=Spec((batch_size, 4, 4), "float32"))
    # gt_boxes unused at eval but part of the batch contract
    spec["gt_boxes"] = Spec((batch_size, cfg.caps.max_gt_boxes, 10), "float32")
    return spec


def _flatten_paths(tree: Dict[str, Any], prefix: str = "") -> Dict[str, Any]:
    """{'a': {'b': x}} → {'a/b': x} (the JAX '/'-joined flatten)."""
    out: Dict[str, Any] = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten_paths(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _unflatten_paths(flat: Dict[str, Any]) -> Dict[str, Any]:
    """{'a/b': x} → {'a': {'b': x}} (inverse of the '/'-joined flatten)."""
    out: Dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def _dtype_name(v) -> str:
    if isinstance(v, torch.Tensor):
        return str(torch.empty(0, dtype=v.dtype).numpy().dtype)
    return str(np.asarray(v).dtype)


class _EvalStep(torch.nn.Module):
    """The traced function: `training.steps.eval_step` of the model."""

    def __init__(self, model: torch.nn.Module, cfg):
        super().__init__()
        self.model, self.cfg = model, cfg

    def forward(self, batch: Dict[str, Any]) -> Dict[str, torch.Tensor]:
        from unidistill_torch.training.steps import eval_step
        return eval_step(self.model, batch, self.cfg)


def export_detector(cfg, state_dict, out_dir: str, batch_size: int = 1,
                    input_mode: str = "points", device="cuda") -> torch.export.ExportedProgram:
    """Export the eval step of the detector `cfg` with the weights
    `state_dict` to `out_dir` (model.pt2 + meta.json), on `device`.

    `input_mode`: "points" (the program voxelises) or "host_voxels"
    (loader-side voxels; see `_batch_spec`)."""
    from unidistill_torch.models.bevfusion import BEVFusionCenterHead, sweeps_from_state_dict
    from unidistill_torch.serving.predictor import resolve_device

    sweeps = sweeps_from_state_dict(cfg, state_dict)
    spec = _batch_spec(cfg, batch_size, input_mode, sweeps)
    device = resolve_device(device)
    model = BEVFusionCenterHead(cfg, sweeps)
    model.load_state_dict(dict(state_dict), strict=True)
    model = model.to(device).eval()
    example = _unflatten_paths({
        k: torch.zeros(s.shape, dtype=getattr(torch, s.dtype), device=device)
        for k, s in _flatten_paths(spec).items()})
    with torch.no_grad():
        ep = torch.export.export(_EvalStep(model, cfg), (example,), strict=False)
    os.makedirs(out_dir, exist_ok=True)
    torch.export.save(ep, os.path.join(out_dir, MODEL_FILE))
    meta = dict(
        with_lidar=cfg.with_lidar,
        with_camera=cfg.with_camera,
        batch_size=batch_size,
        input_mode=input_mode,
        platforms=[device.type],
        class_names=list(cfg.class_names),
        torch_version=torch.__version__,
        batch_spec={k: dict(shape=list(s.shape), dtype=s.dtype)
                    for k, s in _flatten_paths(spec).items()},
    )
    with open(os.path.join(out_dir, META_FILE), "w") as f:
        json.dump(meta, f, indent=1)
    return ep


class LoadedDetector:
    """A loaded serving artifact; `predict(batch)` returns the ROI dict
    (boxes [B, R, 9], scores, labels (1-based), mask) as numpy arrays.
    `program` is the loaded eval step, which takes `inputs(batch)`."""

    def __init__(self, path: str):
        with open(os.path.join(path, META_FILE)) as f:
            self.meta = json.load(f)
        saved = self.meta["torch_version"]
        if saved != torch.__version__:
            raise RuntimeError(f"{path} was exported with torch {saved}; a .pt2 loads only under the "
                               f"torch that saved it, and this is torch {torch.__version__}: export it again")
        self.device = torch.device(self.meta["platforms"][0])
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError(f"{path} was exported for CUDA, and CUDA is not available here")
        self.program = torch.export.load(os.path.join(path, MODEL_FILE)).module()

    def inputs(self, batch) -> Dict[str, Any]:
        """The batch checked against `meta.json`'s `batch_spec` (the JAX
        package's checks and messages), as the program's tensors on its
        device. Keys outside the exported contract (e.g. loader-side tables
        or training-only fields) are dropped."""
        spec = self.meta["batch_spec"]
        flat = _flatten_paths(dict(batch))
        missing = sorted(set(spec) - set(flat))
        if missing:
            raise ValueError(f"batch is missing keys {missing}; expected "
                             f"{sorted(spec)} (see meta.json batch_spec)")
        for k, s in spec.items():
            got = tuple(np.shape(flat[k]))
            if got != tuple(s["shape"]):
                raise ValueError(f"batch[{k!r}] has shape {got}, expected "
                                 f"{tuple(s['shape'])} dtype {s['dtype']}")
            got_dt = _dtype_name(flat[k])
            if got_dt != s["dtype"]:
                raise ValueError(f"batch[{k!r}] has dtype {got_dt}, expected "
                                 f"{s['dtype']} (shape {tuple(s['shape'])})")
        return _unflatten_paths({k: torch.as_tensor(flat[k]).to(self.device) for k in spec})

    def predict(self, batch) -> Dict[str, np.ndarray]:
        with torch.no_grad():
            out = self.program(self.inputs(batch))
        return {k: v.cpu().numpy() for k, v in out.items()}


def load_detector(path: str) -> LoadedDetector:
    return LoadedDetector(path)
