"""Checkpoints: save, prune, find, restore, and the shape-filtered merge of a
teacher's weights; the port's counterpart of the JAX package's
`training/checkpoint.py`.

Layout: `<ckpt_dir>/step_N/state.pt`, one `torch.save` of
  {"step": N, "model": the model's state dict (f32 master weights and the
   BatchNorm statistics), "optimizer": `Optimizer.state_dict()` (Adam's
   moments and step counts), when saved with one}
read back onto the CPU with `torch.load(weights_only=True)`: no pickled
code runs. The port reads no
orbax checkpoint of the JAX package; a checkpoint of the reference PyTorch
code goes through `training/torch_import.py`.
"""
from __future__ import annotations

import os
import shutil
from typing import Any, Dict, Mapping, Optional, Tuple

import torch

STATE_FILE = "state.pt"


def _steps(ckpt_dir: str):
    return sorted(int(d[5:]) for d in os.listdir(ckpt_dir) if d.startswith("step_") and d[5:].isdigit())


def save_checkpoint(ckpt_dir: str, step: int, model: torch.nn.Module, optimizer=None,
                    keep_latest: Optional[int] = None) -> None:
    """Save the model (and the optimizer's state) as `step_<step>`.
    Idempotent: a step already saved is left as it is (`fit` saves every
    epoch and the CLIs again at exit). `keep_latest` prunes all but the
    newest that many steps (the reference declares `num_keep_latest_ckpt`
    and never enforces it; the JAX package does, and so does the port)."""
    ckpt_dir = os.path.abspath(ckpt_dir)
    path = os.path.join(ckpt_dir, f"step_{step}")
    if os.path.exists(path):
        return
    payload = dict(step=int(step), model=model.state_dict())
    if optimizer is not None:
        payload["optimizer"] = optimizer.state_dict()
    tmp = f"{path}.tmp{os.getpid()}"
    os.makedirs(tmp)
    torch.save(payload, os.path.join(tmp, STATE_FILE))
    os.replace(tmp, path)
    if keep_latest:
        for old in _steps(ckpt_dir)[:-keep_latest]:
            shutil.rmtree(os.path.join(ckpt_dir, f"step_{old}"), ignore_errors=True)


def latest_checkpoint(ckpt_dir: str) -> Optional[str]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = _steps(ckpt_dir)
    return os.path.join(ckpt_dir, f"step_{steps[-1]}") if steps else None


def restore_checkpoint_any(path: str) -> Dict[str, Any]:
    """The saved payload of a step directory (`.../ckpt/step_12`) or of its
    parent (`.../ckpt`, resolved to its highest step), so that `--ckpt_path`
    works on exactly the path the train CLI saved."""
    path = os.path.abspath(path)
    if not os.path.exists(os.path.join(path, STATE_FILE)):
        if not os.path.isdir(path):
            raise ValueError(
                f"checkpoint path {path!r} is not a checkpoint step directory or a parent of "
                f"one: expected .../ckpt/step_N (holding {STATE_FILE}) or .../ckpt containing step_* dirs")
        latest = latest_checkpoint(path)
        if latest is None:
            raise ValueError(f"no step_* checkpoint directories under {path!r}: expected the "
                             "ckpt/step_N layout written by save_checkpoint")
        path = latest
    return torch.load(os.path.join(path, STATE_FILE), map_location="cpu", weights_only=True)


def shape_filtered_merge(target: Mapping[str, torch.Tensor], loaded: Mapping[str, Any]
                         ) -> Tuple[Dict[str, torch.Tensor], int, int]:
    """Overlay `loaded` onto `target` by name, skipping shape mismatches and
    names `target` lacks: the reference's teacher-load semantics
    (strict=False + shape filtering, …camera_exp_distill_lidar.py:407-416).
    Returns (merged, n_used, n_skipped), counted over `target`'s names."""
    used = skipped = 0
    out = {}
    for k, tv in target.items():
        lv = loaded.get(k)
        if lv is not None and tuple(lv.shape) == tuple(tv.shape):
            out[k] = torch.as_tensor(lv).to(dtype=tv.dtype)
            used += 1
        else:
            out[k] = tv
            skipped += 1
    return out, used, skipped
