"""The port stands alone: it imports neither JAX nor the JAX package nor the
JAX experiment scripts (`experiments/`, whose microbenchmarks the port
carries as `unidistill_torch.experiments`), opens no file of the JAX
package or its C++ runtime (`unidistill_tpu/`, `runtime/`) and loads no
library but those it builds from its own sources, and its own copy of the
configuration equals the JAX one field for field."""
import dataclasses
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from unidistill_tpu.configs import nuscenes as jcfg

from unidistill_torch.configs import nuscenes as pcfg

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "unidistill_tpu", "experiments",
             "mb_pallas_fused", "mb_gather_pallas", "mb_subm_banded", "mb_flat_subm",
             "occupancy_profile")


def test_importing_the_port_pulls_in_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import unidistill_torch\n"
        "for m in pkgutil.walk_packages(unidistill_torch.__path__, 'unidistill_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "print(len([k for k in sys.modules if k.startswith('unidistill_torch.')]))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    n_modules = int(res.stdout.split()[0])
    assert n_modules >= 72, res.stdout  # the training, data, CLI, microbenchmark, leaf and gate modules included


def test_the_loader_touches_only_the_ports_own_files(tmp_path):
    """A fresh process imports every module of the port, builds the host
    library and loads frames of the synthetic mini-nuScenes through the
    port's loader, under an audit hook: no file under `unidistill_tpu/` or
    `runtime/` is opened, and every library loaded from the checkout is
    the port's host library, built from `unidistill_torch/csrc/host/`."""
    from tests.test_data_pipeline import build_synth_nusc  # the JAX package's test helper

    root = build_synth_nusc(tmp_path / "nusc", 2)
    code = (
        "import sys\n"
        "opened, loaded = [], []\n"
        "def hook(event, args):\n"
        "    if event == 'open' and isinstance(args[0], (str, bytes)):\n"
        "        opened.append(str(args[0]))\n"
        "    elif event == 'ctypes.dlopen':\n"
        "        loaded.append(str(args[0]))\n"
        "sys.addaudithook(hook)\n"
        "import importlib, json, os, pkgutil\n"
        "import unidistill_torch\n"
        "for m in pkgutil.walk_packages(unidistill_torch.__path__, 'unidistill_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "from unidistill_torch.configs.nuscenes import DataConfig, tiny_model\n"
        "from unidistill_torch.data.collate import DataLoader\n"
        "from unidistill_torch.data.dataset import NuScenesDataset\n"
        "from unidistill_torch.kernels.build import host_library_path\n"
        f"ds = NuScenesDataset(DataConfig(root_path={str(root)!r}, num_lidar_sweeps=2), tiny_model(), 'training')\n"
        "batches = list(DataLoader(ds, 2))\n"
        "print(json.dumps(dict(opened=[os.path.realpath(p) for p in opened],\n"
        "                      loaded=[os.path.realpath(p) for p in loaded if os.sep in p],\n"
        "                      host=str(host_library_path()), n=len(batches))))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["n"] == 1
    jax_dirs = (str(ROOT / "unidistill_tpu") + os.sep, str(ROOT / "runtime") + os.sep)
    assert not [p for p in out["opened"] if p.startswith(jax_dirs)]
    assert any(p.startswith(str(ROOT / "unidistill_torch" / "csrc" / "host")) for p in out["opened"])
    ours = [p for p in out["loaded"] if p.startswith(str(ROOT) + os.sep)]
    assert ours == [out["host"]]


def test_the_convergence_gate_touches_only_the_ports_own_files():
    """A fresh process imports `experiments.convergence` alone, makes the
    gate's batches (the host library's voxeliser) and scores fixed
    decodes, under an audit hook: no JAX module is imported and no file
    under `unidistill_tpu/` or `runtime/`, nor the JAX gate's
    `tests/test_convergence.py`, is opened."""
    code = (
        "import sys\n"
        "opened = []\n"
        "sys.addaudithook(lambda e, a: opened.append(str(a[0])) if e == 'open' and isinstance(a[0], (str, bytes)) else None)\n"
        "import json, os\n"
        "import numpy as np\n"
        "from unidistill_torch.configs.nuscenes import tiny_model\n"
        "from unidistill_torch.experiments import convergence as cv\n"
        "b = cv.concat_batches(cv.scene_batch(tiny_model(), 1, 0, scene=cv.SCENE2), cv.scene_batch(tiny_model(), 1, 1))\n"
        "res = dict(boxes=np.zeros((2, 4, 9), np.float32), scores=np.zeros((2, 4), np.float32),\n"
        "           labels=np.ones((2, 4), np.int32))\n"
        "hits = cv.box_hits(res, [cv.SCENE2, cv.SCENE2B])\n"
        f"bad = sorted(k for k in sys.modules if k.split('.')[0] in {FORBIDDEN!r})\n"
        "print(json.dumps(dict(opened=[os.path.realpath(p) for p in opened], bad=bad, hits=hits,\n"
        "                      shape=list(b['voxel_coords'].shape), cams=list(b['imgs'].shape))))\n"
    )
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stdout + res.stderr
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["bad"] == [] and out["hits"] == [0, 0]
    assert out["shape"] == [2, 2048, 3] and out["cams"][:2] == [2, 2]
    jax_files = (str(ROOT / "unidistill_tpu") + os.sep, str(ROOT / "runtime") + os.sep,
                 str(ROOT / "tests" / "test_convergence.py"))
    assert not [p for p in out["opened"] if p.startswith(jax_files)]


def _sources():
    files = sorted((ROOT / "unidistill_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 15
    return files


@pytest.mark.parametrize("name", FORBIDDEN)
def test_no_source_imports_jax(name):
    pat = re.compile(rf"^\s*(import|from)\s+{name}\b", re.M)
    hits = [str(f.relative_to(ROOT)) for f in _sources() if pat.search(f.read_text())]
    assert not hits, f"{name} imported by {hits}"


@pytest.mark.parametrize("make", [
    lambda m: m.camera_exp(),
    lambda m: m.camera_exp().model,
    lambda m: m.tiny_model(with_lidar=False),
    lambda m: m.tiny_model(),
    lambda m: m.ModelConfig(),
    lambda m: m.lidar_exp(),
    lambda m: m.lidar_exp().model,
    lambda m: m.tiny_model(with_camera=False),
    lambda m: m.distill_exp("lidar", "camera"),
    lambda m: m.distill_exp("fusion", "camera"),
    lambda m: m.distill_exp("camera", "lidar"),
    lambda m: m.TrainConfig(),
    lambda m: m.DistillConfig(),
    lambda m: m.fusion_exp(),
    lambda m: m.fusion_exp().model,
    lambda m: m.distill_exp("fusion", "lidar"),
], ids=["camera_exp", "camera_model", "tiny_camera", "tiny", "default_model", "lidar_exp",
        "lidar_model", "tiny_lidar", "distill_lidar_camera", "distill_fusion_camera",
        "distill_camera_lidar", "train", "distill", "fusion_exp", "fusion_model",
        "distill_fusion_lidar"])
def test_config_copy_matches_jax(make):
    ours, ref = make(pcfg), make(jcfg)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    m_ours = getattr(ours, "model", ours)
    m_ref = getattr(ref, "model", ref)
    if hasattr(m_ref, "feature_map_size"):
        assert m_ours.feature_map_size == m_ref.feature_map_size
        for prop in ("depth_channels", "feat_hw", "bev_hw"):
            assert getattr(m_ours.camera_encoder, prop) == getattr(m_ref.camera_encoder, prop)


@pytest.mark.parametrize("make,overrides", [
    (lambda m: m.lidar_exp(), {"model.det_head.iou_weight": 2, "model.grid_size": [720, 720, 1],
                               "data.use_cbgs": "true", "train.max_epochs": 7}),
    (lambda m: m.distill_exp("lidar", "camera"), {"train.lr": 0.0002, "data.use_cbgs": False,
                                                  "data.root_path": "/some/path", "train.eval_interval": "3",
                                                  "distill.w_feature": 1, "train.seed": 5}),
    (lambda m: m.camera_exp(), {"model.camera_encoder.final_dim": (128, 352), "train.lr_milestones": [4],
                                "model.caps.max_points": 1000.0, "data.to_rgb": "False"}),
    (lambda m: m.fusion_exp(), {}),
], ids=["lidar", "distill", "camera", "none"])
def test_apply_overrides_matches_jax(make, overrides):
    """`--exp_options` overrides: nested, with the field's type coerced
    (int -> float, list -> tuple, strings -> bool / int), field for field
    the JAX result; the original config is left as it was."""
    base = make(pcfg)
    ours, ref = pcfg.apply_overrides(base, overrides), jcfg.apply_overrides(make(jcfg), overrides)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert base == make(pcfg)
    for k in overrides:
        a, b = ours, ref
        for part in k.split("."):
            a, b = getattr(a, part), getattr(b, part)
        assert type(a) is type(b), k


@pytest.mark.parametrize("key", ["model.det_head.not_a_field", "nothing", "train.lr.x"])
def test_apply_overrides_unknown_key_raises_as_jax(key):
    for m in (pcfg, jcfg):
        with pytest.raises((TypeError, AttributeError)):
            m.apply_overrides(m.lidar_exp(), {key: 1})


def test_constants_match_jax():
    for name in ("POINT_CLOUD_RANGE", "VOXEL_SIZE", "GRID_SIZE", "IMG_DIM",
                 "OUT_SIZE_FACTOR", "CLASS_NAMES", "TASKS", "CLASS_TO_IDX"):
        assert getattr(pcfg, name) == getattr(jcfg, name), name
    assert pcfg.DISTILL_VARIANTS.keys() == jcfg.DISTILL_VARIANTS.keys()
    for key, v in jcfg.DISTILL_VARIANTS.items():
        assert dataclasses.asdict(pcfg.DISTILL_VARIANTS[key]) == dataclasses.asdict(v), key
