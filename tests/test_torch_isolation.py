"""The port stands alone: it imports neither JAX nor the JAX package nor the
JAX experiment scripts (`experiments/`, whose microbenchmarks the port
carries as `unidistill_torch.experiments`), and its own copy of the
configuration equals the JAX one field for field."""
import dataclasses
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
    assert n_modules >= 71, res.stdout  # the training, data, CLI, microbenchmark and leaf modules included


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
