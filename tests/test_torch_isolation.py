"""The port stands alone: it imports neither JAX nor the JAX package, and its
own copy of the configuration equals the JAX one field for field."""
import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import pytest

from unidistill_tpu.configs import nuscenes as jcfg

from unidistill_torch.configs import nuscenes as pcfg

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "unidistill_tpu")


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
    assert n_modules >= 14, res.stdout


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
], ids=["camera_exp", "camera_model", "tiny_camera", "tiny", "default_model"])
def test_config_copy_matches_jax(make):
    ours, ref = make(pcfg), make(jcfg)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    m_ours = getattr(ours, "model", ours)
    m_ref = getattr(ref, "model", ref)
    assert m_ours.feature_map_size == m_ref.feature_map_size
    for prop in ("depth_channels", "feat_hw", "bev_hw"):
        assert getattr(m_ours.camera_encoder, prop) == getattr(m_ref.camera_encoder, prop)


def test_constants_match_jax():
    for name in ("POINT_CLOUD_RANGE", "VOXEL_SIZE", "GRID_SIZE", "IMG_DIM",
                 "OUT_SIZE_FACTOR", "CLASS_NAMES", "TASKS"):
        assert getattr(pcfg, name) == getattr(jcfg, name), name
