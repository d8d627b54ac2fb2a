"""The port's info builder (`unidistill_torch/data/info_builder.py`) against
the JAX package's, on the raw nuScenes JSON tree of `tests/test_info_builder.py`
(one scene, two samples, one intermediate sweep): the pkls that
`python -m unidistill_torch.data.info_builder` writes equal the JAX
builder's field by field (arrays exact), the split resolution agrees, and
the port's `NuScenesDataset` reads the pkls into the JAX dataset's frames.
"""
import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from unidistill_tpu.configs.nuscenes import DataConfig as JaxDataConfig, tiny_model as jax_tiny_model
from unidistill_tpu.data import info_builder as jax_builder
from unidistill_tpu.data.dataset import NuScenesDataset as JaxDataset

from unidistill_torch.configs.nuscenes import DataConfig, tiny_model
from unidistill_torch.data import info_builder
from unidistill_torch.data.dataset import NuScenesDataset

from tests.test_info_builder import build_raw_nusc
from tests.test_torch_data import assert_frames_equal

REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """(raw root, the port's output dir, the JAX builder's output dir)."""
    tmp = tmp_path_factory.mktemp("rawnusc_port")
    raw = build_raw_nusc(tmp / "raw")
    port_out, jax_out = str(tmp / "port"), str(tmp / "jax")
    subprocess.run([sys.executable, "-m", "unidistill_torch.data.info_builder", "--dataroot", raw,
                    "--version", "v1.0-mini", "--out", port_out], check=True, cwd=REPO)
    jax_builder.main(["--dataroot", raw, "--version", "v1.0-mini", "--out", jax_out])
    return raw, port_out, jax_out


def assert_same(a, b, path="info"):
    assert type(a) is type(b), path
    if isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            assert_same(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b, path


@pytest.mark.parametrize("split", ["train", "val"])
def test_pkls_equal_the_jax_builders(built, split):
    _, port_out, jax_out = built
    with open(os.path.join(port_out, f"{split}_info.pkl"), "rb") as f:
        got = pickle.load(f)
    with open(os.path.join(jax_out, f"{split}_info.pkl"), "rb") as f:
        ref = pickle.load(f)
    assert len(got) == (2 if split == "train" else 0)
    assert_same(got, ref)
    if got:
        assert len(got[1]["lidar_sweeps"]) == 1 and got[0]["gt_boxes"].shape == (1, 9)


def test_split_resolution_matches_jax(tmp_path):
    spec = tmp_path / "scenes.json"
    spec.write_text(json.dumps({"train": ["scene-0061"], "val": ["scene-0103", "scene-0916"]}))
    for version, scene_file in (("v1.0-mini", None), ("v1.0-trainval", str(spec)), ("v1.0-mini", str(spec))):
        assert info_builder._resolve_splits(version, scene_file) == jax_builder._resolve_splits(version, scene_file)
    raw = build_raw_nusc(tmp_path / "raw")
    assert_same(info_builder.build_split_infos(info_builder.Tables(raw, "v1.0-mini"), ["scene-0061"], 1),
                jax_builder.build_split_infos(jax_builder.Tables(raw, "v1.0-mini"), ["scene-0061"], 1))


def test_the_dataset_reads_the_pkls(built, tmp_path):
    """The pkls beside a copy of the raw tree, as the builder documents:
    the port's frames (LiDAR) equal the JAX dataset's on the JAX builder's
    pkls."""
    raw, port_out, jax_out = built
    roots = {}
    for name, out in (("port", port_out), ("jax", jax_out)):
        root = tmp_path / name
        shutil.copytree(raw, root)
        shutil.copy(os.path.join(out, "train_info.pkl"), root / "train_info.pkl")
        roots[name] = str(root)
    pd = NuScenesDataset(DataConfig(root_path=roots["port"], num_lidar_sweeps=10, use_cbgs=False),
                         tiny_model(with_camera=False), "training", seed=0)
    jd = JaxDataset(JaxDataConfig(root_path=roots["jax"], num_lidar_sweeps=10, use_cbgs=False),
                    jax_tiny_model(with_camera=False), "training", seed=0)
    assert len(pd) == len(jd) == 2
    for i in range(2):
        f = pd[i]
        assert_frames_equal(f, jd[i], native=True)
        valid = np.abs(f["gt_boxes"]).sum(-1) > 0
        assert valid.sum() == 1 and f["gt_boxes"][valid][0, 9] == 1.0  # the planted car
