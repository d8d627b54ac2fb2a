"""The serving export (`unidistill_torch/serving/export.py`) on the CPU.

The tiny camera, LiDAR and fusion detectors (`tiny_model`, seeded weights,
BatchNorm calibrated on the first batch) are exported in "points" mode, the
LiDAR detector also in "host_voxels" mode. One fresh process loads all four
artifacts through `load_detector`, with nothing of `unidistill_torch.models`,
`layers` or `training` imported, and predicts on two batches of other seeds,
whose LiDAR clouds give other site counts at every stage. Its ROIs must
equal `Detector.predict` on the same batches bit for bit: the program runs
the same aten ops and, on the CPU, the same plain versions of the kernels.

`LoadedDetector.predict` keeps the JAX package's checks (a missing key, a
shape, a dtype, with its messages) and drops keys outside the spec;
`meta.json`'s `batch_spec` equals the JAX `_batch_spec` (no compile) with
its `topo_*` tables taken out.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax

from unidistill_tpu.configs.nuscenes import tiny_model as jax_tiny_model
from unidistill_tpu.serving.export import _batch_spec as jax_batch_spec

from unidistill_torch.configs.nuscenes import tiny_model
from unidistill_torch.layers.lidar_encoder import build_rulebooks, stage_shapes
from unidistill_torch.serving import synthetic
from unidistill_torch.serving.export import export_detector, load_detector
from unidistill_torch.serving.predictor import Detector
from unidistill_torch.training.steps import model_inputs, voxelize_batch

torch.set_num_threads(2)
ROOT = Path(__file__).resolve().parents[1]
B = 2
SEEDS = (1, 2)
# name -> (with_lidar, with_camera, input_mode)
DETECTORS = {
    "camera": (False, True, "points"),
    "lidar": (True, False, "points"),
    "fusion": (True, True, "points"),
    "lidar_host_voxels": (True, False, "host_voxels"),
}
MODEL_MODULES = ("unidistill_torch.models", "unidistill_torch.layers", "unidistill_torch.training")

LOADER = """
import pickle, sys
import torch
torch.set_num_threads(2)
from unidistill_torch.serving.export import load_detector
jobs = pickle.load(open(sys.argv[1], "rb"))
out = {}
for name, (path, batches) in jobs.items():
    det = load_detector(path)
    out[name] = [det.predict(b) for b in batches]
prefixes = %r
modules = sorted(m for m in sys.modules if m.startswith(prefixes) or m.split(".")[0] in ("jax", "unidistill_tpu"))
pickle.dump(dict(out=out, modules=modules), open(sys.argv[2], "wb"))
""" % (MODEL_MODULES,)


def _config(lidar, camera):
    """The tiny detector, keeping every candidate that NMS keeps (score
    threshold 0): random heads score about 0.1, the threshold's value."""
    cfg = tiny_model(with_lidar=lidar, with_camera=camera)
    return dataclasses.replace(cfg, proposal=dataclasses.replace(cfg.proposal, score_threshold=0.0))


def _batch(full, cfg, input_mode):
    """The detector's keys of a camera + LiDAR batch."""
    b = dict(full) if cfg.with_camera else {k: v for k, v in full.items() if k not in ("imgs", "mats")}
    if not cfg.with_lidar:
        b = {k: v for k, v in b.items() if k not in ("points", "points_mask")}
    if input_mode == "host_voxels":
        vox = voxelize_batch(b, cfg, "cpu", training=False)
        b = dict(gt_boxes=b["gt_boxes"], voxel_feats=vox["voxel_feats"].numpy(),
                 voxel_coords=vox["voxel_coords"].numpy())
    return b


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    """name -> (cfg, live Detector, artifact dir, batches, loaded ROIs), and
    the modules the loading process imported."""
    root = tmp_path_factory.mktemp("export")
    full = [synthetic.train_batch(_config(True, True), _config(True, True), B, s) for s in SEEDS]
    cases, jobs = {}, {}
    for name, (lidar, camera, mode) in DETECTORS.items():
        cfg = _config(lidar, camera)
        det = Detector(cfg, synthetic.random_state_dict(cfg, seed=3), device="cpu")
        batches = [_batch(f, cfg, mode) for f in full]
        synthetic.calibrate_batchnorm(det.model, model_inputs(batches[0], cfg, "cpu", training=False))
        path = str(root / name)
        export_detector(cfg, det.model.state_dict(), path, batch_size=B, input_mode=mode, device="cpu")
        cases[name] = (cfg, det, path, batches)
        jobs[name] = (path, batches)
    with open(root / "jobs.pkl", "wb") as f:
        pickle.dump(jobs, f)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run([sys.executable, "-c", LOADER, str(root / "jobs.pkl"), str(root / "out.pkl")],
                          capture_output=True, text=True, timeout=600, cwd=str(root), env=env)
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(root / "out.pkl", "rb") as f:
        res = pickle.load(f)
    return {k: v + (res["out"][k],) for k, v in cases.items()}, res["modules"]


@pytest.mark.parametrize("name", list(DETECTORS))
def test_loaded_artifact_predicts_as_detector(exported, name):
    cfg, det, path, batches, loaded = exported[0][name]
    for batch, got in zip(batches, loaded):
        ref = det.predict(batch)
        assert set(got) == set(ref)
        for k, v in ref.items():
            assert got[k].dtype == v.numpy().dtype and np.array_equal(got[k], v.numpy()), k
        assert ref["mask"].sum() > 0  # a comparison of kept boxes, not of empty buffers


@pytest.mark.parametrize("name", ["lidar", "fusion", "lidar_host_voxels"])
def test_second_batch_has_other_site_counts(exported, name):
    """The artifact traced once served batches whose stages hold other
    numbers of active sites (none specialised at export)."""
    cfg, _, _, batches, _ = exported[0][name]
    counts = []
    for b in batches:
        kw = model_inputs(b, cfg, "cpu", training=False)
        rb = build_rulebooks(kw["voxel_feats"], kw["voxel_coords"], stage_shapes(cfg.lidar_encoder.grid_size))
        counts.append([st.keys.numel() for st in rb.sites])
    assert all(a != b for a, b in zip(*counts)), counts


def test_loading_process_imports_no_model_code(exported):
    assert exported[1] == []


def test_meta(exported):
    cfg, _, path, _, _ = exported[0]["fusion"]
    meta = json.load(open(os.path.join(path, "meta.json")))
    assert meta["with_lidar"] and meta["with_camera"] and meta["batch_size"] == B
    assert meta["input_mode"] == "points" and meta["platforms"] == ["cpu"]
    assert meta["class_names"] == list(cfg.class_names)
    assert meta["torch_version"] == torch.__version__


@pytest.mark.parametrize("name", list(DETECTORS))
def test_batch_spec_matches_jax(exported, name):
    lidar, camera, mode = DETECTORS[name]
    _, _, path, _, _ = exported[0][name]
    spec = jax_batch_spec(jax_tiny_model(with_lidar=lidar, with_camera=camera), B, mode)
    ref = {"/".join(str(getattr(p, "key", p)) for p in keys): dict(shape=list(v.shape), dtype=str(np.dtype(v.dtype)))
           for keys, v in jax.tree_util.tree_flatten_with_path(spec)[0]}
    ref = {k: v for k, v in ref.items() if not k.startswith("topo_")}
    assert json.load(open(os.path.join(path, "meta.json")))["batch_spec"] == ref


def test_predict_checks_the_batch_as_jax(exported):
    _, det, path, batches, loaded = exported[0]["lidar"]
    ld = load_detector(path)
    batch = dict(batches[0], topo_extra=np.zeros(3))  # a key outside the spec is dropped
    got = ld.predict(batch)
    assert all(np.array_equal(got[k], loaded[0][k]) for k in got)
    with pytest.raises(ValueError, match=r"batch is missing keys \['points_mask'\]"):
        ld.predict({k: v for k, v in batches[0].items() if k != "points_mask"})
    bad = dict(batches[0], points=batches[0]["points"][:, :-1])
    with pytest.raises(ValueError, match=r"batch\['points'\] has shape .* expected .* dtype float32"):
        ld.predict(bad)
    bad = dict(batches[0], points_mask=batches[0]["points_mask"].astype(np.float32))
    with pytest.raises(ValueError, match=r"batch\['points_mask'\] has dtype float32, expected bool"):
        ld.predict(bad)


def test_load_refuses_another_torch(exported, tmp_path):
    _, _, path, _, _ = exported[0]["camera"]
    other = tmp_path / "other"
    other.mkdir()
    for f in ("model.pt2", "meta.json"):
        (other / f).write_bytes(Path(path, f).read_bytes())
    meta = json.loads((other / "meta.json").read_text())
    meta["torch_version"] = "0.0.0"
    (other / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(RuntimeError, match="exported with torch 0.0.0"):
        load_detector(str(other))
