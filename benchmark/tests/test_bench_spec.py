"""BENCHMARK.json against the contract it is written to, and the harness
finding every piece by name."""
from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

from benchmark.harness import spec as sp

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return sp.benchmark_spec()


def test_keys_and_names(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert bench["paths"] == ["benchmark"] and 1 <= bench["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in bench[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") and m["source"] in SOURCES
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    assert len(json.dumps(bench)) < 64 * 1024


def test_every_cell_finds_its_files(bench):
    for w in bench["workloads"]:
        assert w["chips"] == 1
        cfg = sp.config_file(bench, w["config"])
        assert sp.config_entry(bench, w["config"])["file"].startswith("benchmark/")
        assert cfg["reduced"] == sp.config_entry(bench, w["config"])["reduced"] == []
        traffic = sp.traffic_file(w["traffic"])
        assert hasattr(sp.driver(traffic["entry"]), "setup")
        cm = sp.cell_metrics(bench, w["name"])
        e2e = [m["name"] for m in cm["end_to_end"]]
        assert "setup_s" in e2e and len(e2e) >= 2 and cm["per_layer"], w["name"]
        for m in cm["per_layer"]:
            assert m["moves"] in e2e, (w["name"], m["name"])
            assert hasattr(sp.metric_reader(m["name"]), "read")


def test_configurations_are_the_ports_experiments(bench):
    """The files hold the port's `camera_exp()` and `distill_exp("lidar",
    "camera")` with the LiDAR teacher of `lidar_exp()`, every width."""
    import dataclasses

    from unidistill_torch.configs import nuscenes

    from benchmark.harness.setup import configs

    cam = configs(sp.config_file(bench, "camera"), nuscenes)
    assert cam.model == nuscenes.camera_exp().model and cam.train == nuscenes.camera_exp().train
    dx = configs(sp.config_file(bench, "distill-lidar-camera"), nuscenes)
    exp = nuscenes.distill_exp("lidar", "camera")
    assert dx.student == exp.model and dx.train == exp.train and dx.distill == exp.distill
    assert dx.teacher == nuscenes.lidar_exp().model
    assert dataclasses.asdict(dx.student)["camera_encoder"]["final_dim"] == (256, 704)


def test_new_pieces_are_found_by_name(tmp_path: Path, bench):
    """A configuration, a traffic mix, an entry driver and a per-layer
    metric added as files plus entries, with no file of the harness edited."""
    root = tmp_path / "checkout"
    shutil.copytree(sp.BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    b = root / "benchmark"
    (b / "metrics" / "new_share.train.py").write_text("def read(record):\n    return 42.0\n")
    (b / "drivers" / "newentry.py").write_text("def setup(ctx):\n    return 'new'\n")
    (b / "traffic" / "new-mix.json").write_text(json.dumps({"entry": "newentry", "limits": {}}))
    (b / "configs" / "newcfg.json").write_text(json.dumps({"reduced": []}))
    spec = dict(bench)
    spec["configs"] = bench["configs"] + [{"name": "newcfg", "source": "x", "file": "benchmark/configs/newcfg.json",
                                           "reduced": [], "why": "x"}]
    spec["workloads"] = bench["workloads"] + [{"name": "new-cell", "config": "newcfg", "traffic": "new-mix",
                                               "chips": 1, "why": "x"}]
    spec["per_layer"] = bench["per_layer"] + [{"name": "new_share.train", "unit": "%", "better": "higher",
                                               "source": "device_trace", "layer": "device",
                                               "moves": "train_frames_per_s", "workloads": ["new-cell"]}]
    spec["end_to_end"] = [dict(m, workloads=m["workloads"] + ["new-cell"]) if m["name"] == "train_frames_per_s"
                          else m for m in bench["end_to_end"]]
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    loaded = sp.benchmark_spec(root)
    cell = sp.cell(loaded, "new-cell")
    assert sp.config_file(loaded, cell["config"], root) == {"reduced": []}
    traffic = sp.traffic_file(cell["traffic"], b)
    assert sp.driver(traffic["entry"], b).setup(None) == "new"
    cm = sp.cell_metrics(loaded, "new-cell")
    assert [m["name"] for m in cm["per_layer"]] == ["new_share.train"]
    assert sp.metric_reader("new_share.train", b).read({}) == 42.0
    # the committed cells report what they reported before
    names = lambda spec, w: {k: [m["name"] for m in v] for k, v in sp.cell_metrics(spec, w).items()}
    for w in bench["workloads"]:
        assert names(loaded, w["name"]) == names(bench, w["name"])


def test_reported_without_workloads_key():
    metrics = [{"name": "a", "moves": "x"}, {"name": "b", "moves": "y"}, {"name": "c", "moves": "x",
                                                                        "workloads": ["other"]}]
    assert [m["name"] for m in sp.reported(metrics, "cell", ["x"])] == ["a"]
