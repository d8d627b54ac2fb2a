"""Whole runs of the harness on the CPU at tiny sizes: the last line, and
`correct` coming out false when the timed path is broken underneath."""
from __future__ import annotations

import subprocess
import sys

import pytest

from benchmark.harness import spec as sp
from benchmark.tests import faults, tiny

CELLS = [w["name"] for w in sp.benchmark_spec()["workloads"]]
REQUIRED = {"correct", "attempted", "failed", "metrics", "device"}


@pytest.mark.parametrize("cell", CELLS)
def test_last_line(cell, tmp_path):
    rc, out, err = tiny.run_cell(cell, tmp_path)
    assert rc == 0, err
    line = tiny.last_line(out)
    assert set(line) == REQUIRED | {"checked"} and list(line)[-1] == "checked"
    assert line["correct"] is True, line["checked"]
    assert line["attempted"] >= 1 and line["failed"] == 0
    e2e = [m["name"] for m in sp.cell_metrics(sp.benchmark_spec(), cell)["end_to_end"]]
    assert sorted(line["metrics"]) == sorted(e2e)
    assert set(line["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    # each number compared, beside its limit, as the last lines on stderr
    tail = err.strip().splitlines()[-len(line["checked"]):]
    assert [t.split()[1] for t in tail] == list(line["checked"])


# the faults each cell can have (one chip: no exchange between chips), and a
# learning rate off by half again in the training cells
FAULTS = {"camera-serve": ("half", "altered"), "camera-train": ("half", "frozen", "lr"),
          "distill-l2c-train": ("half", "frozen", "lr")}


@pytest.mark.parametrize("cell,fault", [(c, f) for c, fs in FAULTS.items() for f in fs])
def test_broken_timed_path_is_not_correct(cell, fault, tmp_path):
    with faults.plant(fault):
        rc, out, err = tiny.run_cell(cell, tmp_path)
    assert rc == 0, err
    line = tiny.last_line(out)
    assert line["correct"] is False, line["checked"]


def test_no_card_no_result():
    """Without a CUDA device the run exits non-zero and prints nothing on
    stdout (this sandbox has none)."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    p = subprocess.run([sys.executable, str(sp.BENCH / "run.py"), "--workload", CELLS[0], "--seed", "3000000000",
                        "--seconds", "1", "--trace", "0"], capture_output=True, text=True, cwd=sp.ROOT, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


def test_jax_in_the_process_means_no_result(tmp_path, monkeypatch):
    from benchmark.harness import result

    monkeypatch.setattr(result, "forbidden_modules", lambda: ["jax"])
    rc, out, err = tiny.run_cell("camera-train", tmp_path)
    assert rc != 0 and out == "" and "jax" in err
