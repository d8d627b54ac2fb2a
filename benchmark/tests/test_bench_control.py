"""The control: the plain reference computed in fp8 (e4m3, a scale a
tensor), the precision below the configurations' bfloat16, put in the
program's place, has to come out as not correct under the committed limits.

On the CPU at tiny sizes; on the card (`-m cuda`) at each cell's own size
on three seeds, where the program on the same seeds has to pass:

    python3 -m pytest -p no:cacheprovider benchmark/tests/test_bench_control.py -m cuda -s
"""
from __future__ import annotations

import json
import tempfile
from pathlib import Path

import pytest
import torch

from benchmark.harness import spec as sp
from benchmark.tests import readings, tiny

CELLS = [w["name"] for w in sp.benchmark_spec()["workloads"]]
CARD_SEEDS = (3_000_000_019, 3_000_000_037, 3_000_000_061)


def _fails(values: dict, limits: dict) -> list:
    return [k for k, v in values.items() if not v <= limits[k]]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_tiny_size(cell):
    torch.set_num_threads(2)
    bench = sp.benchmark_spec()
    with tempfile.TemporaryDirectory() as tmp:
        files = tiny.tiny_files("float32")
        for c in bench["configs"]:
            path = Path(tmp) / f"{c['name']}.json"
            path.write_text(json.dumps(files[c["name"]]))
            c["file"] = str(path)
        traffic = tiny.small_traffic(sp.cell(bench, cell)["traffic"])
        out = readings.session_readings(cell, 2**31 + 99, 0.3, torch.device("cpu"), True, bench=bench,
                                        traffic=traffic)
    limits = traffic["limits"]
    assert not _fails(out["program"], limits), out
    assert _fails(out["control"], limits), out


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_cell_size(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run at full width on the card")
    from unidistill_torch.kernels import build

    build.build_all()
    limits = sp.traffic_file(sp.cell(sp.benchmark_spec(), cell)["traffic"])["limits"]
    for seed in CARD_SEEDS:
        out = readings.session_readings(cell, seed, 2.0, torch.device("cuda", 0), True)
        print(json.dumps(out))
        assert not _fails(out["program"], limits), out
        assert _fails(out["control"], limits), out
