"""The microbenchmark tools' host-side logic on the CPU: reading kernel
launches from a profiler trace (`experiments/harness.launch_geometry`), a
call's device time from per-kernel profiler records
(`harness._per_call`), and
the variant tools' edits of K7's, K8's and K10's source regions
(`tools/k7_variants.py`, `tools/k8_variants.py`, `tools/k10_variants.py`),
which must apply to the shipped kernels so that a variant library builds
on the card."""
import importlib.util
import sys
from pathlib import Path

import pytest

from unidistill_torch.experiments.harness import _per_call, launch_geometry

ROOT = Path(__file__).resolve().parents[1]


def _kernel(name, grid, block, regs, smem):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": 0, "dur": 1,
            "args": {"grid": grid, "block": block, "registers per thread": regs, "shared memory": smem,
                     "stream": 7}}


def test_launch_geometry_reads_the_distinct_launches_of_a_trace():
    events = [
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "args": {}},
        _kernel("void (anonymous namespace)::axpy2_kernel(uint4 const*, uint4 const*, uint4*, unsigned int, "
                "unsigned int)", [64, 1, 1], [128, 1, 1], 16, 0),
        _kernel("void at::native::vectorized_elementwise_kernel<8, ...>", [32, 2, 1], [128, 1, 1], 24, 512),
        {"ph": "f", "cat": "ac2g", "name": "launch"},
        _kernel("void (anonymous namespace)::axpy2_kernel(uint4 const*, uint4 const*, uint4*, unsigned int, "
                "unsigned int)", [64, 1, 1], [128, 1, 1], 16, 0),
        _kernel("void (anonymous namespace)::axpy2_kernel(uint4 const*, uint4 const*, uint4*, unsigned int, "
                "unsigned int)", [3, 1, 1], [128, 1, 1], 16, 0),
    ]
    every = launch_geometry(events, None)
    assert [g["threads"] for g in every] == [64 * 128, 64 * 128, 3 * 128]
    assert [g["launches"] for g in every] == [2, 1, 1]
    k8, k8_small = launch_geometry(events, "axpy2_kernel")
    assert k8["grid"] == [64, 1, 1] and k8["block"] == [128, 1, 1] and k8_small["grid"] == [3, 1, 1]
    assert k8["registers"] == 16 and k8["shared_bytes"] == 0
    (lib,) = launch_geometry(events, "vectorized")
    assert lib["grid"] == [32, 2, 1] and lib["shared_bytes"] == 512
    assert launch_geometry(events, "band_gather") == []


def test_per_call_time_takes_each_kernel_over_its_own_records():
    """A call of two kernels, one of which lost records: each kernel's mean
    over the records it kept, summed, and the records counted against a
    complete profile's."""
    ms, kept, full = _per_call({"k7": (45 * 400.0, 45), "w8_tiles": (50 * 2.0, 50)}, 50)
    assert ms == pytest.approx(0.402) and (kept, full) == (95, 100)
    ms, kept, full = _per_call({"k11": (50 * 80.0, 50)}, 50)
    assert ms == pytest.approx(0.080) and kept == full == 50
    ms, _, full = _per_call({"gemm": (100 * 3.0, 100)}, 50)  # two launches a call
    assert ms == pytest.approx(0.006) and full == 100


def _tool(name):
    spec = importlib.util.spec_from_file_location(f"_tool_{name}", ROOT / "tools" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        spec.loader.exec_module(module)
    finally:
        sys.path.remove(str(ROOT / "tools"))
    return module


@pytest.mark.parametrize("tool", ["k7_variants", "k8_variants", "k10_variants"])
def test_variant_edits_apply_to_the_shipped_region(tool):
    """Every variant's edits apply to the shipped region
    (`variants_source` raises otherwise), each variant gets its own
    namespace and extern "C" entry, and every variant but `shipped`
    changes the region's text."""
    mod = _tool(tool)
    vb = mod.vb
    if tool == "k7_variants":
        source, label, table = "fused_offsets", "K7", mod.VARIANTS
        entry = "k7_"
    elif tool == "k8_variants":
        source, label, table = "fused_offsets", "K8", mod.variants(256, 2)
        entry = "axpy2_"
    else:
        source, label, table = "band_gather", "K10", mod.VARIANTS
        entry = "take_"
    text = vb.variants_source(source, label, table, mod.ENTRY)
    shipped_text = (ROOT / "unidistill_torch" / "csrc" / f"{source}.cu").read_text()
    assert text.startswith(shipped_text)
    i, j = vb.region(shipped_text, label)
    region = shipped_text[i:j]
    for name, edits in table.items():
        assert f"namespace v_{name} {{" in text and f"int {entry}{name}(" in text
        body = text[text.index(f"namespace v_{name} {{"):text.index(f"}}  // namespace v_{name}")]
        assert (region in body) == (not edits), name
