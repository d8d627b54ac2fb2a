"""What the benchmark imports: never JAX nor the JAX package (anywhere under
`benchmark/`), and never the port from the reference. A module's top-level
name, the part before the first dot, is compared whole: the port's name
begins with the JAX package's."""
from __future__ import annotations

import ast
import sys
from pathlib import Path

from benchmark.harness import result
from benchmark.harness.spec import BENCH

JAX = {"jax", "jaxlib", "flax", "unidistill_tpu"}


def top_level_imports(path: Path):
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_nothing_imports_jax():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 30
    for f in files:
        assert not top_level_imports(f) & JAX, f


def test_reference_imports_nothing_of_the_port():
    for f in sorted((BENCH / "reference").rglob("*.py")):
        assert "unidistill_torch" not in top_level_imports(f), f
        assert "benchmark" not in top_level_imports(f), f  # relative imports only: it stands alone


def test_run_imports_the_port():
    assert "unidistill_torch" in top_level_imports(BENCH / "run.py")


def test_forbidden_modules_compares_whole_names(monkeypatch):
    for name in ("jaxtyping", "unidistill_tpu_extra", "unidistill_torch.ops"):
        monkeypatch.setitem(sys.modules, name, object())
    assert result.forbidden_modules() == [m for m in result.forbidden_modules() if m.split(".")[0] in JAX]
    assert not [m for m in result.forbidden_modules() if m.startswith(("jaxtyping", "unidistill_t"))]
    monkeypatch.setitem(sys.modules, "unidistill_tpu.ops", object())
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    assert {"unidistill_tpu.ops", "jaxlib"} <= set(result.forbidden_modules())
