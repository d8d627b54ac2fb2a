"""One kernel library holding several edited copies of a marked region of a
kernel source, so that the variants run in one process, in turns
(`tools/k8_variants.py`, `tools/k10_variants.py`).

A region is the text of `unidistill_torch/csrc/<source>.cu` from the line
`// ---- <label> region` to the line `// ---- end of the <label> region`,
inside the source's anonymous namespace. The library is the whole source
as it is, then, for each variant, the region with that variant's text
edits (each must apply) in `namespace v_<variant>` nested in the anonymous
namespace, so that the region's names resolve to the file's helpers; then
one extern "C" entry a variant, from ENTRY.format(v=variant). It compiles
with the flags of `kernels/build.py` into build/<stem>/, and `sass_counts`
counts each kernel's instructions in a built library (cuobjdump -sass;
this module imports no package, so `tools/op_times.py` uses it on any
tree's library).
"""
import collections
import ctypes
import os
import re
import shutil
import subprocess
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _build():
    """This checkout's `kernels/build.py` (the variant tools put ROOT first
    on sys.path)."""
    from unidistill_torch.kernels import build
    return build


def region(text, label):
    """(start, end) of the region's text, its marker lines included."""
    begin, end = f"// ---- {label} region", f"// ---- end of the {label} region"
    i, j = text.find(begin), text.find(end)
    if i < 0 or j < i:
        raise RuntimeError(f"no {label} region in the source")
    return i, j + len(end)


def variants_source(source, label, variants, entry):
    """The library's text; variants: name -> [(old, new), ...]."""
    text = (_build().CSRC / f"{source}.cu").read_text()
    i, j = region(text, label)
    body = text[i:j] + "\n"
    parts = [text, "namespace {"]
    for name, edits in variants.items():
        b = body
        for old, new in edits:
            if old not in b:
                raise RuntimeError(f"{name}: edit does not apply: {old[:60]!r}")
            b = b.replace(old, new)
        parts.append(f"namespace v_{name} {{\n{b}}}  // namespace v_{name}")
    parts += ["}  // namespace", 'extern "C" {']
    parts += [entry.format(v=name) for name in variants]
    parts.append('}  // extern "C"\n')
    return "\n".join(parts)


def build_library(text, stem, argtypes, names, prefix):
    """Compiles `text` into build/<stem>/<stem>.so, loads it and sets each
    entry `<prefix><name>`'s argtypes."""
    build = _build()
    out_dir = ROOT / "build" / stem
    out_dir.mkdir(parents=True, exist_ok=True)
    cu, so = out_dir / f"{stem}.cu", out_dir / f"{stem}.so"
    cu.write_text(text)
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed for {cu}:\n{(proc.stdout + proc.stderr)[-3000:]}")
    lib = ctypes.CDLL(str(so))
    for name in names:
        f = getattr(lib, prefix + name)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
    return lib


def sass_counts(so_path, pattern):
    """{kernel (mangled): Counter of opcodes, "total" among them} for each
    kernel in the library whose mangled name matches `pattern`."""
    home = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda"))
    cuobjdump = home / "bin" / "cuobjdump"
    if not cuobjdump.exists():
        cuobjdump = shutil.which("cuobjdump") or cuobjdump
    text = subprocess.run([str(cuobjdump), "-sass", str(so_path)], capture_output=True, text=True,
                          check=True).stdout
    counts, current = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            current = m.group(1) if re.search(pattern, m.group(1)) else None
            if current:
                counts[current] = collections.Counter()
            continue
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", line)
        if current and m:
            op = m.group(1).split(".")[0]
            counts[current][op] += 1
            counts[current]["total"] += 1
    return counts
