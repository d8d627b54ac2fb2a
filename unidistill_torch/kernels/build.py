"""Build the hand-written CUDA kernels and bind them with ctypes.

Each `csrc/<name>.cu` has a plain C interface and compiles on its own with
`nvcc -gencode arch=compute_90a,code=sm_90a` into
`build/unidistill_torch/lib<name>-<hash>.so` at the repository root, at first
use. The hash is taken over the source, so an edited kernel is rebuilt and a
stale library is never loaded. `build_all()` starts one `nvcc` per source
at once and waits for all of them.

Every C entry point returns the `cudaError_t` of its launch; `check()` raises
if it is not 0. A build failure raises: there is no fallback.

`LAUNCHES` counts the launches of each kernel: a wrapper adds one where it
launches its kernel and nowhere else.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "unidistill_torch"
SOURCES = ("bev_pool", "nms", "sparse_conv", "fused_offsets", "band_gather")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# the IoU follows the JAX float math term for term: no contracted multiply-adds
EXTRA_FLAGS = {"nms": ("-fmad=false",)}

LAUNCHES: collections.Counter = collections.Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# C signatures: name -> (argtypes); every function returns int (cudaError_t)
_P, _I, _L, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
SIGNATURES = {
    "bev_pool": {
        # order, offsets, depth, ctx, out, n_rows, D, HW, C, stream
        "bev_pool_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        # cell, depth, ctx, g, g_depth, g_ctx, B, NC, D, fH, fW, C, ncells, vec, stream
        "bev_pool_bwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        # columns, rays_per_pass (int*)
        "bev_pool_bwd_schedule": (_P, _P),
    },
    "nms": {
        # boxes_a, boxes_b, out, L, M, N, stream
        "rotated_iou_f32": (_P, _P, _P, _I, _I, _I, _P),
        # boxes, valid, mask, L, C, thr, stream
        "rotated_iou_mask": (_P, _P, _P, _I, _I, _F, _P),
        # mask, valid, keep_idx, keep_mask, L, C, post_max, stream
        "nms_greedy_select": (_P, _P, _P, _P, _I, _I, _I, _P),
    },
    "sparse_conv": {
        # feats, nbr, w, bias (or None), out, n_in, n_out, K, cin, cout, dtype, w_layout, stream
        "sparse_conv_fwd": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P),
        # feats, g, nbr, partial, dw, n_in, n_out, K, cin, cout, chunks, rows_per_chunk, dtype, stream
        "sparse_conv_wgrad": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P),
        # cin, cout, &blocks (K6's bfloat16 instance)
        "sparse_conv_wgrad_blocks_per_sm": (_I, _I, _P),
    },
    "fused_offsets": {
        # g, case_oh, w8, w8 tiles (scratch), out, B, S, C, co4, stream
        "fused_offsets": (_P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
        # x, y, out, n, stream
        "axpy2_bf16": (_P, _P, _P, _L, _P),
    },
    "band_gather": {
        # tab, idx, w, out, n_tab, S, row_bytes, R, band, variant, stream
        "band_gather_copy": (_P, _P, _P, _P, _I, _L, _I, _I, _I, _I, _P),
        # tab, idx, w, out, n_tab, S, W, R, band, stream
        "band_gather_onehot": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    },
}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(home) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    flags = " ".join(NVCC_FLAGS + EXTRA_FLAGS.get(name, ())).encode()
    digest = hashlib.sha1(src + flags).hexdigest()[:12]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, str]:
    """Compile every missing library in parallel; returns name -> ptxas log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _lib_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, *EXTRA_FLAGS.get(name, ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ), tmp, out)
    logs = {}
    errors = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{log}")
        else:
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return logs


def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library `name`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            path = _lib_path(name)
            if not path.exists():
                build_all([name])
            lib = ctypes.CDLL(str(path))
            for fn, argtypes in SIGNATURES[name].items():
                f = getattr(lib, fn)
                f.argtypes = list(argtypes)
                f.restype = ctypes.c_int
            _LIBS[name] = lib
        return lib


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed with cudaError {err}")


def reset_launches() -> None:
    LAUNCHES.clear()
