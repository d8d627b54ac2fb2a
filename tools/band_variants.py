"""K11 (the one-hot band gather) with a mechanism taken out, built side by
side and timed on the card on the layouts of `tools/op_times.py
band_cells`:

    python tools/band_variants.py BAND_CELLS.pt [VARIANT ...]

VARIANT names run in the order given, repeats allowed (for example
`shipped plan_launch plan_launch shipped`); with none, every variant once.
Every variant is a text edit of this tree's
`unidistill_torch/csrc/band_gather.cu` (each must apply), compiled with
the flags of `kernels/build.py` into build/band_variants/:
  shipped      the kernel as it is;
  plan_launch  no sort in the kernel: a plan in plain PyTorch (clip, key,
               a stable `torch.sort`, ~10 launches) orders the rows, and
               each block reads its chunk's rows and band positions;
  b_from_l2    no cp.async staging of the slabs: each B fragment is read
               from global memory (L2) as bf16 pairs of two band rows;
  whole_slabs  every row of a staged slab read, not only the band rows
               that the warp's rows sit on;
and one that skips K11's work, to show where its time goes: sort_only (the
sort, no products; its output is wrong, and `bit_equal` false shows that
the check catches a kernel that leaves rows unwritten).
Each variant runs on every layout in a process of its own (one kernel
library a process), its output in a block just filled with NaN
(`harness.poisoned_call`), and each but sort_only must equal the plain
gather bit for bit. Prints ptxas's registers, spills and shared memory,
then one JSON line per (variant, layout): `bit_equal`, `ms`, the device
time of every kernel a call launches (the plan's too) from torch.profiler
(`harness.kernel_ms`, null if the profiler never saw one), `k11_ms` the
product kernel's alone, and `events_ms`, the mean of 50 back-to-back calls
by CUDA events (host work included).
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from unidistill_torch.experiments.harness import kernel_ms, poisoned_call, timed_ms  # noqa: E402
from unidistill_torch.kernels import build  # noqa: E402
from unidistill_torch.ops import band_gather as bg  # noqa: E402

SORT_START = "  // ---- order the block's rows by slab"
SORT_END = "    if (before >= c0 + n_mine) break;\n  }\n"
PLANNED = """  // the planned order: idx holds [rows within the block | band positions], S each
  for (int q = tid; q < n_mine; q += kOThreads) {
    srow[q] = __ldg(idx + r0 + c0 + q);
    sloc[q] = __ldg(idx + S + r0 + c0 + q);
  }
  __syncthreads();
"""
STAGE_COPIES = """#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = lane + 32 * i, r = p >> 4, c = (p & 15) * 8;
      const int trow = min(max(lo + 16 * s + r, 0), n_tab - 1);  // memory safety when w breaks its contract
      const bool ok = (used >> r & 1u) && n0 + c < W;
      cp_async16(smem_addr(wt + buf * kOTile + r * kOSS + c), tab + (long long)trow * W + n0 + (ok ? c : 0), ok);
    }
"""
B_FROM_SHARED = "        ldmatrix_x4_trans(b, tile + (k * kOSS + np * 16 + (lane >> 4) * 8) * 2);\n"
B_FROM_L2 = """        {
          const unsigned short* t16 = reinterpret_cast<const unsigned short*>(tab);
          const int cn = n0 + np * 16 + gid;
          const long long at = (long long)(lo + 16 * s + 2 * tig) * W + cn;
          auto pair = [&](long long o) { return (uint32_t)__ldg(t16 + o) | ((uint32_t)__ldg(t16 + o + W) << 16); };
          b[0] = pair(at);
          b[1] = pair(at + 8LL * W);
          b[2] = cn + 8 < W ? pair(at + 8) : 0u;
          b[3] = cn + 8 < W ? pair(at + 8LL * W + 8) : 0u;
        }
"""
VARIANTS = {
    "shipped": [],
    "plan_launch": [("sort", None)],
    "b_from_l2": [(STAGE_COPIES, ""), (B_FROM_SHARED, B_FROM_L2)],
    "whole_slabs": [("      const bool ok = (used >> r & 1u) && n0 + c < W;", "      const bool ok = n0 + c < W;")],
    "sort_only": [("  if (q0 >= n_mine) return;", "  if (q0 >= 0) return;")],
}
DIAGNOSTIC = ("sort_only",)
OUT_DIR = ROOT / "build" / "band_variants"


def variant_source(name):
    text = (build.CSRC / "band_gather.cu").read_text()
    for a, b in VARIANTS[name]:
        if a == "sort":
            i, j = text.find(SORT_START), text.find(SORT_END)
            if i < 0 or j < i:
                raise RuntimeError(f"{name}: the sort's markers are not in band_gather.cu")
            text = text[:i] + PLANNED + text[j + len(SORT_END):]
            continue
        if a not in text:
            raise RuntimeError(f"{name}: edit does not apply: {a[:60]!r}")
        text = text.replace(a, b)
    return text


def build_variants(names):
    """Compiles the variants in parallel; prints ptxas's report of K11."""
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(variant_source(name))
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(cu.with_suffix(".so")), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-2000:]}")
        lines = log.splitlines()
        at = next(i for i, line in enumerate(lines) if "Compiling" in line and "onehot" in line)
        report = [line.split(":", 1)[-1].strip() for line in lines[at + 1:at + 4]
                  if "registers" in line or "spill" in line or "smem" in line]
        print(f"{name}: band_gather_onehot_kernel " + " | ".join(report), flush=True)


def plan(idx, w, R, band):
    """[rows within their block in slab order | their band positions], S each."""
    S = idx.shape[0]
    lo = w.repeat_interleave(R)[:S]
    loc = torch.minimum(torch.maximum(idx, lo), lo + band - 1) - lo
    pos = torch.arange(S, device=idx.device)
    order = torch.sort(pos // R * (band // bg.ONEHOT_SLAB) + loc // bg.ONEHOT_SLAB, stable=True).indices
    return torch.cat([order % R, loc[order]]).to(torch.int32)


def time_variant(name, cells_file):
    """Each variant in a process of its own: one kernel library a process."""
    lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
    for fn, argtypes in build.SIGNATURES["band_gather"].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    build._LIBS["band_gather"] = lib

    def planned(tab, idx, w, R, band):
        p = plan(idx, w, R, band)
        out = tab.new_empty(idx.shape[0], tab.shape[1])
        build.check(lib.band_gather_onehot(tab.data_ptr(), p.data_ptr(), w.data_ptr(), out.data_ptr(),
                                           tab.shape[0], idx.shape[0], tab.shape[1], R, band,
                                           torch.cuda.current_stream().cuda_stream), name)
        return out

    call = planned if name == "plan_launch" else bg.band_gather_onehot
    for layout, (tab, idx, w, R, band) in torch.load(cells_file).items():
        tab, idx, w = tab.cuda(), idx.cuda(), w.cuda()
        fn = lambda: call(tab, idx, w, R, band)
        got = poisoned_call(fn, idx.shape[0] * tab.shape[1] * 2)
        equal = torch.equal(got.view(torch.int16), bg.band_gather_plain(tab, idx, w, R, band).view(torch.int16))
        if name not in DIAGNOSTIC and not equal:
            raise RuntimeError(f"{name} on {layout}: differs from the plain gather")
        ms, k11_ms = kernel_ms(fn, None), kernel_ms(fn, "band_gather_onehot_kernel")
        print(json.dumps(dict(variant=name, layout=layout, bit_equal=equal, ms=None if ms is None else round(ms, 5),
                              k11_ms=None if k11_ms is None else round(k11_ms, 5),
                              events_ms=round(timed_ms(fn, tab.device, iters=50, reps=1), 5))), flush=True)
        del tab, idx, w, got
        torch.cuda.empty_cache()


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("band_variants: needs a CUDA device")
    if len(sys.argv) == 4 and sys.argv[2] == "--time":
        time_variant(sys.argv[3], sys.argv[1])
        sys.exit(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    order = sys.argv[2:] or list(VARIANTS)
    unknown = set(order) - set(VARIANTS)
    if unknown:
        sys.exit(f"band_variants: no variant {sorted(unknown)}")
    build_variants(sorted(set(order)))
    failed = [name for name in order
              if subprocess.run([sys.executable, __file__, sys.argv[1], "--time", name]).returncode]
    if failed:
        sys.exit(f"band_variants: {failed} failed")
