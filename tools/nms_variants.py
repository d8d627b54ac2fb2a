"""K2's mask mode (the NMS IoU mask) and K3 (the greedy walk) with each
mechanism taken out in turn, built side by side and timed on the card on
the lanes of `tools/op_times.py nms_cells`:

    python tools/nms_variants.py NMS_CELLS.pt [VARIANT ...]

VARIANT names run in the order given, repeats allowed (for example
`shipped k3_global k3_global shipped`); with none, every variant once.
Every variant is a text edit of this tree's `unidistill_torch/csrc/nms.cu`
(each must apply), compiled with the flags of `kernels/build.py` into
build/nms_variants/:
  shipped     the kernels as they are;
  circle_first  K2 with a bounding-circle test before the separating axes,
              which returns early where the circles lie apart;
  no_filter   K2 with no pair filter: every candidate pair (j > i,
              valid[j]) is clipped, still densely from the shared list;
  in_place    K2 with the filter, but each thread clips the pairs that pass
              where it tests them, so a warp waits on its few survivors (no
              list);
  occupancy3  K2 with at most 128 registers a thread, not 64: ptxas takes
              69, and 3 blocks (24 warps) fit an SM, not 4;
  k3_global   K3 reading its mask rows from global memory, without the
              cp.async staging of the next 64 rows;
and two that skip K2's work, to show where its time goes (their masks are
not checked): terms_only (the box terms and zero words only) and scan_only
(no clip).
Each other variant's K2 is held against the plain mask (`iou_over_plain`)
outside `K2_THR_BAND` of the threshold, and every variant's K3 against the
plain greedy over the words its K2 gave, in a process of its own (one
kernel library a process). Prints ptxas's registers and spills, then one
JSON line per (variant, layout): each kernel's device time from
torch.profiler (`harness.kernel_ms`, null if the profiler never saw the
kernel) and the mean of 50 back-to-back launches by CUDA events (for K3
that is the ctypes wrapper's host time).
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from unidistill_torch.experiments.harness import kernel_ms, timed_ms  # noqa: E402
from unidistill_torch.kernels import build  # noqa: E402
from unidistill_torch.ops import nms  # noqa: E402

DDX = "  const float ddx = b0.x - a0.x, ddy = b0.y - a0.y;\n"
VARIANTS = {
    "shipped": [],
    "circle_first": [(DDX, DDX + """  const float rr = sqrtf(a1.x * a1.x + a1.y * a1.y) + sqrtf(b1.x * b1.x + b1.y * b1.y) + m;
  if (ddx * ddx + ddy * ddy > rr * rr) return false;
""")],
    "no_filter": [("const bool filter = thr >= 0.f;", "const bool filter = false;")],
    "in_place": [("""      if (pass) pairs[warp * kSegment + n_seg + __popc(ballot & ((1u << lane) - 1u))] = (unsigned short)(r * kTile + c);
      n_seg += __popc(ballot);""", """      if (pass && pair_iou(rows[r], cols[c]) > thr) atomicOr(&words[r], 1ull << c);""")],
    "occupancy3": [("__launch_bounds__(kMaskThreads, 4)", "__launch_bounds__(kMaskThreads, 2)")],
    "terms_only": [("  if (ok_cols != 0ull) {", "  if (false) {")],
    "scan_only": [("  for (int e = tid; e < n; e += kMaskThreads) {", "  for (int e = tid; e < 0; e += kMaskThreads) {")],
    "k3_global": [("const bool staged = (W + 2 * kTile * W) * 8 <= kStageBytes;", "const bool staged = false;")],
}
DIAGNOSTIC = ("terms_only", "scan_only")
OUT_DIR = ROOT / "build" / "nms_variants"


def build_variants(names):
    """Compiles the variants in parallel; prints ptxas's registers and spills."""
    src = (build.CSRC / "nms.cu").read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for a, b in VARIANTS[name]:
            if a not in text:
                raise RuntimeError(f"{name}: edit does not apply: {a[:60]!r}")
            text = text.replace(a, b)
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [build.nvcc_path(), *build.NVCC_FLAGS, *build.EXTRA_FLAGS["nms"], "-o", str(cu.with_suffix(".so")),
             str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-2000:]}")
        lines = log.splitlines()
        for kernel in ("iou_mask_kernel", "greedy_kernel"):
            at = next(i for i, line in enumerate(lines) if "Compiling" in line and kernel in line)
            report = [line.split(":", 1)[-1].strip() for line in lines[at + 1:at + 4]
                      if "registers" in line or "spill" in line]
            print(f"{name}: {kernel} " + " | ".join(report), flush=True)


def time_variant(name, cells_file):
    """Each variant in a process of its own: one kernel library a process."""
    lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
    for fn, argtypes in build.SIGNATURES["nms"].items():
        getattr(lib, fn).argtypes = list(argtypes)
        getattr(lib, fn).restype = ctypes.c_int
    build._LIBS["nms"] = lib
    for layout, (bev, v, thr, post) in torch.load(cells_file).items():
        bev, v = bev.cuda(), v.cuda()
        words = nms.rotated_iou_mask_cuda(bev, v, thr)
        diff = nms.unpack_mask_bits(words) ^ nms.iou_over_plain(bev, v, thr)
        if name not in DIAGNOSTIC and not ((nms.rotated_iou_bev_plain(bev, bev) - thr).abs()[diff]
                                           < nms.K2_THR_BAND).all():
            raise RuntimeError(f"{name} on {layout}: mask differs off the threshold band")
        keep = nms.nms_greedy_select_cuda(words, v, post)
        ref = nms.greedy_select_plain(nms.unpack_mask_bits(words), v, post)
        if not (torch.equal(keep[0], ref[0]) and torch.equal(keep[1], ref[1])):
            raise RuntimeError(f"{name} on {layout}: K3's keep sets differ from the plain greedy")
        k2 = lambda: nms.rotated_iou_mask_cuda(bev, v, thr)
        k3 = lambda: nms.nms_greedy_select_cuda(words, v, post)
        k2_ms, k3_ms = kernel_ms(k2, "iou_mask_kernel"), kernel_ms(k3, "greedy_kernel")
        print(json.dumps(dict(variant=name, layout=layout,
                              k2_ms=None if k2_ms is None else round(k2_ms, 5),
                              k3_ms=None if k3_ms is None else round(k3_ms, 5),
                              k2_events_ms=round(timed_ms(k2, bev.device, iters=50, reps=1), 5),
                              k3_events_ms=round(timed_ms(k3, bev.device, iters=50, reps=1), 5))), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("nms_variants: needs a CUDA device")
    if len(sys.argv) == 4 and sys.argv[2] == "--time":
        time_variant(sys.argv[3], sys.argv[1])
        sys.exit(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    order = sys.argv[2:] or list(VARIANTS)
    unknown = set(order) - set(VARIANTS)
    if unknown:
        sys.exit(f"nms_variants: no variant {sorted(unknown)}")
    build_variants(sorted(set(order)))
    failed = [name for name in order
              if subprocess.run([sys.executable, __file__, sys.argv[1], "--time", name]).returncode]
    if failed:
        sys.exit(f"nms_variants: {failed} failed")
