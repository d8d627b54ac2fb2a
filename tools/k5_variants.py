"""K5 (the BEV pool's backward) with each of its mechanisms taken out in
turn, built side by side and timed on the card on the camera geometries of
`tools/op_times.py cells`:

    python tools/k5_variants.py CELLS.pt

Every variant is a text edit of this tree's `unidistill_torch/csrc/bev_pool.cu`
(the edits are below; each must apply) or a plain kernel written here,
compiled with the flags of `kernels/build.py` into build/k5_variants/:
  shipped        the kernel as it is;
  one_column     one camera column a block (kCols 1: 256 threads), not two;
  bin_batches    a batch of rows per group of equal depth bins (kBatchRows
                 1: two barriers a group), not per 16 rows;
  bin_reduce     a half-warp shuffle reduction per depth bin, not one
                 transposed reduction per four bins;
  serial_loads   the schedule reads one cell and depth a thread at a time,
                 not eight in flight;
  warp_per_ray   one column a block and a warp per ray (16 warps), not a
                 half-warp: compare with one_column;
  minimal_ring   one column, a warp per ray, a batch per group, a
                 reduction per bin (the shared-memory ring stays);
  plain_column   no schedule and no ring: one block per camera column, one
                 warp per ray, each warp loading its own g rows, so that
                 the column's rays share them through L1 (fH <= 16);
  ray_major      the same plain kernel with a block over 8 consecutive
                 rays in (camera, h, w) order: K5 before its redesign.
Each is held against the plain PyTorch version at rtol/atol 1e-5 of max
|ref|, in a process of its own (one kernel library a process); prints
ptxas's registers and spills, then one JSON line per (variant, geometry)
with the mean of 50 launches by CUDA events.
"""
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
from unidistill_torch.kernels import build  # noqa: E402
from unidistill_torch.ops import bev_pool  # noqa: E402

ONE_COLUMN = [("constexpr int kCols = 2;", "constexpr int kCols = 1;")]
BIN_BATCHES = [("constexpr int kBatchRows = 16;", "constexpr int kBatchRows = 1;")]
BIN_REDUCE = [("""          const bool b3 = lane & 8, b2 = lane & 4;
          float k0 = b3 ? dot[2] : dot[0], k1 = b3 ? dot[3] : dot[1];
          k0 += __shfl_xor_sync(kFull, b3 ? dot[0] : dot[2], 8);
          k1 += __shfl_xor_sync(kFull, b3 ? dot[1] : dot[3], 8);
          float t = b2 ? k1 : k0;
          t += __shfl_xor_sync(kFull, b2 ? k0 : k1, 4);
          t += __shfl_xor_sync(kFull, t, 2);
          t += __shfl_xor_sync(kFull, t, 1);
          const int d = d0 + (l16 >> 2);
          if (mine && (l16 & 3) == 0 && d < d_end) {
            float* out = g_depth + cam_pts + d * HW + hw;
            *out = c0 == 0 ? t : *out + t;
          }
""", """          for (int u = 0; u < 4; ++u) {
            float t = dot[u];
            for (int off = 8; off > 0; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
            const int d = d0 + u;
            if (mine && l16 == 0 && d < d_end) {
              float* out = g_depth + cam_pts + d * HW + hw;
              *out = c0 == 0 ? t : *out + t;
            }
          }
""")]
SERIAL_LOADS = [("i0 += 8 * kThreads", "i0 += kThreads"), ("for (int u = 0; u < 8; ++u)", "for (int u = 0; u < 1; ++u)")]
WARP_LAYOUT = ONE_COLUMN + [
    ("constexpr int kBwdWarps = kSlots / 2;", "constexpr int kBwdWarps = kSlots;"),
    ("constexpr int kHalfPerLane = kChunk / 16;", "constexpr int kHalfPerLane = kChunk / 32;"),
    ("(k >> 2) * 64 + l * 4 + (k & 3) : k * 16 + l;", "(k >> 2) * 128 + l * 4 + (k & 3) : k * 32 + l;"),
    ("const int l16 = lane & 15, slot = 2 * warp + (lane >> 4);", "const int l16 = lane, slot = warp;"),
]
WARP_PER_RAY = WARP_LAYOUT + [
    ("""          t += __shfl_xor_sync(kFull, t, 1);
          const int d = d0 + (l16 >> 2);
          if (mine && (l16 & 3) == 0 && d < d_end) {""", """          t += __shfl_xor_sync(kFull, t, 1);
          t += __shfl_xor_sync(kFull, t, 16);
          const int d = d0 + ((l16 >> 2) & 3);
          if (mine && (l16 & 19) == 0 && d < d_end) {"""),
]

PLAIN = r"""
#include <cuda_runtime.h>
namespace {
#ifdef COLUMN
constexpr int kWarps = 16;  // a column's rays
#else
constexpr int kWarps = 8;
#endif
constexpr int kPerLane = 8, kChunk = 256;
__global__ void __launch_bounds__(32 * kWarps)
plain_kernel(const int* __restrict__ cell, const float* __restrict__ depth, const float* __restrict__ ctx,
             const float* __restrict__ g, float* __restrict__ g_depth, float* __restrict__ g_ctx,
             int n_cams, int NC, int D, int fH, int fW, int C, int ncells) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const long long HW = (long long)fH * fW;
#ifdef COLUMN
  const int cam = blockIdx.x / fW, h = warp, w = blockIdx.x - cam * fW;
  if (h >= fH) return;
  const long long ray = cam * HW + (long long)h * fW + w;
#else
  const long long ray = (long long)blockIdx.x * kWarps + warp;
  const int cam = (int)(ray / HW);
  if (cam >= n_cams) return;
#endif
  const long long hw = ray - cam * HW;
  const float* ctx_row = ctx + ray * C;
  float* gctx_row = g_ctx + ray * C;
  const long long pbase = (long long)cam * D * HW + hw;
  const float* g_b = g + (long long)(cam / NC) * ncells * C;
  for (int c0 = 0; c0 < C; c0 += kChunk) {
    float v[kPerLane], acc[kPerLane], row[kPerLane];
    for (int k = 0; k < kPerLane; ++k) {
      const int c = c0 + k * 32 + lane;
      v[k] = c < C ? ctx_row[c] : 0.f;
      acc[k] = row[k] = 0.f;
    }
    int run = -1;
    for (int d = 0; d < D; ++d) {
      const long long p = pbase + (long long)d * HW;
      const int q = cell[p];
      if (q < 0 || q >= ncells) {
        if (c0 == 0 && lane == 0) g_depth[p] = 0.f;
        continue;
      }
      if (q != run) {
        for (int k = 0; k < kPerLane; ++k) {
          const int c = c0 + k * 32 + lane;
          row[k] = c < C ? g_b[(long long)q * C + c] : 0.f;
        }
        run = q;
      }
      const float wd = depth[p];
      float dot = 0.f;
      for (int k = 0; k < kPerLane; ++k) dot += row[k] * v[k], acc[k] += wd * row[k];
      for (int off = 16; off > 0; off >>= 1) dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) g_depth[p] = c0 == 0 ? dot : g_depth[p] + dot;
    }
    for (int k = 0; k < kPerLane; ++k) {
      const int c = c0 + k * 32 + lane;
      if (c < C) gctx_row[c] = acc[k];
    }
  }
}
}  // namespace
extern "C" int bev_pool_bwd(const int* cell, const float* depth, const float* ctx, const float* g,
                            float* g_depth, float* g_ctx, int B, int NC, int D, int fH, int fW, int C,
                            int ncells, int vec, void* stream) {
#ifdef COLUMN
  if (fH > kWarps) return (int)cudaErrorInvalidValue;
  const dim3 grid(B * NC * fW);
#else
  const dim3 grid((int)(((long long)B * NC * fH * fW + kWarps - 1) / kWarps));
#endif
  plain_kernel<<<grid, 32 * kWarps, 0, (cudaStream_t)stream>>>(cell, depth, ctx, g, g_depth, g_ctx, B * NC, NC, D,
                                                              fH, fW, C, ncells);
  return (int)cudaGetLastError();
}
"""

VARIANTS = {
    "shipped": [], "one_column": ONE_COLUMN, "bin_batches": BIN_BATCHES, "bin_reduce": BIN_REDUCE,
    "serial_loads": SERIAL_LOADS, "warp_per_ray": WARP_PER_RAY,
    "minimal_ring": WARP_LAYOUT + BIN_BATCHES + [(a, b.replace("off = 8", "off = 16")) for a, b in BIN_REDUCE],
    "plain_column": "COLUMN", "ray_major": "",
}


OUT_DIR = ROOT / "build" / "k5_variants"


def build_variants():
    """Compiles every variant in parallel; prints ptxas's registers and spills."""
    src = (ROOT / "unidistill_torch/csrc/bev_pool.cu").read_text()
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        flags = []
        if isinstance(edits, str):  # the plain kernel, COLUMN or not
            text = PLAIN
            flags = [f"-D{edits}"] if edits else []
        else:
            text = src
            for a, b in edits:
                if a not in text:
                    raise RuntimeError(f"{name}: edit does not apply: {a[:60]!r}")
                text = text.replace(a, b)
        cu = OUT_DIR / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen([build.nvcc_path(), *build.NVCC_FLAGS, *flags, "-o", str(cu.with_suffix(".so")),
                                        str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log[-2000:]}")
        regs = [line.split(":", 1)[-1].strip() for line in log.splitlines() if "registers" in line or "spill" in line]
        print(f"{name}: " + " | ".join(regs), flush=True)


def time_variant(name, cells_file):
    """Each variant in a process of its own: one kernel library a process."""
    lib = ctypes.CDLL(str(OUT_DIR / f"{name}.so"))
    lib.bev_pool_bwd.argtypes = list(build.SIGNATURES["bev_pool"]["bev_pool_bwd"])
    lib.bev_pool_bwd.restype = ctypes.c_int
    saved = torch.load(cells_file)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shape = saved["level"].shape
    B, NC, D, fH, fW = shape
    depth = torch.softmax(torch.randn(shape, generator=gen, device="cuda"), 2)
    ctx = torch.randn(B, NC, fH, fW, 256, generator=gen, device="cuda")
    g = torch.randn(B, 180 * 180, 256, generator=gen, device="cuda")
    gd, gc = torch.empty_like(depth), torch.empty_like(ctx)
    stream = torch.cuda.current_stream().cuda_stream
    for geometry, cell in saved.items():
        cell = cell.cuda()

        def fn():
            return lib.bev_pool_bwd(cell.data_ptr(), depth.data_ptr(), ctx.data_ptr(), g.data_ptr(), gd.data_ptr(),
                                    gc.data_ptr(), B, NC, D, fH, fW, 256, 180 * 180, 4, stream)
        build.check(fn(), name)
        for got, want in zip((gd, gc), bev_pool.bev_pool_outer_bwd_plain(cell, depth, ctx, g, 180 * 180)):
            scale = want.abs().max().clamp_min(1e-30)
            torch.testing.assert_close(got / scale, want / scale, rtol=1e-5, atol=1e-5)
        for _ in range(3):
            fn()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(50):
            fn()
        end.record()
        torch.cuda.synchronize()
        print(json.dumps(dict(variant=name, geometry=geometry, ms=round(start.elapsed_time(end) / 50, 4))),
              flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("k5_variants: needs a CUDA device")
    if len(sys.argv) == 4 and sys.argv[2] == "--time":
        time_variant(sys.argv[3], sys.argv[1])
        sys.exit(0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    build_variants()
    failed = [name for name in VARIANTS
              if subprocess.run([sys.executable, __file__, sys.argv[1], "--time", name]).returncode]
    if failed:
        sys.exit(f"k5_variants: {failed} failed")
