"""K7 (the fused case-select + offset products) with each mechanism taken
out, all in one library and one process, timed in turns on the three
stages' realistic inputs (`experiments/realistic.realistic_inputs`, seeded
as `chip_smoke.py` makes them):

    python tools/k7_variants.py [ROUNDS] [VARIANT ...]

Builds the K7 region of `unidistill_torch/csrc/fused_offsets.cu` as these
variants (`tools/variant_build.py`; all of them where none is named):
  shipped          the region as it is;
  register_select  every row's window by the multiply-add in registers and
                   st.shared, not by zero-filling copies;
  stages1          a ring of one stage (no copy overlaps a product);
  stages2          a ring of two stages;
  tile64           64 sites a block (one consumer warpgroup, one m64 tile);
  tile128          128 sites a block for every 4co (one m64 tile a
                   consumer);
  mma_sync         consumers run mma.sync m16n8k16 from the same staged
                   tiles (ldmatrix), not wgmma;
  one_tile_per_block  a block a tile, not as many blocks as the card holds
                   at once walking the tiles (each block fills and drains
                   its ring, and its stores overlap no copy);
  zero_stores      zero pieces by st.shared, not by zero-filling copies;
  w8_copies        each W8 tile by 16-byte cp.async copies of every producer
                   thread, not by one bulk copy;
  ka1              32-lane k-steps (three times the stages an offset, a
                   third of the bytes a stage).
No variant uses multicast: the shipped kernel has none to take out.
Each variant's output lands in a block just filled with NaN
(`harness.poisoned_call`), must agree with the plain version within
1e-4 x max |ref| (as `chip_smoke.py` holds K7) and be bit-identical on a
rerun. Prints the card, each variant's launch (grid, block, registers,
shared bytes; `harness.kernel_geometry`) on each stage, then ROUNDS
(default 2) rounds of one JSON line per stage and variant: `ms` device time
from torch.profiler (`harness.device_ms`), `ms_source`, `events_ms`.
"""
import ctypes
import json
import subprocess
import sys

import torch

import variant_build as vb

sys.path.insert(0, str(vb.ROOT))
from unidistill_torch.configs.nuscenes import lidar_exp  # noqa: E402
from unidistill_torch.experiments.harness import device_ms, kernel_geometry, poisoned_call  # noqa: E402
from unidistill_torch.experiments.realistic import realistic_inputs  # noqa: E402
from unidistill_torch.ops import fused_offsets as fo  # noqa: E402
from unidistill_torch.ops.sparse_conv_chunked import _OFFS8, _band_weight, _w_zyx, _window_table  # noqa: E402

STAGES = ("s2", "s0", "s3")
TOL_OF_MAX = 1e-4
RING = "constexpr int kK7Ring = 3;"
BULK = """      if (tid == 0) {
        mbar_expect_tx(full0 + 8 * s, T::kBBytes);
        bulk_copy_g2s(b_base, w8t + (long long)step * (T::kBBytes / 2), T::kBBytes, full0 + 8 * s);
      }
"""
PRODUCTS = """#pragma unroll
  for (int kk = 0; kk < T::kKs / 16; ++kk) {
    const uint64_t bd = wgmma_desc(b_base + kk * 2048, (T::kKs / 8) * 1024, 1024, 1);
#pragma unroll
    for (int mt = 0; mt < T::kM64; ++mt) {
      const uint32_t a = a_base + (kk >> 1) * T::kAtomBytes + (cw * T::kM64 + mt) * 4096 + (kk & 1) * 32;
      wgmma_bf16<N>(acc[mt], wgmma_desc(a, 16, 512, 2), bd);
    }
  }
}"""
# the same products as mma.sync m16n8k16: warp w of the warpgroup takes rows
# 16w .. 16w + 15 of each m64 tile (the wgmma layout of the sums), A by
# ldmatrix from the 64-byte swizzled atoms, B by ldmatrix.trans from the
# 128-byte swizzled W8 blocks
MMA_SYNC = """const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int kk = 0; kk < T::kKs / 16; ++kk) {
    uint32_t af[T::kM64][4];
#pragma unroll
    for (int mt = 0; mt < T::kM64; ++mt) {
      const int r = (cw * T::kM64 + mt) * 64 + warp * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
      const int c = (kk & 1) * 2 + (lane >> 4);
      const uint32_t at = a_base + (kk >> 1) * T::kAtomBytes + (r >> 3) * 512 + (r & 7) * 64 + ((c ^ ((r & 7) >> 1)) << 4);
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\\n"
                   : "=r"(af[mt][0]), "=r"(af[mt][1]), "=r"(af[mt][2]), "=r"(af[mt][3]) : "r"(at));
    }
#pragma unroll
    for (int j = 0; j < N / 8; j += 2) {
      const int k = kk * 16 + (lane & 7) + 8 * ((lane >> 3) & 1);
      const int n = j + (lane >> 4);
      const uint32_t bt = b_base + ((n >> 3) * (T::kKs / 8) + (k >> 3)) * 1024 + (k & 7) * 128 + (((n & 7) ^ (k & 7)) << 4);
      uint32_t bq[4];
      asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\\n"
                   : "=r"(bq[0]), "=r"(bq[1]), "=r"(bq[2]), "=r"(bq[3]) : "r"(bt));
#pragma unroll
      for (int mt = 0; mt < T::kM64; ++mt) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float* d = &acc[mt][4 * (j + h)];
          asm volatile("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
                       "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\\n"
                       : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
                       : "r"(af[mt][0]), "r"(af[mt][1]), "r"(af[mt][2]), "r"(af[mt][3]), "r"(bq[2 * h]),
                         "r"(bq[2 * h + 1]));
        }
      }
    }
  }
}"""
VARIANTS = {
    "shipped": [],
    "register_select": [("__device__ __forceinline__ int k7_case(uint32_t mx, uint32_t my) {\n",
                         "__device__ __forceinline__ int k7_case(uint32_t mx, uint32_t my) {\n  return 4;\n")],
    "stages1": [(RING, "constexpr int kK7Ring = 1;")],
    "stages2": [(RING, "constexpr int kK7Ring = 2;")],
    "tile64": [("constexpr int kK7Consumers = 2;", "constexpr int kK7Consumers = 1;"),
               ("constexpr int k7_m64(int n) { return n == 256 ? 1 : 2; }", "constexpr int k7_m64(int n) { return 1; }")],
    "mma_sync": [(PRODUCTS, MMA_SYNC)],
    "tile128": [("constexpr int k7_m64(int n) { return n == 256 ? 1 : 2; }",
                 "constexpr int k7_m64(int n) { return 1; }")],
    "one_tile_per_block": [("const int blocks = sms * per_sm < wk.total ? sms * per_sm : wk.total;",
                            "const int blocks = wk.total;")],
    "zero_stores": [("cp_async16(dst, copy ? src[i] + p : g, copy ? 16 : 0);",
                     "if (copy) {\n            cp_async16(dst, src[i] + p, 16);\n          } else {\n"
                     "            st_shared16(dst, make_uint4(0, 0, 0, 0));\n            general = true;\n"
                     "          }")],
    "w8_copies": [(BULK, "      for (int q = tid; q < T::kBBytes / 16; q += 128)\n"
                         "        cp_async16(b_base + 16 * q, w8t + (long long)step * (T::kBBytes / 2) + 8 * q, 16);\n")],
    "ka1": [("constexpr int kK7Atoms = 3;", "constexpr int kK7Atoms = 1;")],
}
ENTRY = ("int k7_{v}(const void* g, const void* oh, const void* w8, void* w8t, void* out, int B, int S, int C,\n"
         "           int co4, void* stream) {{\n"
         "  return v_{v}::fused_offsets_launch(g, oh, w8, w8t, out, B, S, C, co4, static_cast<cudaStream_t>(stream));\n}}")
_P, _I = ctypes.c_void_p, ctypes.c_int


def stage_operands(xs):
    """g, one-hot and W8 of one stage, as `chip_smoke.py` [K7] makes them."""
    tab = _window_table(xs.feats, xs.occ_bits, xs.colkey, xs.chunk, xs.valid, torch.bfloat16)
    W6 = _band_weight(_w_zyx(xs.weight), xs.C, xs.C, 6, 1, torch.bfloat16)
    g, oh = fo.offset_operands(tab, xs.tables, xs.S, xs.C, torch.bfloat16)
    return g, oh, W6[list(_OFFS8)].contiguous()


def main(rounds, names):
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    table = {name: VARIANTS[name] for name in names}
    text = vb.variants_source("fused_offsets", "K7", table, ENTRY)
    lib = vb.build_library(text, "k7_variants", (_P,) * 5 + (_I,) * 4 + (_P,), table, "k7_")

    def call(name, g, oh, W8):
        B, _, S, L = g.shape
        out = torch.empty(B, S, W8.shape[2], dtype=torch.float32, device=g.device)
        w8t = torch.empty_like(W8)
        err = getattr(lib, "k7_" + name)(g.data_ptr(), oh.data_ptr(), W8.data_ptr(), w8t.data_ptr(), out.data_ptr(),
                                         B, S, L // 10, W8.shape[2], torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"{name}: launch failed with cudaError {err}")
        return out

    inputs, _ = realistic_inputs(lidar_exp().model, STAGES, device=torch.device("cuda"))
    operands = {}
    for st in STAGES:
        g, oh, W8 = operands[st] = stage_operands(inputs[st])
        ref = fo.fused_offsets_plain(g, oh, W8)
        scale = ref.abs().max().item()
        for name in table:
            fn = lambda name=name: call(name, g, oh, W8)  # noqa: E731
            got = poisoned_call(fn, ref.numel() * 4)
            err = (got - ref).abs().max().item()
            if not err <= TOL_OF_MAX * scale:
                raise RuntimeError(f"{name} at {st}: max |diff| {err:.3e} > {TOL_OF_MAX} x max |ref| {scale:.3e}")
            if not torch.equal(poisoned_call(fn, ref.numel() * 4), got):
                raise RuntimeError(f"{name} at {st}: two runs on the same inputs are not bit-identical")
            del got
            (geo,) = kernel_geometry(fn, "fused_offsets_kernel<")  # not the W8 tiling kernel
            print(json.dumps(dict(stage=st, variant=name, max_abs_err=err, max_abs_ref=scale,
                                  **{k: geo[k] for k in ("grid", "block", "registers", "shared_bytes")})), flush=True)
        del ref
        torch.cuda.empty_cache()
    for rnd in range(rounds):
        for st in STAGES:
            g, oh, W8 = operands[st]
            for name in table:
                ms, source, events_ms = device_ms(lambda name=name: call(name, g, oh, W8), "fused_offsets_kernel")
                print(json.dumps(dict(stage=st, variant=name, round=rnd, ms=round(ms, 5), ms_source=source,
                                      events_ms=round(events_ms, 5))), flush=True)


if __name__ == "__main__":
    if not torch.cuda.is_available():
        sys.exit("k7_variants: needs a CUDA device")
    args = sys.argv[1:]
    main(int(args[0]) if args else 2, args[1:] or list(VARIANTS))
