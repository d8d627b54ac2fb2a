// K7 fused_offsets: the chunked submanifold conv's 8 non-center offsets as
// one fused case-select + product. K8 axpy2: out = 2x + y in bf16.
//
// K7 replaces the Pallas kernel `fused_offsets` / `_fused_kernel` of the
// JAX experiment experiments/mb_pallas_fused.py:84,51:
//
//   out[b, s, :] = sum_{o=0..7} win(b, o, s) @ W8[o]                    (f32)
//   win(b, o, s) = oh0 * g[b,o,s, 0:6C] + oh1 * g[b,o,s, 4C:10C]
//                + oh2 * [0 (4C lanes) | g[b,o,s, 0:2C]]
//
// g [B, 8, S, 10C] bf16 (the gathered window-table rows), oh [B, 8, S, 4]
// bf16 one-hot of the row's case, W8 [8, 6C, 4co] bf16, out [B, S, 4co] f32.
// C is a multiple of 16 and N = 4co is 64, 128 or 256 (co 16, 32, 64).
//
// The TPU kernel streamed [512, 10C] row blocks through VMEM, selected with
// three multiply-adds on the vector unit and fed the MXU, revisiting one
// f32 output block over the 8 offsets of a sequential grid axis. What bounds
// it on an H100: bytes (each site reads the lanes its 8 cases need and
// writes N f32), and at C = co = 64 nearly as much the dense products
// (2 * 8 * 6C * N flops a site, zeros of case 2 included). Here a tile is
// M sites of one sample (M = 256 for N <= 128, 128 for N = 256: W8 crosses
// L2 once a tile) and is walked as 8 offsets x 6C / 96 k-steps of 96
// window lanes in a fixed order, the f32 sums of its outputs in registers.
// Persistent blocks, as many as the card holds (one an SM), walk the tiles
// t = blockIdx.x, + gridDim.x, ...; in each:
//   * a producer warpgroup stages every k-step in a ring of 3 stages in
//     dynamic shared memory, completed through mbarriers (its copies by
//     cp.async.mbarrier.arrive.noinc), and runs on into the next tile while
//     the consumers store the last;
//   * the select is the copy: each 16-byte piece of a one-hot row's window
//     is one cp.async with src-size 16 (from lane p, 4C + p or p - 4C by the
//     case) or 0 (zeros: case 2 below lane 4C, an all-zero one-hot, a site
//     past S), straight into the wgmma layout; a zero piece reads nothing.
//     Each row's source and zero bound are worked out once an offset: the
//     producer's instructions, not the bytes, held the kernel while they
//     were worked out per piece. A row whose one-hot is not a single 1.0
//     takes the Pallas select's bf16 multiply-adds in registers and
//     st.shared (finite inputs assumed: a copy does not turn 0 * inf into
//     NaN);
//   * W8 is first laid out as the ring holds it, k-step by k-step (a
//     small kernel before K7, into scratch of W8's size), so that one
//     thread moves a stage's W8 rows with one bulk copy (async proxy,
//     counted on the stage's barrier in bytes) instead of every producer
//     thread issuing 12-24 16-byte copies;
//   * two consumer warpgroups run wgmma m64nNk16 (bf16, f32 sums in
//     registers) from the staged tiles: A K-major in 32-lane atoms with the
//     64-byte swizzle, B (W8 rows, N contiguous) MN-major with the 128-byte
//     swizzle. Each waits for a stage, fences the generic-proxy writes
//     against wgmma's async proxy, and hands the stage back once its
//     products are done. Sums are added in (o, k-step, k16) order: reruns
//     are bit-identical;
//   * the epilogue stores f32 pairs, masked at the ragged last tile.
// A ring wait that outlasts ~2^32 cycles traps rather than hangs.
// `tools/k7_variants.py` times the kernel without each of these.
//
// K8 replaces the Pallas `smoke` kernel (experiments/mb_pallas_fused.py:128,
// out = x * 2 + y on [256, 256] bf16). 2x is exact in bf16, so computing
// 2x + y in f32 and rounding once gives the bf16 result bit for bit (the
// exact sum of two bf16 values either fits f32 or lies far from a bf16
// rounding midpoint). Bound by bytes, but at [256, 256] (393 KB, 0.12 us
// at 3.35 TB/s) a launch's fixed cost of about 1.1 us is the time, so the
// body is the shortest path from launch to the first load: a thread owns
// one 16-byte vector of each operand and loads both before any arithmetic;
// 32-bit indices (a launch covers at most 2^30 values, larger n take
// several); no grid-stride loop and no runtime vector test (pointers off
// the 16-byte grid take a separate kernel, a value a thread); where the
// blocks cover n exactly (as at [256, 256]) an instance with no bound
// test; otherwise the n % 8 values past the last vector go to the last
// block's first threads. The geometry is `torch.add`'s (64 blocks of 128
// threads, 8 values a thread at [256, 256], read from a profiler trace).
//
// The launches allocate nothing and run on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

__device__ __forceinline__ float bf16r(float x) { return __bfloat162float(__float2bfloat16_rn(x)); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; src_bytes 0 writes zeros and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, uint32_t src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void st_shared16(uint32_t dst, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// one arrival on `bar` once every earlier cp.async of this thread has landed
__device__ __forceinline__ void mbar_arrive_cp_async(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// the phase also waits for `bytes` more of async-proxy copies (complete_tx)
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.relaxed.cta.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(bytes) : "memory");
}

// `bytes` contiguous bytes global -> shared by the async proxy, counted on `bar`
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "l"(src), "r"(bytes), "r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// wait for the phase of parity `parity` to complete; trap after `limit` cycles
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity, long long limit) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity)) {
    if (clock64() - t0 > limit) __trap();
  }
}

// generic-proxy writes to shared memory (cp.async, st.shared) before wgmma reads them
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int K>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(K) : "memory");
}

// shared-memory matrix descriptor: start address, leading and stride byte
// offsets, swizzle (1: 128 bytes, 2: 64 bytes)
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo, uint32_t sbo, uint32_t swizzle) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) | ((uint64_t)(sbo >> 4) << 32) |
         ((uint64_t)swizzle << 62);
}

// D[64 x N] += A[64 x 16] (K-major) * B[16 x N] (MN-major: tnspB 1), bf16 in, f32 sums
template <int N>
__device__ __forceinline__ void wgmma_bf16(float* d, uint64_t a, uint64_t b);

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<256>(float* d, uint64_t a, uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(1)
      : "memory");
}

// ---- K7 region: tools/k7_variants.py compiles edits of the text up to its end
constexpr int kK7Consumers = 2;        // consumer warpgroups a block
constexpr int kK7Ring = 3;             // ring stages: the most 227 KB hold at 96-lane k-steps
constexpr int kK7Smem = 232448;        // shared memory a block may have on sm_90
constexpr int kK7Atoms = 3;            // 32-lane atoms a k-step: 96 lanes, 6C = 96 (C / 16) for any C
constexpr long long kK7WaitCycles = 1LL << 32;

// m64 tiles a consumer warpgroup owns (its f32 sums: N / 2 registers a tile)
constexpr int k7_m64(int n) { return n == 256 ? 1 : 2; }

template <int N>
struct K7Shape {
  static constexpr int kM64 = k7_m64(N);
  static constexpr int kRows = 64 * kM64 * kK7Consumers;  // sites a block
  static constexpr int kKs = 32 * kK7Atoms;               // window lanes a k-step
  static constexpr int kAtomBytes = kRows * 64;           // one 32-lane atom of the window tile
  static constexpr int kABytes = kK7Atoms * kAtomBytes;
  static constexpr int kBBytes = kKs * N * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  static constexpr int kStages = kK7Ring;
  static constexpr int kSmem = kStages * kStageBytes + 1024;  // + the ring's alignment to 1024 bytes
  static constexpr int kThreads = 128 * (1 + kK7Consumers);
  static_assert(kSmem + 2 * 8 * kStages <= kK7Smem, "the ring does not fit in shared memory");
};

// the case of a row from its one-hot's first three bf16 (bits): 0, 1, 2 one
// 1.0 there and zeros (of either sign) elsewhere, 3 all zero, 4 anything
// else (the multiply-add)
__device__ __forceinline__ int k7_case(uint32_t mx, uint32_t my) {
  const uint32_t h0 = mx & 0xffffu, h1 = mx >> 16, h2 = my & 0xffffu;
  const bool z0 = !(h0 & 0x7fffu), z1 = !(h1 & 0x7fffu), z2 = !(h2 & 0x7fffu);
  if (z0 && z1 && z2) return 3;
  if (h0 == 0x3f80u && z1 && z2) return 0;
  if (z0 && h1 == 0x3f80u && z2) return 1;
  if (z0 && z1 && h2 == 0x3f80u) return 2;
  return 4;
}

// the Pallas select on 8 lanes at window lane p, in its bf16 arithmetic:
// each product and each sum rounded to bf16, (oh0 w0 + oh1 w1) + oh2 w2
__device__ __forceinline__ uint4 k7_madd(const __nv_bfloat16* grow, int p, int c4, uint32_t mx, uint32_t my) {
  const float m0 = bf16_lo(mx), m1 = bf16_hi(mx), m2 = bf16_lo(my);
  const uint4 x0 = ldg16(grow + p), x1 = ldg16(grow + c4 + p);
  const uint4 x2 = p >= c4 ? ldg16(grow + p - c4) : make_uint4(0, 0, 0, 0);
  const uint32_t* u0 = reinterpret_cast<const uint32_t*>(&x0);
  const uint32_t* u1 = reinterpret_cast<const uint32_t*>(&x1);
  const uint32_t* u2 = reinterpret_cast<const uint32_t*>(&x2);
  uint4 r;
  uint32_t* ru = reinterpret_cast<uint32_t*>(&r);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    float v[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float a0 = h ? bf16_hi(u0[e]) : bf16_lo(u0[e]);
      const float a1 = h ? bf16_hi(u1[e]) : bf16_lo(u1[e]);
      const float a2 = h ? bf16_hi(u2[e]) : bf16_lo(u2[e]);
      const float s = bf16r(__fadd_rn(bf16r(__fmul_rn(m0, a0)), bf16r(__fmul_rn(m1, a1))));
      v[h] = __fadd_rn(s, bf16r(__fmul_rn(m2, a2)));
    }
    ru[e] = pack_bf16(v[0], v[1]);
  }
  return r;
}

// A block walks tiles t = blockIdx.x, + gridDim.x, ... of M sites (sample
// t / tiles, rows from (t % tiles) M); both roles count the ring's steps
// `it` across its tiles, so the producer stages the next tile while the
// consumers store the last
struct K7Walk {
  int S, C, tiles, total, steps, spo;
  __device__ __forceinline__ int sample(int t) const { return t / tiles; }
  __device__ __forceinline__ long long row0(int t, int rows) const { return (long long)(t % tiles) * rows; }
};

// W8 [8, 6C, N] -> w8t: each k-step's rows of W8[o] (step o (6C / KS) +
// k0 / KS) as the ring holds them, 1024-byte blocks of 8 rows x 64 outputs,
// block (n / 64, k / 8) at ((n / 64) KS / 8 + k / 8) * 1024, 16-byte chunk j
// of row k at chunk j ^ (k % 8) (the 128-byte swizzle); a thread a chunk
template <int N>
__global__ void __launch_bounds__(256) fused_offsets_kernel_w8_tiles(const uint4* __restrict__ w8,
                                                                     uint4* __restrict__ w8t, int rows) {
  using T = K7Shape<N>;
  const int q = blockIdx.x * 256 + threadIdx.x;
  if (q >= rows * (N / 8)) return;
  const int row = q / (N / 8), j = q % (N / 8);
  const int step = row / T::kKs, k = row % T::kKs;
  w8t[(long long)step * (T::kBBytes / 16) + ((j >> 3) * (T::kKs / 8) + (k >> 3)) * 64 + (k & 7) * 8 +
      ((j & 7) ^ (k & 7))] = w8[q];
}

// the producer warpgroup: warp pw stages rows [pw R, pw R + R) of the
// window tile, a warp instruction 8 rows x 4 16-byte chunks of one atom
// (lane: row rq of an 8-row group, chunk cq); lane l reads the one-hots of
// rows l, l + 32, ... of its warp, one offset ahead, and hands each row's
// to the lanes that stage it by shuffles
template <int N>
__device__ __forceinline__ void k7_produce(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ oh,
                                           const __nv_bfloat16* __restrict__ w8t, const K7Walk& wk, uint32_t ring,
                                           uint32_t full0, uint32_t empty0) {
  using T = K7Shape<N>;
  constexpr int kR = T::kRows / 4;             // rows a producer warp stages
  constexpr int kRH = (kR + 31) / 32;          // one-hot rows a lane reads
  const int tid = threadIdx.x, lane = tid & 31, pw = tid >> 5;
  const int rq = lane >> 2, cq = lane & 3;
  const int S = wk.S, C = wk.C, c4 = 4 * C, row_len = 10 * C;
  uint32_t rx[kRH], ry[kRH], nx[kRH], ny[kRH];

  auto load_oh = [&](int t, int o) {
    const int b = wk.sample(t);
    const long long r0 = wk.row0(t, T::kRows) + pw * kR;
#pragma unroll
    for (int j = 0; j < kRH; ++j) {
      const int rr = 32 * j + lane;
      const long long r = r0 + rr;
      nx[j] = ny[j] = 0;  // past S: case 3, zeros
      if (rr < kR && r < S) {
        const uint2 m = __ldg(reinterpret_cast<const uint2*>(oh + ((long long)(b * 8 + o) * S + r) * 4));
        nx[j] = m.x;
        ny[j] = m.y;
      }
    }
  };

  // per row of this lane's pieces and offset: the row's g, the source
  // lane minus the window lane folded in (src), and the window lane below
  // which the piece is zeros (low; -1: the multiply-add)
  const __nv_bfloat16* src[kR / 8];
  int low[kR / 8];
  int it = 0;
  load_oh(blockIdx.x, 0);
  for (int t = blockIdx.x; t < wk.total; t += gridDim.x) {
    const int b = wk.sample(t);
    const long long row0 = wk.row0(t, T::kRows);
    for (int step = 0; step < wk.steps; ++step, ++it) {
      const int o = step / wk.spo;
      const int k0 = (step - o * wk.spo) * T::kKs;
      if (k0 == 0) {
#pragma unroll
        for (int j = 0; j < kRH; ++j) rx[j] = nx[j], ry[j] = ny[j];
        if (o + 1 < 8)
          load_oh(t, o + 1);
        else if (t + gridDim.x < wk.total)
          load_oh(t + gridDim.x, 0);
#pragma unroll
        for (int i = 0; i < kR / 8; ++i) {
          const int from = 8 * (i & 3) + rq;
          const int cs = k7_case(__shfl_sync(0xffffffffu, rx[i >> 2], from), __shfl_sync(0xffffffffu, ry[i >> 2], from));
          const long long r = row0 + pw * kR + 8 * i + rq;
          src[i] = g + ((long long)(b * 8 + o) * S + (r < S ? r : 0)) * row_len + (cs == 1 ? c4 : cs == 2 ? -c4 : 0);
          low[i] = cs == 4 ? -1 : cs == 2 ? c4 : cs == 3 ? 6 * C : 0;
        }
      }
      const int s = it % T::kStages;
      if (it >= T::kStages) mbar_wait(empty0 + 8 * s, (it / T::kStages - 1) & 1, kK7WaitCycles);
      const uint32_t a_base = ring + s * T::kStageBytes;
      const uint32_t b_base = a_base + T::kABytes;

      // W8[o] rows k0 .. k0 + KS, already in the ring's layout (w8t): one
      // bulk copy, counted on the stage's barrier in bytes
      if (tid == 0) {
        mbar_expect_tx(full0 + 8 * s, T::kBBytes);
        bulk_copy_g2s(b_base, w8t + (long long)step * (T::kBBytes / 2), T::kBBytes, full0 + 8 * s);
      }

      // the window: atom a holds lanes k0 + 32a .. + 32 of every site, rows
      // of 64 bytes in 512-byte groups of 8, chunk c of row r at c ^ ((r % 8) / 2)
      bool general = false;
#pragma unroll
      for (int i = 0; i < kR / 8; ++i) {
        const int rr = pw * kR + 8 * i + rq;  // the site in the tile
        if (__any_sync(0xffffffffu, low[i] < 0)) {  // a row of this group takes the multiply-add
          const int from = 8 * (i & 3) + rq;
          const uint32_t mx = __shfl_sync(0xffffffffu, rx[i >> 2], from);
          const uint32_t my = __shfl_sync(0xffffffffu, ry[i >> 2], from);
          if (low[i] < 0) {
#pragma unroll
            for (int a = 0; a < kK7Atoms; ++a) {
              const uint32_t dst = a_base + a * T::kAtomBytes + (rr >> 3) * 512 + rq * 64 + ((cq ^ (rq >> 1)) << 4);
              st_shared16(dst, k7_madd(src[i], k0 + 32 * a + 8 * cq, c4, mx, my));
            }
            general = true;
            continue;
          }
        }
#pragma unroll
        for (int a = 0; a < kK7Atoms; ++a) {
          const int p = k0 + 32 * a + 8 * cq;
          const uint32_t dst = a_base + a * T::kAtomBytes + (rr >> 3) * 512 + rq * 64 + ((cq ^ (rq >> 1)) << 4);
          const bool copy = p >= low[i];
          cp_async16(dst, copy ? src[i] + p : g, copy ? 16 : 0);
        }
      }
      if (__any_sync(0xffffffffu, general)) fence_proxy_async();
      mbar_arrive_cp_async(full0 + 8 * s);
      __syncwarp();
      if (lane == 0) mbar_arrive(full0 + 8 * s);  // after this warp's st.shared
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// one stage's products for consumer warpgroup cw: its m64 tiles of the
// window tile times the W8 tile, k16 by k16
template <int N>
__device__ __forceinline__ void k7_products(float (&acc)[K7Shape<N>::kM64][N / 2], uint32_t a_base,
                                            uint32_t b_base, int cw) {
  using T = K7Shape<N>;
#pragma unroll
  for (int kk = 0; kk < T::kKs / 16; ++kk) {
    const uint64_t bd = wgmma_desc(b_base + kk * 2048, (T::kKs / 8) * 1024, 1024, 1);
#pragma unroll
    for (int mt = 0; mt < T::kM64; ++mt) {
      const uint32_t a = a_base + (kk >> 1) * T::kAtomBytes + (cw * T::kM64 + mt) * 4096 + (kk & 1) * 32;
      wgmma_bf16<N>(acc[mt], wgmma_desc(a, 16, 512, 2), bd);
    }
  }
}

template <int N>
__device__ __forceinline__ void k7_consume(float* __restrict__ out, const K7Walk& wk, uint32_t ring, uint32_t full0,
                                           uint32_t empty0) {
  using T = K7Shape<N>;
  const int u = threadIdx.x - 128, cw = u >> 7, lane = u & 31, warp = (u >> 5) & 3;
  float acc[T::kM64][N / 2];
  int it = 0;
  for (int t = blockIdx.x; t < wk.total; t += gridDim.x) {
#pragma unroll
    for (int mt = 0; mt < T::kM64; ++mt)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) acc[mt][i] = 0.f;
    for (int step = 0; step < wk.steps; ++step, ++it) {
      const int s = it % T::kStages;
      mbar_wait(full0 + 8 * s, (it / T::kStages) & 1, kK7WaitCycles);
      fence_proxy_async();
      const uint32_t a_base = ring + s * T::kStageBytes;
      wgmma_fence();
      k7_products<N>(acc, a_base, a_base + T::kABytes, cw);
      wgmma_commit();
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty0 + 8 * s);  // this warp's reads of the stage are done
    }
#pragma unroll
    for (int mt = 0; mt < T::kM64; ++mt)
#pragma unroll
      for (int i = 0; i < N / 2; ++i) asm volatile("" : "+f"(acc[mt][i])::"memory");

    // the wgmma layout of D: warp w holds rows 16w + lane / 4 (+ 8), n8
    // tile j columns 8j + 2 (lane % 4) (+ 1)
    const int b = wk.sample(t);
    const long long row0 = wk.row0(t, T::kRows);
#pragma unroll
    for (int mt = 0; mt < T::kM64; ++mt) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const long long r = row0 + (cw * T::kM64 + mt) * 64 + warp * 16 + (lane >> 2) + 8 * h;
        if (r >= wk.S) continue;
        float* orow = out + ((long long)b * wk.S + r) * N + 2 * (lane & 3);
#pragma unroll
        for (int j = 0; j < N / 8; ++j)
          *reinterpret_cast<float2*>(orow + 8 * j) = make_float2(acc[mt][4 * j + 2 * h], acc[mt][4 * j + 2 * h + 1]);
      }
    }
  }
}

template <int N>
__global__ void __launch_bounds__(K7Shape<N>::kThreads, 1)
    fused_offsets_kernel(const __nv_bfloat16* __restrict__ g, const __nv_bfloat16* __restrict__ oh,
                         const __nv_bfloat16* __restrict__ w8t, float* __restrict__ out, K7Walk wk) {
  using T = K7Shape<N>;
  extern __shared__ uint8_t k7_smem[];
  __shared__ __align__(8) uint64_t bars[2 * T::kStages];  // full[s], then empty[s]
  const uint32_t ring = (smem_u32(k7_smem) + 1023) & ~1023u;
  const uint32_t full0 = smem_u32(bars), empty0 = full0 + 8 * T::kStages;
  if (threadIdx.x == 0) {
    for (int s = 0; s < T::kStages; ++s) {
      mbar_init(full0 + 8 * s, 128 + 4);              // each producer's copies, each producer warp (+ W8's bytes)
      mbar_init(empty0 + 8 * s, 4 * kK7Consumers);  // each consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x < 128)
    k7_produce<N>(g, oh, w8t, wk, ring, full0, empty0);
  else
    k7_consume<N>(out, wk, ring, full0, empty0);
}

// w8t (scratch of W8's size) <- W8's tiles, then K7, persistent: as many
// blocks as the card holds at once, none more than tiles
template <int N>
int k7_launch(const __nv_bfloat16* g, const __nv_bfloat16* oh, const __nv_bfloat16* w8, __nv_bfloat16* w8t,
              float* out, int B, int S, int C, cudaStream_t st) {
  using T = K7Shape<N>;
  cudaError_t err = cudaFuncSetAttribute(fused_offsets_kernel<N>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::kSmem);
  int dev = 0, sms = 0, per_sm = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_offsets_kernel<N>, T::kThreads, T::kSmem);
  if (err != cudaSuccess) return err;
  if (6 * C % T::kKs != 0) return cudaErrorInvalidValue;
  K7Walk wk;
  wk.S = S;
  wk.C = C;
  wk.tiles = (S + T::kRows - 1) / T::kRows;
  if ((long long)B * wk.tiles > 0x7fffffff) return cudaErrorInvalidValue;
  wk.total = B * wk.tiles;
  wk.spo = 6 * C / T::kKs;  // k-steps an offset
  wk.steps = 8 * wk.spo;
  const int chunks = 8 * 6 * C * (N / 8);
  fused_offsets_kernel_w8_tiles<N><<<(chunks + 255) / 256, 256, 0, st>>>(reinterpret_cast<const uint4*>(w8),
                                                                          reinterpret_cast<uint4*>(w8t), 8 * 6 * C);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const int blocks = sms * per_sm < wk.total ? sms * per_sm : wk.total;
  fused_offsets_kernel<N><<<blocks, T::kThreads, T::kSmem, st>>>(g, oh, w8t, out, wk);
  return cudaGetLastError();
}

int fused_offsets_launch(const void* g, const void* oh, const void* w8, void* w8t, void* out, int B, int S, int C,
                         int co4, cudaStream_t st) {
  if (B <= 0 || S <= 0 || C <= 0 || C % 16 != 0 || B > 65535) return cudaErrorInvalidValue;
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  const auto* op = static_cast<const __nv_bfloat16*>(oh);
  const auto* wp = static_cast<const __nv_bfloat16*>(w8);
  auto* tp = static_cast<__nv_bfloat16*>(w8t);
  float* outp = static_cast<float*>(out);
  switch (co4) {
    case 64:
      return k7_launch<64>(gp, op, wp, tp, outp, B, S, C, st);
    case 128:
      return k7_launch<128>(gp, op, wp, tp, outp, B, S, C, st);
    case 256:
      return k7_launch<256>(gp, op, wp, tp, outp, B, S, C, st);
    default:
      return cudaErrorInvalidValue;
  }
}
// ---- end of the K7 region

// ---- K8 region: tools/k8_variants.py compiles edits of the text up to its end
constexpr int kAxThreads = 128;            // threads a block: 64 blocks at [256, 256]
constexpr int kAxVecs = 1;                 // 16-byte vectors of each operand a thread
constexpr long long kAxChunk = 1LL << 30;  // values a launch, a multiple of 8

__device__ __forceinline__ uint4 ax_load(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ void ax_store(uint4* p, const uint4& v) { *p = v; }

__device__ __forceinline__ uint32_t axpy2_pair(uint32_t x, uint32_t y) {
  return pack_bf16(fmaf(2.f, bf16_lo(x), bf16_lo(y)), fmaf(2.f, bf16_hi(x), bf16_hi(y)));
}

__device__ __forceinline__ __nv_bfloat16 axpy2_value(__nv_bfloat16 x, __nv_bfloat16 y) {
  return __float2bfloat16_rn(fmaf(2.f, __bfloat162float(x), __bfloat162float(y)));
}

// x, y, out 16-byte aligned: vectors [0, nv), kAxVecs a thread kAxThreads
// apart; the last block's first `tail` threads take the values past them.
// kWhole: the blocks cover [0, nv) exactly and tail is 0, so no thread
// tests a bound (the first loads wait on no kernel parameter but the
// pointers)
template <bool kWhole>
__global__ void __launch_bounds__(kAxThreads)
    axpy2_kernel(const uint4* __restrict__ x, const uint4* __restrict__ y, uint4* __restrict__ out,
                 unsigned nv, unsigned tail) {
  const unsigned i0 = blockIdx.x * (kAxThreads * kAxVecs) + threadIdx.x;
  uint4 a[kAxVecs], b[kAxVecs];
#pragma unroll
  for (int v = 0; v < kAxVecs; ++v) {
    if (kWhole || i0 + v * kAxThreads < nv) {
      a[v] = ax_load(x + i0 + v * kAxThreads);
      b[v] = ax_load(y + i0 + v * kAxThreads);
    }
  }
#pragma unroll
  for (int v = 0; v < kAxVecs; ++v) {
    if (kWhole || i0 + v * kAxThreads < nv) {
      uint4 o;
      o.x = axpy2_pair(a[v].x, b[v].x);
      o.y = axpy2_pair(a[v].y, b[v].y);
      o.z = axpy2_pair(a[v].z, b[v].z);
      o.w = axpy2_pair(a[v].w, b[v].w);
      ax_store(out + i0 + v * kAxThreads, o);
    }
  }
  if (!kWhole && tail != 0 && blockIdx.x == gridDim.x - 1 && threadIdx.x < tail) {
    const unsigned i = nv * 8 + threadIdx.x;
    reinterpret_cast<__nv_bfloat16*>(out)[i] = axpy2_value(
        reinterpret_cast<const __nv_bfloat16*>(x)[i], reinterpret_cast<const __nv_bfloat16*>(y)[i]);
  }
}

// a pointer off the 16-byte grid: a value a thread
__global__ void __launch_bounds__(kAxThreads)
    axpy2_unaligned_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ y,
                           __nv_bfloat16* __restrict__ out, unsigned n) {
  const unsigned i = blockIdx.x * kAxThreads + threadIdx.x;
  if (i < n) out[i] = axpy2_value(x[i], y[i]);
}

int axpy2_launch(const void* x, const void* y, void* out, long long n, cudaStream_t st) {
  if (n < 0) return cudaErrorInvalidValue;
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(out)) % 16) == 0;
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* yp = static_cast<const __nv_bfloat16*>(y);
  auto* op = static_cast<__nv_bfloat16*>(out);
  for (long long at = 0; at < n; at += kAxChunk) {
    const unsigned m = (unsigned)(n - at < kAxChunk ? n - at : kAxChunk);
    if (aligned) {
      constexpr unsigned kPer = kAxThreads * kAxVecs;
      const unsigned nv = m / 8, blocks = nv ? (nv + kPer - 1) / kPer : 1;
      const bool whole = m % (8 * kPer) == 0;
      const auto* xv = reinterpret_cast<const uint4*>(xp + at);
      const auto* yv = reinterpret_cast<const uint4*>(yp + at);
      auto* ov = reinterpret_cast<uint4*>(op + at);
      if (whole)
        axpy2_kernel<true><<<blocks, kAxThreads, 0, st>>>(xv, yv, ov, nv, 0);
      else
        axpy2_kernel<false><<<blocks, kAxThreads, 0, st>>>(xv, yv, ov, nv, m % 8);
    } else {
      axpy2_unaligned_kernel<<<(m + kAxThreads - 1) / kAxThreads, kAxThreads, 0, st>>>(
          xp + at, yp + at, op + at, m);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return err;
  }
  return cudaSuccess;
}
// ---- end of the K8 region

}  // namespace

extern "C" {

// g [B, 8, S, 10C], oh [B, 8, S, 4], w8 [8, 6C, co4] bf16 -> out [B, S, co4] f32;
// w8t: scratch of w8's size
int fused_offsets(const void* g, const void* oh, const void* w8, void* w8t, void* out, int B, int S, int C,
                  int co4, void* stream) {
  return fused_offsets_launch(g, oh, w8, w8t, out, B, S, C, co4, static_cast<cudaStream_t>(stream));
}

// out = 2x + y, n bf16 values
int axpy2_bf16(const void* x, const void* y, void* out, long long n, void* stream) {
  return axpy2_launch(x, y, out, n, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
