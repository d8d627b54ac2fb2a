// K7 fused_offsets: the chunked submanifold conv's 8 non-center offsets as
// one fused case-select + product. K8 axpy2: out = 2x + y in bf16.
//
// K7 replaces the Pallas kernel `fused_offsets` / `_fused_kernel` of the
// JAX experiment experiments/mb_pallas_fused.py:77,51:
//
//   out[b, s, :] = sum_{o=0..7} win(b, o, s) @ W8[o]                    (f32)
//   win(b, o, s) = oh0 * g[b,o,s, 0:6C] + oh1 * g[b,o,s, 4C:10C]
//                + oh2 * [0 (4C lanes) | g[b,o,s, 0:2C]]
//
// g [B, 8, S, 10C] bf16 (the gathered window-table rows), oh [B, 8, S, 4]
// bf16 one-hot of the row's case, W8 [8, 6C, 4co] bf16, out [B, S, 4co] f32.
// C is a multiple of 16 and 4co is 64, 128 or 256 (co 16, 32, 64).
//
// The TPU kernel streamed [512, 10C] row blocks through VMEM, selected with
// three multiply-adds on the vector unit and fed the MXU, revisiting one
// f32 output block over the 8 offsets of a sequential grid axis. Here:
//   * one block owns 64 sites of one sample and all 4co outputs; a loop
//     over (offset o, 32-lane step of the 6C window) replaces the grid's
//     offset axis, and the f32 sums stay in registers for the whole loop,
//     added in offset order o = 0..7;
//   * per step each thread assembles one 8-lane piece of one site's window
//     in shared memory: it reads the site's one-hot and loads only the
//     16-byte pieces of g whose multiplier is nonzero (one, for a one-hot
//     row), so the select is exact and costs no extra pass; 4C is a multiple
//     of 32 lanes, so a piece of case 2's window is either all zeros or one
//     aligned piece of lanes 0:2C;
//   * the W8[o] step tile [32, 4co] is staged with row pairs interleaved, so
//     every B fragment register is one 32-bit shared-memory word;
//   * products are bf16 mma.sync m16n8k16 with f32 accumulation; the next
//     step's global loads are issued before the current step's products.
// What bounds it on an H100: bytes. Each site reads 8 rows of 10C bf16 (of
// which 6C are used) and writes 4co f32, against 8 * 2 * 6C * 4co flops:
// about 77 flops a byte at C = co = 32, far under the tensor cores' ~295.
// The 4C lanes a case never reads are skipped by the piece loads.
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

constexpr int kRows = 64;             // sites per block
constexpr int kThreads = 256;         // 8 warps: 2 along the sites x 4 along the outputs
constexpr int kK = 32;                // window lanes per step
constexpr int kAStride = kK + 8;      // bf16 per staged window row (conflict-free fragments)

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint4 ldg16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float bf16_lo(uint32_t v) { return __uint_as_float(v << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t v) { return __uint_as_float(v & 0xffff0000u); }

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// rows k (a) and k+1 (b), 8 columns each -> 8 words {B[k][c], B[k+1][c]}
__device__ __forceinline__ void interleave_pairs(const uint4& a, const uint4& b, uint4& lo, uint4& hi) {
  lo.x = __byte_perm(a.x, b.x, 0x5410);
  lo.y = __byte_perm(a.x, b.x, 0x7632);
  lo.z = __byte_perm(a.y, b.y, 0x5410);
  lo.w = __byte_perm(a.y, b.y, 0x7632);
  hi.x = __byte_perm(a.z, b.z, 0x5410);
  hi.y = __byte_perm(a.z, b.z, 0x7632);
  hi.z = __byte_perm(a.w, b.w, 0x5410);
  hi.w = __byte_perm(a.w, b.w, 0x7632);
}

template <int CO4>
__global__ void __launch_bounds__(kThreads)
    fused_offsets_kernel(const __nv_bfloat16* __restrict__ g,
                         const __nv_bfloat16* __restrict__ oh,
                         const __nv_bfloat16* __restrict__ w8,
                         float* __restrict__ out, int S, int C) {
  constexpr int kNT = CO4 / 32;                  // n8 tiles per warp (warp width CO4 / 4)
  constexpr int kBS = CO4 + 8;                   // words per staged row pair
  constexpr int kBItems = (kK / 2) * (CO4 / 8);  // (row pair, 8 columns) items per step
  constexpr int kBPer = (kBItems + kThreads - 1) / kThreads;
  __shared__ __align__(16) __nv_bfloat16 sA[kRows * kAStride];
  __shared__ __align__(16) uint32_t sB[(kK / 2) * kBS];

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 2, wn = warp & 3;
  const int b = blockIdx.y;
  const long long s0 = (long long)blockIdx.x * kRows;
  const int win = 6 * C;
  const int row_len = 10 * C;
  const int steps_per_o = win / kK;
  const int steps = 8 * steps_per_o;

  // this thread's window piece: site ar, lanes 8*aq .. 8*aq+7 of the step
  const int ar = tid >> 2, aq = tid & 3;
  const long long as = s0 + ar;
  const bool a_ok = as < S;

  uint4 araw[3];
  float am[3];
  uint4 braw[kBPer][2];

  auto load = [&](int step) {
    const int o = step / steps_per_o;
    const int k0 = (step - o * steps_per_o) * kK;
    const int p0 = k0 + 8 * aq;
    am[0] = am[1] = am[2] = 0.f;
    if (a_ok) {
      const long long r = (long long)(b * 8 + o) * S + as;
      const uint2 m = __ldg(reinterpret_cast<const uint2*>(oh + r * 4));
      am[0] = bf16_lo(m.x);
      am[1] = bf16_hi(m.x);
      am[2] = p0 >= 4 * C ? bf16_lo(m.y) : 0.f;  // case 2's lanes below 4C are zero
      const __nv_bfloat16* gr = g + r * row_len;
      if (am[0] != 0.f) araw[0] = ldg16(gr + p0);
      if (am[1] != 0.f) araw[1] = ldg16(gr + 4 * C + p0);
      if (am[2] != 0.f) araw[2] = ldg16(gr + p0 - 4 * C);
    }
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int item = tid + i * kThreads;
      if (item < kBItems) {
        const int kp = item / (CO4 / 8);
        const int c = (item - kp * (CO4 / 8)) * 8;
        const __nv_bfloat16* wr = w8 + ((long long)o * win + k0 + 2 * kp) * CO4 + c;
        braw[i][0] = ldg16(wr);
        braw[i][1] = ldg16(wr + CO4);
      }
    }
  };

  auto store = [&]() {
    float v[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      if (am[j] != 0.f) {
        const uint32_t* u = reinterpret_cast<const uint32_t*>(&araw[j]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          v[2 * e] = fmaf(am[j], bf16_lo(u[e]), v[2 * e]);
          v[2 * e + 1] = fmaf(am[j], bf16_hi(u[e]), v[2 * e + 1]);
        }
      }
    }
    uint4 pk;
    pk.x = pack_bf16(v[0], v[1]);
    pk.y = pack_bf16(v[2], v[3]);
    pk.z = pack_bf16(v[4], v[5]);
    pk.w = pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(&sA[ar * kAStride + 8 * aq]) = pk;
#pragma unroll
    for (int i = 0; i < kBPer; ++i) {
      const int item = tid + i * kThreads;
      if (item < kBItems) {
        const int kp = item / (CO4 / 8);
        const int c = (item - kp * (CO4 / 8)) * 8;
        uint4 lo, hi;
        interleave_pairs(braw[i][0], braw[i][1], lo, hi);
        *reinterpret_cast<uint4*>(&sB[kp * kBS + c]) = lo;
        *reinterpret_cast<uint4*>(&sB[kp * kBS + c + 4]) = hi;
      }
    }
  };

  float acc[2][kNT][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  load(0);
  store();
  __syncthreads();
  for (int step = 0; step < steps; ++step) {
    if (step + 1 < steps) load(step + 1);
#pragma unroll
    for (int kk = 0; kk < kK; kk += 16) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const int r = wm * 32 + mi * 16 + gid;
        const __nv_bfloat16* p = &sA[r * kAStride + kk + 2 * tig];
        a[mi][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kAStride);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(p + 8);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kAStride + 8);
      }
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const int n = wn * (CO4 / 4) + ni * 8 + gid;
        const uint32_t b0 = sB[(kk / 2 + tig) * kBS + n];
        const uint32_t b1 = sB[(kk / 2 + 4 + tig) * kBS + n];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
    if (step + 1 < steps) {
      store();
      __syncthreads();
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const long long r = s0 + wm * 32 + mi * 16 + gid + 8 * h;
      if (r >= S) continue;
      float* orow = out + ((long long)b * S + r) * CO4;
#pragma unroll
      for (int ni = 0; ni < kNT; ++ni) {
        const int c = wn * (CO4 / 4) + ni * 8 + 2 * tig;
        *reinterpret_cast<float2*>(orow + c) = make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
  }
}

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

// g [B, 8, S, 10C], oh [B, 8, S, 4], w8 [8, 6C, co4] bf16 -> out [B, S, co4] f32
int fused_offsets(const void* g, const void* oh, const void* w8, void* out, int B, int S, int C,
                  int co4, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || C % 16 != 0 || B > 65535) return cudaErrorInvalidValue;
  const dim3 grid((S + kRows - 1) / kRows, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* gp = static_cast<const __nv_bfloat16*>(g);
  const auto* op = static_cast<const __nv_bfloat16*>(oh);
  const auto* wp = static_cast<const __nv_bfloat16*>(w8);
  float* outp = static_cast<float*>(out);
  switch (co4) {
    case 64:
      fused_offsets_kernel<64><<<grid, kThreads, 0, st>>>(gp, op, wp, outp, S, C);
      break;
    case 128:
      fused_offsets_kernel<128><<<grid, kThreads, 0, st>>>(gp, op, wp, outp, S, C);
      break;
    case 256:
      fused_offsets_kernel<256><<<grid, kThreads, 0, st>>>(gp, op, wp, outp, S, C);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// out = 2x + y, n bf16 values
int axpy2_bf16(const void* x, const void* y, void* out, long long n, void* stream) {
  return axpy2_launch(x, y, out, n, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
