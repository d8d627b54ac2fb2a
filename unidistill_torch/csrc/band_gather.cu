// K9 band_gather_fori, K10 band_gather_take, K11 band_gather_onehot: three
// designs of one banded row gather,
//
//   out[k, :] = tab[clip(idx[k], w[j], w[j] + band - 1), :],  j = k / R,
//
// tab [n_tab, W], out [S, W], idx [S] int32, w [ceil(S / R)] int32 with
// 0 <= w[j] <= n_tab - band. Every design is bit-exact (K11 for finite
// tables other than -0.0, which a sum of products returns as +0.0).
//
// They replace the Pallas kernels of the JAX experiment
// experiments/mb_gather_pallas.py, which copy each R-row block's band
// tab[w_j : w_j + band] into VMEM and gather from it: `variant_fori` (:105,
// a per-row loop, unroll 1 and 4), `variant_take` (:148, one
// take_along_axis over the block) and `variant_onehot` (:168, the gather as
// a one-hot matmul on the MXU). A band (4096 rows x 640 bf16 = 5 MB at the
// published size) cannot sit in an SM's 228 KB of shared memory, but the
// whole band does sit in the 50 MB L2, so the gathers read the table
// directly and the band's locality is served by L2, not by a staged copy:
//   * K9: one warp per row (unroll 1) or per 4 consecutive rows (unroll 4),
//     16-byte loads along the row; with unroll 4 a warp issues its four
//     rows' loads before their stores;
//   * K10: each thread copies one (row, 16-byte piece) pair, so consecutive
//     threads read consecutive pieces and a block reads whole rows
//     together;
//   * K11: a tiled product onehot[R, band] @ band[band, W] on the tensor
//     cores (bf16 mma.sync m16n8k16, f32 accumulation, cast to bf16): a
//     block owns 128 rows of one R-row block and 128 columns; the one-hot A
//     fragments are made in registers from idx - w_j and never touch
//     memory; 32-row band tiles are staged in shared memory with row pairs
//     interleaved (one 32-bit word per B fragment register), the next tile's
//     loads issued before the current tile's products. Each output is a sum
//     with one nonzero term, so it equals the gathered value.
// What bounds them on an H100: K9 and K10 move bytes (each row read once and
// written once; 84 MB each way at the published size); K11 does 2·S·band·W
// operations (344 GFLOP at the published size, 0.35 ms at the bf16 peak)
// for the same bytes, so operations bound it by a factor of ~5.
//
// The launches allocate nothing and run on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

__device__ __forceinline__ int band_row(const int* __restrict__ idx, const int* __restrict__ w,
                                        long long k, int R, int band, int n_tab) {
  const int lo = __ldg(w + k / R);
  int i = __ldg(idx + k);
  i = min(max(i, lo), lo + band - 1);
  return min(max(i, 0), n_tab - 1);  // memory safety when w breaks its contract
}

// rows move as 16-byte pieces: the row bytes and both pointers are multiples of 16
template <int UNROLL>
__global__ void __launch_bounds__(256)
    band_gather_fori_kernel(const uint4* __restrict__ tab, const int* __restrict__ idx,
                            const int* __restrict__ w, uint4* __restrict__ out, int n_tab,
                            long long S, int R, int band, int vpr) {
  const int lane = threadIdx.x & 31;
  const long long k0 = (((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5) * UNROLL;
  long long src[UNROLL];
  bool ok[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    ok[u] = k0 + u < S;
    src[u] = ok[u] ? (long long)band_row(idx, w, k0 + u, R, band, n_tab) * vpr : 0;
  }
  for (int c = lane; c < vpr; c += 32) {
    uint4 v[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (ok[u]) v[u] = __ldg(tab + src[u] + c);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      if (ok[u]) out[(k0 + u) * vpr + c] = v[u];
  }
}

__global__ void __launch_bounds__(256)
    band_gather_take_kernel(const uint4* __restrict__ tab, const int* __restrict__ idx,
                            const int* __restrict__ w, uint4* __restrict__ out, int n_tab,
                            long long S, int R, int band, int vpr) {
  const long long total = S * vpr;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x; t < total; t += stride) {
    const long long k = t / vpr;
    const int c = (int)(t - k * vpr);
    out[t] = __ldg(tab + (long long)band_row(idx, w, k, R, band, n_tab) * vpr + c);
  }
}

constexpr int kOM = 128;          // rows per block
constexpr int kON = 128;          // columns per block
constexpr int kOK = 32;           // band rows per tile
constexpr int kOThreads = 256;    // 8 warps: 4 along the rows x 2 along the columns
constexpr int kOBS = kON + 8;     // words per staged row pair (conflict-free fragments)

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two one-hot entries (band positions k, k+1 of a row whose position is loc)
// packed as bf16 {lo, hi}; bf16 1.0 is 0x3f80
__device__ __forceinline__ uint32_t onehot_pair(int loc, int k) {
  return (loc == k ? 0x3f80u : 0u) | (loc == k + 1 ? 0x3f800000u : 0u);
}

__global__ void __launch_bounds__(kOThreads)
    band_gather_onehot_kernel(const __nv_bfloat16* __restrict__ tab, const int* __restrict__ idx,
                              const int* __restrict__ w, __nv_bfloat16* __restrict__ out,
                              int n_tab, int S, int W, int R, int band) {
  __shared__ __align__(16) uint32_t sB[(kOK / 2) * kOBS];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int gid = lane >> 2, tig = lane & 3;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * kOM;
  const int n0 = blockIdx.x * kON;
  const int lo = __ldg(w + m0 / R);  // R is a multiple of kOM: one band per block

  // band position of this thread's four rows (m16 tile mi, row gid + 8h);
  // -1 past the end matches no position
  int loc[2][2];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * 32 + mi * 16 + gid + 8 * h;
      loc[mi][h] = -1;
      if (r < S) {
        const int i = __ldg(idx + r);
        loc[mi][h] = min(max(i, lo), lo + band - 1) - lo;
      }
    }

  // this thread's band tile item: row pair kp, columns cc .. cc+7
  const int kp = tid >> 4, cc = (tid & 15) * 8;
  const bool b_ok = n0 + cc < W;
  uint4 braw0, braw1;
  auto load = [&](int k0) {
    braw0 = braw1 = make_uint4(0, 0, 0, 0);
    if (b_ok) {
      const int r0 = min(lo + k0 + 2 * kp, n_tab - 1);
      const int r1 = min(lo + k0 + 2 * kp + 1, n_tab - 1);
      braw0 = __ldg(reinterpret_cast<const uint4*>(tab + (long long)r0 * W + n0 + cc));
      braw1 = __ldg(reinterpret_cast<const uint4*>(tab + (long long)r1 * W + n0 + cc));
    }
  };
  auto store = [&]() {
    uint4 a, b;
    a.x = __byte_perm(braw0.x, braw1.x, 0x5410);
    a.y = __byte_perm(braw0.x, braw1.x, 0x7632);
    a.z = __byte_perm(braw0.y, braw1.y, 0x5410);
    a.w = __byte_perm(braw0.y, braw1.y, 0x7632);
    b.x = __byte_perm(braw0.z, braw1.z, 0x5410);
    b.y = __byte_perm(braw0.z, braw1.z, 0x7632);
    b.z = __byte_perm(braw0.w, braw1.w, 0x5410);
    b.w = __byte_perm(braw0.w, braw1.w, 0x7632);
    *reinterpret_cast<uint4*>(&sB[kp * kOBS + cc]) = a;
    *reinterpret_cast<uint4*>(&sB[kp * kOBS + cc + 4]) = b;
  };

  float acc[2][8][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 8; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < band; k0 += kOK) {
    if (k0 + kOK < band) load(k0 + kOK);
#pragma unroll
    for (int kk = 0; kk < kOK; kk += 16) {
      const int kb = k0 + kk + 2 * tig;
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        a[mi][0] = onehot_pair(loc[mi][0], kb);
        a[mi][1] = onehot_pair(loc[mi][1], kb);
        a[mi][2] = onehot_pair(loc[mi][0], kb + 8);
        a[mi][3] = onehot_pair(loc[mi][1], kb + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int n = wn * 64 + ni * 8 + gid;
        const uint32_t b0 = sB[(kk / 2 + tig) * kOBS + n];
        const uint32_t b1 = sB[(kk / 2 + 4 + tig) * kOBS + n];
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) mma_bf16(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
    if (k0 + kOK < band) {
      store();
      __syncthreads();
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + wm * 32 + mi * 16 + gid + 8 * h;
      if (r >= S) continue;
#pragma unroll
      for (int ni = 0; ni < 8; ++ni) {
        const int c = n0 + wn * 64 + ni * 8 + 2 * tig;
        if (c < W) {
          __nv_bfloat162 v = __floats2bfloat162_rn(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
          *reinterpret_cast<__nv_bfloat162*>(out + (long long)r * W + c) = v;
        }
      }
    }
}

bool bad_args(int n_tab, long long S, int row_bytes, int R, int band) {
  return n_tab <= 0 || S < 0 || row_bytes <= 0 || R <= 0 || band <= 0 || band > n_tab;
}

}  // namespace

extern "C" {

// variant 0: K9 unroll 1, 1: K9 unroll 4, 2: K10; row_bytes and both
// pointers multiples of 16
int band_gather_copy(const void* tab, const void* idx, const void* w, void* out, int n_tab,
                     long long S, int row_bytes, int R, int band, int variant, void* stream) {
  if (bad_args(n_tab, S, row_bytes, R, band) || row_bytes % 16 != 0 ||
      (reinterpret_cast<uintptr_t>(tab) | reinterpret_cast<uintptr_t>(out)) % 16 != 0)
    return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  const int vpr = row_bytes / 16;
  const auto* tp = static_cast<const uint4*>(tab);
  const int* ip = static_cast<const int*>(idx);
  const int* wp = static_cast<const int*>(w);
  auto* op = static_cast<uint4*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  long long blocks;
  switch (variant) {
    case 0:
      blocks = (S + 7) / 8;  // 8 warps, a row each
      band_gather_fori_kernel<1><<<(unsigned)blocks, 256, 0, st>>>(tp, ip, wp, op, n_tab, S, R, band, vpr);
      break;
    case 1:
      blocks = (S + 31) / 32;  // 8 warps, 4 rows each
      band_gather_fori_kernel<4><<<(unsigned)blocks, 256, 0, st>>>(tp, ip, wp, op, n_tab, S, R, band, vpr);
      break;
    case 2:
      blocks = std::min((S * vpr + 255) / 256, 1LL << 30);
      band_gather_take_kernel<<<(unsigned)blocks, 256, 0, st>>>(tp, ip, wp, op, n_tab, S, R, band, vpr);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// K11: bf16 tab [n_tab, W] with W % 8 == 0, R % 128 == 0, band % 32 == 0
int band_gather_onehot(const void* tab, const void* idx, const void* w, void* out, int n_tab, int S,
                       int W, int R, int band, void* stream) {
  if (bad_args(n_tab, S, 2 * W, R, band) || W % 8 != 0 || R % kOM != 0 || band % kOK != 0 ||
      (S + kOM - 1) / kOM > 65535)
    return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  const dim3 grid((W + kON - 1) / kON, (S + kOM - 1) / kOM);
  band_gather_onehot_kernel<<<grid, kOThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(tab), static_cast<const int*>(idx),
      static_cast<const int*>(w), static_cast<__nv_bfloat16*>(out), n_tab, S, W, R, band);
  return cudaGetLastError();
}

}  // extern "C"
