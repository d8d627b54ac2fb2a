// K4 sparse_conv_fwd: sparse 3D convolution over an output-stationary
// neighbour map, for every sparse conv of the LiDAR encoder; in training also
// its input gradient. K6 sparse_conv_wgrad: the weight gradient.
//
// Replaces the Pallas key-match kernel `_kernel` / `_subm_fwd_impl` of the
// JAX package (unidistill_tpu/ops/sparse_conv_pallas.py:128,214), which
// computes the 3x3x3 submanifold conv on key-sorted voxels, and also covers
// the strided convs that the JAX encoder runs in XLA (`_SparseDownConv`,
// `_FoldConv3d`, `_DenseConv3d` for conv_out): they differ only in the map.
//
//   out[i, :] = bias + sum_k W[k]^T feats[nbr[i, k], :]   (nbr < 0: no term)
//
// feats [n_in, cin], W [K, cin, cout], out [n_out, cout] in one dtype (f32 or
// bf16), nbr [n_out, K] int32, bias [cout] f32 or null. The sum is kept in
// f32 registers and rounded once at the store.
//
// The TPU kernel matched neighbours by integer key equality: it built a
// [3*block, window] one-hot mask on the vector unit and multiplied it on the
// MXU, because the TPU has no vector gather. Hopper gathers natively, so the
// neighbour map is built once per stage (ops/sparse_conv.py) and the kernel
// gathers rows directly:
//   * one block owns a tile of 64 output rows and loads the tile's nbr
//     entries into shared memory once;
//   * per tap, a tap with no neighbour anywhere in the tile is skipped
//     (a block-wide OR); otherwise the tile's neighbour rows are gathered
//     with 16-byte loads (zeros where nbr = -1) and W_k is staged, both in
//     chunks of 32 (or 16) input channels converted to f32 in shared memory;
//   * each thread keeps a 4-channel x (cout/16)-row block of the f32 sums in
//     registers; every output row is owned by one block, so there are no
//     atomics and the result is deterministic.
//
// What bounds it on an H100: at the stride-1 stages with 16 and 32 channels
// the bytes (the 27-entry map is 108 bytes a row, more than the row itself)
// bound the work; at 64 and 128 channels the multiply-adds do. This simple
// kernel runs them on the CUDA cores in f32 and does a dense 64-row product
// for every tap that has any neighbour in the tile, so at the wide stages it
// is far from the tensor-core bound; mma/wgmma tiles and TMA are later work.
//
// The input gradient of a conv (the first half of the JAX custom VJP
// `_subm_bwd`, sparse_conv_pallas.py:279-286, which re-runs the Pallas kernel
// with the taps reversed and W transposed) is this same kernel over the
// transposed, input-stationary map nbr_t[i, k] = o (nbr[o, k] = i) with
// W[k]^T: tiles are then input rows, and a tap no input of the tile is read
// at is skipped as above.
//
// K6 sparse_conv_wgrad replaces the second half of `_subm_bwd` (:287-317,
// dW[k] = X_k^T g over the rows gathered at tap k):
//
//   dW[k, :, :] = sum_o feats[nbr[o, k], :]^T g[o, :]     (nbr < 0: no term)
//
// feats [n_in, cin] and g [n_out, cout] in one dtype, dW [K, cin, cout] f32.
//   * one block per (chunk of output rows, tap); it walks its chunk 32 rows
//     at a time, skips a 32-row tile with no neighbour at its tap (a
//     block-wide OR), gathers the tile's feature rows and loads its g rows
//     with 16-byte loads into shared memory as f32, and adds their outer
//     products into a cin x cout f32 tile held in registers (4 output
//     channels x 1-16 input channels a thread; with fewer than 256 threads'
//     worth of tile, groups of threads take alternate rows and are summed in
//     group order at the end);
//   * each block writes its chunk's partial tile; a second kernel adds the
//     chunks in chunk order. No float atomics: the result is deterministic.
// What bounds it: the same pairs as the forward, a cin x cout outer product
// each, on the CUDA cores in f32 (tensor-core tiles are later work); at 16
// and 32 channels the gathered rows and the map (bytes) bound it.
//
// The launches allocate nothing and run on the caller's stream.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;             // output rows per block
constexpr int kThreads = 256;
constexpr int kMaxTaps = 27;
constexpr int kChunk = 32;            // input channels staged per step
constexpr int kXStride = kChunk + 1;  // padded row of the staged rows (no bank conflicts)

// 16 bytes at p (4 floats or 8 bf16), converted to f32
__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* dst) {
  const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    dst[2 * i] = f.x;
    dst[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float* v) {
  __nv_bfloat162 h[2] = {__floats2bfloat162_rn(v[0], v[1]),
                         __floats2bfloat162_rn(v[2], v[3])};
  *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
}

template <typename T, int COUT>
__global__ void __launch_bounds__(kThreads)
    sparse_conv_fwd_kernel(const T* __restrict__ feats,
                           const int* __restrict__ nbr,
                           const T* __restrict__ w,
                           const float* __restrict__ bias,
                           T* __restrict__ out, int n_in, int n_out, int K,
                           int cin) {
  constexpr int kColThreads = COUT / 4;  // 4 output channels per thread
  constexpr int kRowThreads = kThreads / kColThreads;
  constexpr int kRows = kTile / kRowThreads;  // output rows per thread
  constexpr int kVec = 16 / sizeof(T);        // elements per 16-byte load
  static_assert(kRows >= 1 && kRowThreads * kColThreads == kThreads, "tile");

  __shared__ int s_nbr[kTile][kMaxTaps];
  __shared__ float s_x[kTile][kXStride];
  __shared__ __align__(16) float s_w[kChunk][COUT];

  const int tid = threadIdx.x;
  const int tx = tid % kColThreads;
  const int ty = tid / kColThreads;
  const long long row0 = (long long)blockIdx.x * kTile;

  for (int i = tid; i < kTile * K; i += kThreads) {
    const int r = i / K;
    const int k = i - r * K;
    int v = -1;
    if (row0 + r < n_out) {
      v = nbr[(row0 + r) * K + k];
      if (v >= n_in) v = -1;
    }
    s_nbr[r][k] = v;
  }
  __syncthreads();

  float acc[kRows][4];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[m][j] = 0.f;

  const int kc = (cin % kChunk == 0) ? kChunk : 16;  // cin is a multiple of 16
  const int vpr = kc / kVec;                         // loads per staged row
  for (int k = 0; k < K; ++k) {
    const int mine = tid < kTile ? (s_nbr[tid][k] >= 0) : 0;
    if (!__syncthreads_or(mine)) continue;
    const T* wk = w + (long long)k * cin * COUT;
    for (int c0 = 0; c0 < cin; c0 += kc) {
      for (int i = tid; i < kTile * vpr; i += kThreads) {
        const int r = i / vpr;
        const int part = i - r * vpr;
        const int src = s_nbr[r][k];
        float v[kVec];
        if (src >= 0) {
          load16(feats + (long long)src * cin + c0 + part * kVec, v);
        } else {
#pragma unroll
          for (int j = 0; j < kVec; ++j) v[j] = 0.f;
        }
#pragma unroll
        for (int j = 0; j < kVec; ++j) s_x[r][part * kVec + j] = v[j];
      }
      for (int i = tid; i < kc * COUT / kVec; i += kThreads) {
        float v[kVec];
        load16(wk + (long long)c0 * COUT + i * kVec, v);
        const int ci = (i * kVec) / COUT;
        const int co = (i * kVec) % COUT;
#pragma unroll
        for (int j = 0; j < kVec; ++j) s_w[ci][co + j] = v[j];
      }
      __syncthreads();
      for (int ci = 0; ci < kc; ++ci) {
        const float4 wv = *reinterpret_cast<const float4*>(&s_w[ci][tx * 4]);
#pragma unroll
        for (int m = 0; m < kRows; ++m) {
          const float xv = s_x[ty * kRows + m][ci];
          acc[m][0] = fmaf(xv, wv.x, acc[m][0]);
          acc[m][1] = fmaf(xv, wv.y, acc[m][1]);
          acc[m][2] = fmaf(xv, wv.z, acc[m][2]);
          acc[m][3] = fmaf(xv, wv.w, acc[m][3]);
        }
      }
      __syncthreads();
    }
  }

  float b[4] = {0.f, 0.f, 0.f, 0.f};
  if (bias != nullptr) {
#pragma unroll
    for (int j = 0; j < 4; ++j) b[j] = bias[tx * 4 + j];
  }
#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    const long long row = row0 + ty * kRows + m;
    if (row >= n_out) continue;
    float v[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] = acc[m][j] + b[j];
    store4(out + row * COUT + tx * 4, v);
  }
}

template <typename T>
int launch(const void* feats, const int* nbr, const void* w, const float* bias,
           void* out, int n_in, int n_out, int K, int cin, int cout,
           cudaStream_t stream) {
  const dim3 grid((n_out + kTile - 1) / kTile);
  const dim3 block(kThreads);
  const T* f = static_cast<const T*>(feats);
  const T* wt = static_cast<const T*>(w);
  T* o = static_cast<T*>(out);
  switch (cout) {
    case 16:
      sparse_conv_fwd_kernel<T, 16><<<grid, block, 0, stream>>>(f, nbr, wt, bias, o, n_in, n_out, K, cin);
      break;
    case 32:
      sparse_conv_fwd_kernel<T, 32><<<grid, block, 0, stream>>>(f, nbr, wt, bias, o, n_in, n_out, K, cin);
      break;
    case 64:
      sparse_conv_fwd_kernel<T, 64><<<grid, block, 0, stream>>>(f, nbr, wt, bias, o, n_in, n_out, K, cin);
      break;
    case 128:
      sparse_conv_fwd_kernel<T, 128><<<grid, block, 0, stream>>>(f, nbr, wt, bias, o, n_in, n_out, K, cin);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

constexpr int kWRows = 32;  // output rows a K6 block stages per step

template <typename T, int CIN, int COUT>
__global__ void __launch_bounds__(kThreads)
    sparse_conv_wgrad_kernel(const T* __restrict__ feats,
                             const T* __restrict__ g,
                             const int* __restrict__ nbr,
                             float* __restrict__ partial, int n_in,
                             int n_out, int K, int rows_per_chunk) {
  constexpr int kCols = COUT / 4;  // threads along cout, 4 channels each
  constexpr int kTileThreads = CIN * kCols < kThreads ? CIN * kCols : kThreads;
  constexpr int kGroups = kThreads / kTileThreads;    // row groups
  constexpr int kCiPer = CIN * kCols / kTileThreads;  // cin rows a thread
  constexpr int kVec = 16 / sizeof(T);
  static_assert(kGroups * kTileThreads == kThreads && kCiPer >= 1, "tile");
  static_assert(kGroups == 1 || kCiPer == 1, "groups");

  __shared__ int s_src[kWRows];
  __shared__ float s_x[kWRows][CIN];
  __shared__ __align__(16) float s_g[kWRows][COUT];
  __shared__ __align__(16) float s_red[kGroups > 1 ? kThreads * 4 : 4];

  const int tid = threadIdx.x;
  const int grp = tid / kTileThreads;
  const int t = tid - grp * kTileThreads;
  const int tx = t % kCols;
  const int ty = t / kCols;
  const int k = blockIdx.y;
  const long long r0 = (long long)blockIdx.x * rows_per_chunk;
  const long long r1 = r0 + rows_per_chunk < n_out ? r0 + rows_per_chunk : n_out;

  float acc[kCiPer][4];
#pragma unroll
  for (int c = 0; c < kCiPer; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[c][j] = 0.f;

  for (long long base = r0; base < r1; base += kWRows) {
    int mine = 0;
    if (tid < kWRows) {
      int src = -1;
      if (base + tid < r1) {
        src = nbr[(base + tid) * K + k];
        if (src >= n_in) src = -1;
      }
      s_src[tid] = src;
      mine = src >= 0;
    }
    if (!__syncthreads_or(mine)) continue;
    for (int i = tid; i < kWRows * (CIN / kVec); i += kThreads) {
      const int r = i / (CIN / kVec);
      const int part = i - r * (CIN / kVec);
      const int src = s_src[r];
      float v[kVec];
      if (src >= 0) {
        load16(feats + (long long)src * CIN + part * kVec, v);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) s_x[r][part * kVec + j] = v[j];
    }
    for (int i = tid; i < kWRows * (COUT / kVec); i += kThreads) {
      const int r = i / (COUT / kVec);
      const int part = i - r * (COUT / kVec);
      float v[kVec];
      if (s_src[r] >= 0) {  // then base + r < r1
        load16(g + (base + r) * COUT + part * kVec, v);
      } else {
#pragma unroll
        for (int j = 0; j < kVec; ++j) v[j] = 0.f;
      }
#pragma unroll
      for (int j = 0; j < kVec; ++j) s_g[r][part * kVec + j] = v[j];
    }
    __syncthreads();
    for (int r = grp; r < kWRows; r += kGroups) {
      const float4 gv = *reinterpret_cast<const float4*>(&s_g[r][tx * 4]);
#pragma unroll
      for (int c = 0; c < kCiPer; ++c) {
        const float xv = s_x[r][ty * kCiPer + c];
        acc[c][0] = fmaf(xv, gv.x, acc[c][0]);
        acc[c][1] = fmaf(xv, gv.y, acc[c][1]);
        acc[c][2] = fmaf(xv, gv.z, acc[c][2]);
        acc[c][3] = fmaf(xv, gv.w, acc[c][3]);
      }
    }
    __syncthreads();
  }

  float* out = partial + ((long long)blockIdx.x * K + k) * CIN * COUT;
  if constexpr (kGroups == 1) {
#pragma unroll
    for (int c = 0; c < kCiPer; ++c) store4(out + (ty * kCiPer + c) * COUT + tx * 4, acc[c]);
  } else {
#pragma unroll
    for (int j = 0; j < 4; ++j) s_red[tid * 4 + j] = acc[0][j];
    __syncthreads();
    if (grp != 0) return;
    for (int q = 1; q < kGroups; ++q)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[0][j] += s_red[(q * kTileThreads + t) * 4 + j];
    store4(out + ty * COUT + tx * 4, acc[0]);
  }
}

// dw[i] = sum over the chunks, in chunk order, of partial[chunk][i]
__global__ void sparse_conv_wgrad_reduce_kernel(const float* __restrict__ partial,
                                                float* __restrict__ dw, int chunks,
                                                long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int c = 0; c < chunks; ++c) s += partial[(long long)c * n + i];
  dw[i] = s;
}

template <typename T, int CIN>
int launch_wgrad_cin(const void* feats, const void* g, const int* nbr, float* partial,
                     int n_in, int n_out, int K, int cout, int chunks,
                     int rows_per_chunk, cudaStream_t stream) {
  const dim3 grid(chunks, K);
  const T* f = static_cast<const T*>(feats);
  const T* gt = static_cast<const T*>(g);
  switch (cout) {
    case 16:
      sparse_conv_wgrad_kernel<T, CIN, 16><<<grid, kThreads, 0, stream>>>(f, gt, nbr, partial, n_in, n_out, K, rows_per_chunk);
      break;
    case 32:
      sparse_conv_wgrad_kernel<T, CIN, 32><<<grid, kThreads, 0, stream>>>(f, gt, nbr, partial, n_in, n_out, K, rows_per_chunk);
      break;
    case 64:
      sparse_conv_wgrad_kernel<T, CIN, 64><<<grid, kThreads, 0, stream>>>(f, gt, nbr, partial, n_in, n_out, K, rows_per_chunk);
      break;
    case 128:
      sparse_conv_wgrad_kernel<T, CIN, 128><<<grid, kThreads, 0, stream>>>(f, gt, nbr, partial, n_in, n_out, K, rows_per_chunk);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_wgrad(const void* feats, const void* g, const int* nbr, float* partial,
                 int n_in, int n_out, int K, int cin, int cout, int chunks,
                 int rows_per_chunk, cudaStream_t stream) {
  switch (cin) {
    case 16:
      return launch_wgrad_cin<T, 16>(feats, g, nbr, partial, n_in, n_out, K, cout, chunks, rows_per_chunk, stream);
    case 32:
      return launch_wgrad_cin<T, 32>(feats, g, nbr, partial, n_in, n_out, K, cout, chunks, rows_per_chunk, stream);
    case 64:
      return launch_wgrad_cin<T, 64>(feats, g, nbr, partial, n_in, n_out, K, cout, chunks, rows_per_chunk, stream);
    case 128:
      return launch_wgrad_cin<T, 128>(feats, g, nbr, partial, n_in, n_out, K, cout, chunks, rows_per_chunk, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. cin a multiple of 16, cout one of 16, 32,
// 64, 128, K <= 27; bias may be null.
extern "C" int sparse_conv_fwd(const void* feats, const int* nbr, const void* w,
                               const float* bias, void* out, int n_in,
                               int n_out, int K, int cin, int cout, int dtype,
                               void* stream) {
  if (K < 1 || K > kMaxTaps || cin < 16 || cin % 16 != 0) return (int)cudaErrorInvalidValue;
  if (n_out <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>(feats, nbr, w, bias, out, n_in, n_out, K, cin, cout, s);
  if (dtype == 1) return launch<__nv_bfloat16>(feats, nbr, w, bias, out, n_in, n_out, K, cin, cout, s);
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32, 1 = bfloat16. cin and cout each one of 16, 32, 64, 128,
// K <= 27, 1 <= chunks; partial is scratch of chunks * K * cin * cout floats,
// dw receives K * cin * cout floats.
extern "C" int sparse_conv_wgrad(const void* feats, const void* g, const int* nbr,
                                 float* partial, float* dw, int n_in, int n_out,
                                 int K, int cin, int cout, int chunks, int dtype,
                                 void* stream) {
  if (K < 1 || K > kMaxTaps || chunks < 1) return (int)cudaErrorInvalidValue;
  if (n_out <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const int tiles = (n_out + kWRows - 1) / kWRows;
  const int rows_per_chunk = (tiles + chunks - 1) / chunks * kWRows;
  int err;
  if (dtype == 0) {
    err = launch_wgrad<float>(feats, g, nbr, partial, n_in, n_out, K, cin, cout, chunks, rows_per_chunk, s);
  } else if (dtype == 1) {
    err = launch_wgrad<__nv_bfloat16>(feats, g, nbr, partial, n_in, n_out, K, cin, cout, chunks, rows_per_chunk, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != 0) return err;
  const long long n = (long long)K * cin * cout;
  sparse_conv_wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(partial, dw, chunks, n);
  return (int)cudaGetLastError();
}
