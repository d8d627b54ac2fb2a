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
// gathers rows directly. Each dtype has its own kernel.
//
// bf16 (`sparse_conv_tc_kernel`): a gathered implicit GEMM on the tensor
// cores.
//   * one block of 4 warps owns 128 output rows and all of cout (16, 32, 64
//     or 128, one instance each); each warp holds a 32 x cout tile of f32
//     sums in registers;
//   * the tile's nbr rows are loaded into shared memory once (all of a
//     thread's loads in flight together), and a 27-bit mask of the taps with
//     any neighbour in the tile is OR-reduced once; the tap loop walks only
//     those taps, in increasing order;
//   * a pipeline step is (active tap, chunk of kc = 64, 32 or 16 input
//     channels): the tile's rows at that tap are copied straight from device
//     memory (L1/L2 serve the reuse between taps) into shared memory in bf16
//     with 16-byte cp.async, zero-filled where nbr = -1 (src-size 0), and
//     W_k's [kc x cout] slice beside them; rows are padded by 16 bytes so
//     that ldmatrix is free of bank conflicts. Two stages and one barrier a
//     step: step s+1's copies are in flight while step s's products run;
//   * products are bf16 mma.sync m16n8k16 with f32 sums, A from ldmatrix, B
//     from ldmatrix.trans ([kc][cout] rows); for the input gradient the
//     kernel reads the untransposed [K, cout, cin] weight as W^T with a
//     plain ldmatrix (w_layout 1), so the wrapper copies no transpose;
//   * the epilogue adds the bias in f32, rounds once to bf16, stages the tile
//     in shared memory and stores it with 16-byte stores. Every output row is
//     owned by one block and the taps run in a fixed order: no atomics, and a
//     rerun is bit-identical.
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py):
// at 64 and 128 channels the dense-tile mma work (every row of a tile runs
// the product of every active tap; with key-sorted rows nearly every tap is
// active in nearly every tile, so a LiDAR request runs about 1.8x the work
// its pairs need) at 160-210 TFLOP/s; at 16 and 32 channels the nbr map
// (108 bytes a row, more than the row itself) and the gathers, each row
// copied into shared memory once per tap, at 30-90 TFLOP/s. Measured and
// no better by more than noise: 3 to 6 stages, 64- or 256-row blocks,
// visiting the taps dz-minor (L1 reuse of the rows), cp.async.cg. Left for
// later: sorting rows by tap mask so that tiles carry fewer inactive rows
// (spconv v2's mask split), wgmma (TMA cannot gather rows), and a
// persistent schedule that overlaps one tile's epilogue with the next
// tile's loads.
//
// f32 (`sparse_conv_fwd_kernel<float, COUT>`), for the f32 steps and checks:
//   * one block owns a tile of 64 output rows and loads the tile's nbr
//     entries into shared memory once;
//   * per tap, a tap with no neighbour anywhere in the tile is skipped
//     (a block-wide OR); otherwise the tile's neighbour rows are gathered
//     with 16-byte loads (zeros where nbr = -1) and W_k is staged, both in
//     chunks of 32 (or 16) input channels converted to f32 in shared memory;
//   * each thread keeps a 4-channel x (cout/16)-row block of the f32 sums in
//     registers; every output row is owned by one block, so there are no
//     atomics and the result is deterministic.
// It runs the products on the CUDA cores in f32, a dense 64-row product for
// every tap that has any neighbour in the tile.
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
// Both instances split the output rows into chunks of whole row tiles (the
// wrapper's plan, ops/sparse_conv.k6_plan); one block per (tap, chunk)
// writes its chunk's partial cin x cout sum, and a second kernel adds the
// chunks in chunk order. No float atomics: a rerun is bit-identical.
//
// bf16 (`sparse_conv_wgrad_tc_kernel<CIN, COUT>`): a gathered GEMM on the
// tensor cores, per tap M = cin, N = cout, summed over the output rows.
//   * the grid is (tap, chunk) with the tap fastest, so the K blocks that
//     read the same rows' map entries and g rows run together and share L2;
//   * the block walks its chunk one tile of 128 rows (64 where cin + cout >
//     128) at a time. Each of the first 128 threads holds the next tile's
//     map entry of its row at the block's tap, loaded one tile ahead; a tile
//     with no neighbour at the tap is skipped (a block-wide OR);
//   * an active tile's feature rows (gathered) and g rows are copied into
//     shared memory in bf16 with 16-byte cp.async, zero-filled (src-size 0)
//     where nbr = -1 or nbr >= n_in; rows are padded by 16 bytes so that
//     ldmatrix is free of bank conflicts. Two stages: tile t+1's copies are
//     in flight while tile t's products run;
//   * A = X^T is read from the [rows][cin] stage with ldmatrix.trans, B = g
//     from the [rows][cout] stage with ldmatrix.trans; products are bf16
//     mma.sync m16n8k16 with f32 sums in registers. The 4 warps split the
//     cin x cout tile into warp tiles of up to 64 x 64 and, where fewer than
//     4 warp tiles cover it, also the rows of each tile; such warps' sums
//     are added in shared memory in warp order.
// What bounds it on an H100 (NVIDIA H100 80GB HBM3, 700 W, chip_smoke.py):
// at 64 and 128 channels the dense-tile mma work (every row of an active
// tile enters the product, as K4's tiles do: 1.8x the work of a LiDAR
// step's pairs), at 140-230 TFLOP/s; at 16 and 32 channels, at 22-72
// TFLOP/s, the row copies: each of a chunk's K blocks copies the tile's g
// rows and its own gathered rows through L2, and reads its map column (4
// bytes of each 108-byte map row). Left for later: one block for several
// taps (g staged once), a mask split of the rows, wgmma.
//
// f32 (`sparse_conv_wgrad_kernel<float, CIN, COUT>`), for the f32 steps and
// checks, on the CUDA cores: one block per (chunk, tap) walks its chunk 32
// rows at a time, skips a tile with no neighbour at its tap, gathers the
// tile's feature rows and g rows into shared memory with 16-byte loads, and
// adds their outer products into a cin x cout f32 tile held in registers (4
// output channels x 1-16 input channels a thread; with fewer than 256
// threads' worth of tile, groups of threads take alternate rows and are
// summed in group order at the end).
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

// 16 bytes at p (4 floats)
__device__ __forceinline__ void load16(const float* p, float* dst) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
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

int launch_f32(const void* feats, const int* nbr, const void* w, const float* bias,
               void* out, int n_in, int n_out, int K, int cin, int cout,
               cudaStream_t stream) {
  const dim3 grid((n_out + kTile - 1) / kTile);
  const dim3 block(kThreads);
  const float* f = static_cast<const float*>(feats);
  const float* wt = static_cast<const float*>(w);
  float* o = static_cast<float*>(out);
  switch (cout) {
    case 16:
      sparse_conv_fwd_kernel<float, 16><<<grid, block, 0, stream>>>(f, nbr, wt, bias, o, n_in, n_out, K, cin);
      break;
    case 32:
      sparse_conv_fwd_kernel<float, 32><<<grid, block, 0, stream>>>(f, nbr, wt, bias, o, n_in, n_out, K, cin);
      break;
    case 64:
      sparse_conv_fwd_kernel<float, 64><<<grid, block, 0, stream>>>(f, nbr, wt, bias, o, n_in, n_out, K, cin);
      break;
    case 128:
      sparse_conv_fwd_kernel<float, 128><<<grid, block, 0, stream>>>(f, nbr, wt, bias, o, n_in, n_out, K, cin);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// ---- bf16: the gathered implicit GEMM on the tensor cores -------------------

constexpr int kTcWarps = 4;
constexpr int kTcThreads = 32 * kTcWarps;
constexpr int kTcWarpRows = 32;                  // output rows a warp owns (two m16 tiles)
constexpr int kTcRows = kTcWarps * kTcWarpRows;  // output rows a block owns
constexpr int kTcMaxKc = 64;                     // input channels a pipeline step stages
constexpr int kTcStages = 2;

// input channels a step stages: the largest of 64, 32, 16 that divides cin
__host__ __device__ constexpr int tc_chunk(int cin) {
  return cin % 64 == 0 ? 64 : (cin % 32 == 0 ? 32 : 16);
}

// dynamic shared memory of one instance: two stages of (A [rows][kc + 8],
// B [kc][cout + 8], or [cout][kc + 8] for w_layout 1), and the epilogue's
// [rows][cout + 8] tile, which reuses them
template <int COUT, bool WT>
__host__ __device__ constexpr int tc_smem_bytes(int kc) {
  const int a = kTcRows * (kc + 8);
  const int b = WT ? COUT * (kc + 8) : kc * (COUT + 8);
  const int pipe = kTcStages * (a + b) * 2;
  const int epi = kTcRows * (COUT + 8) * 2;
  return pipe > epi ? pipe : epi;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared; zero-filled (nothing read) if !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

// wait until at most N of this thread's copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// WT: w is [K, COUT, cin] (the untransposed weight of the conv whose input
// gradient this is) and is read as its transpose; else w is [K, cin, COUT].
template <int COUT, bool WT>
__global__ void __launch_bounds__(kTcThreads)
    sparse_conv_tc_kernel(const __nv_bfloat16* __restrict__ feats,
                          const int* __restrict__ nbr,
                          const __nv_bfloat16* __restrict__ w,
                          const float* __restrict__ bias,
                          __nv_bfloat16* __restrict__ out, int n_in, int n_out,
                          int K, int cin) {
  constexpr int kNT = COUT / 8;   // n8 tiles of a warp
  constexpr int kBS = COUT + 8;   // staged row of W_k (w_layout 0) and of the output tile
  constexpr int kMT = kTcWarpRows / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_nbr[kTcRows * kMaxTaps];
  __shared__ unsigned s_mask;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const long long row0 = (long long)blockIdx.x * kTcRows;
  const int kc = tc_chunk(cin);
  const int lg_pr = kc == 64 ? 3 : (kc == 32 ? 2 : 1);  // log2 of the 16-byte pieces of a staged row
  const int nch = cin / kc;
  const int as = kc + 8;  // staged row of A (and of W_k^T for w_layout 1)
  const int a_elems = kTcRows * as;
  const int b_elems = WT ? COUT * as : kc * kBS;
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + kTcStages * a_elems;

  // the tile's map, and the taps with any neighbour in the tile; all of a
  // thread's loads are in flight before any is used
  constexpr int kNbrPer = kTcRows * kMaxTaps / kTcThreads;
  if (tid == 0) s_mask = 0u;
  const long long base = row0 * K;
  const long long end = (long long)n_out * K;
  int v[kNbrPer];
#pragma unroll
  for (int j = 0; j < kNbrPer; ++j) {
    const int i = tid + j * kTcThreads;
    v[j] = (i < kTcRows * K && base + i < end) ? __ldg(nbr + base + i) : -1;
  }
  unsigned mine = 0u;
  int col = tid % K;  // tap of entry tid + j * kTcThreads
  const int col_step = kTcThreads % K;
#pragma unroll
  for (int j = 0; j < kNbrPer; ++j) {
    const int i = tid + j * kTcThreads;
    const int x = v[j] < n_in ? v[j] : -1;
    if (i < kTcRows * K) s_nbr[i] = x;
    if (x >= 0) mine |= 1u << col;
    col += col_step;
    if (col >= K) col -= K;
  }
  __syncthreads();
  mine = __reduce_or_sync(0xffffffffu, mine);
  if (lane == 0 && mine) atomicOr(&s_mask, mine);
  __syncthreads();
  const unsigned mask = s_mask;
  const int steps = __popc(mask) * nch;

  // stage step (tap, c0) into buffer buf
  auto load_step = [&](int tap, int c0, int buf) {
    const int pr = 1 << lg_pr;
    const uint32_t a = smem_addr(sA + buf * a_elems);
    for (int i = tid; i < kTcRows * pr; i += kTcThreads) {
      const int r = i >> lg_pr, p = i & (pr - 1);
      const int src = s_nbr[r * K + tap];
      const __nv_bfloat16* g = feats + (long long)(src >= 0 ? src : 0) * cin + c0 + p * 8;
      cp_async16(a + (r * as + p * 8) * 2, g, src >= 0);
    }
    const uint32_t b = smem_addr(sB + buf * b_elems);
    if constexpr (WT) {  // row n of W_k^T: w[tap, n, c0:c0+kc]
      for (int i = tid; i < COUT * pr; i += kTcThreads) {
        const int n = i >> lg_pr, p = i & (pr - 1);
        cp_async16(b + (n * as + p * 8) * 2, w + ((long long)tap * COUT + n) * cin + c0 + p * 8, true);
      }
    } else {  // row j of W_k's slice: w[tap, c0 + j, :]
      for (int i = tid; i < kc * (COUT / 8); i += kTcThreads) {
        const int j = i / (COUT / 8), p = i - j * (COUT / 8);
        cp_async16(b + (j * kBS + p * 8) * 2, w + ((long long)tap * cin + c0 + j) * COUT + p * 8, true);
      }
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  // the load cursor walks the active taps in increasing order, nch chunks each
  unsigned rest = mask;
  int tap = 0, c0 = cin;
  auto load_next = [&](int step) {
    if (c0 + kc < cin) {
      c0 += kc;
    } else {
      c0 = 0;
      tap = __ffs(rest) - 1;
      rest &= rest - 1;
    }
    load_step(tap, c0, step % kTcStages);
  };
#pragma unroll
  for (int j = 0; j < kTcStages - 1; ++j) {
    if (j < steps) load_next(j);
    cp_async_commit();
  }
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kTcStages - 2>();  // step s's copies have landed
    __syncthreads();                 // ... for every thread, and step s-1's buffer is free
    if (s + kTcStages - 1 < steps) load_next(s + kTcStages - 1);
    cp_async_commit();
    const uint32_t a = smem_addr(sA + (s % kTcStages) * a_elems);
    const uint32_t b = smem_addr(sB + (s % kTcStages) * b_elems);
#pragma unroll
    for (int kk = 0; kk < kTcMaxKc / 16; ++kk) {
      if (kk * 16 >= kc) break;
      uint32_t af[kMT][4];
#pragma unroll
      for (int mi = 0; mi < kMT; ++mi) {
        const int r = warp * kTcWarpRows + mi * 16 + (lane & 15);
        ldmatrix_x4(af[mi], a + (r * as + kk * 16 + (lane >> 4) * 8) * 2);
      }
#pragma unroll
      for (int np = 0; np < kNT / 2; ++np) {
        // matrices: (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
        uint32_t bf[4];
        if constexpr (WT) {
          const int n = np * 16 + (lane >> 4) * 8 + (lane & 7);
          ldmatrix_x4(bf, b + (n * as + kk * 16 + ((lane >> 3) & 1) * 8) * 2);
        } else {
          const int k = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
          ldmatrix_x4_trans(bf, b + (k * kBS + np * 16 + (lane >> 4) * 8) * 2);
        }
#pragma unroll
        for (int mi = 0; mi < kMT; ++mi) {
          mma_bf16(acc[mi][2 * np], af[mi], bf[0], bf[1]);
          mma_bf16(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // every warp is done with the stages, which the epilogue reuses

  // epilogue: + bias in f32, one rounding, the tile staged for 16-byte stores
  __nv_bfloat16* so = reinterpret_cast<__nv_bfloat16*>(smem);
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int ni = 0; ni < kNT; ++ni) {
    const int c = ni * 8 + 2 * tig;
    const float b0 = bias != nullptr ? bias[c] : 0.f;
    const float b1 = bias != nullptr ? bias[c + 1] : 0.f;
#pragma unroll
    for (int mi = 0; mi < kMT; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = warp * kTcWarpRows + mi * 16 + gid + 8 * h;
        *reinterpret_cast<__nv_bfloat162*>(so + r * kBS + c) =
            __floats2bfloat162_rn(acc[mi][ni][2 * h] + b0, acc[mi][ni][2 * h + 1] + b1);
      }
    }
  }
  __syncthreads();
  for (int i = tid; i < kTcRows * (COUT / 8); i += kTcThreads) {
    const int r = i / (COUT / 8), p = i - r * (COUT / 8);
    const long long row = row0 + r;
    if (row < n_out)
      *reinterpret_cast<uint4*>(out + row * COUT + p * 8) =
          *reinterpret_cast<const uint4*>(so + r * kBS + p * 8);
  }
}

template <int COUT, bool WT>
int launch_tc_inst(const void* feats, const int* nbr, const void* w, const float* bias,
                   void* out, int n_in, int n_out, int K, int cin, cudaStream_t stream) {
  // once per instance: allow the most dynamic shared memory it can ask for
  static const cudaError_t attr = cudaFuncSetAttribute(
      sparse_conv_tc_kernel<COUT, WT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      tc_smem_bytes<COUT, WT>(kTcMaxKc));
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((n_out + kTcRows - 1) / kTcRows));
  sparse_conv_tc_kernel<COUT, WT><<<grid, kTcThreads, tc_smem_bytes<COUT, WT>(tc_chunk(cin)), stream>>>(
      static_cast<const __nv_bfloat16*>(feats), nbr, static_cast<const __nv_bfloat16*>(w), bias,
      static_cast<__nv_bfloat16*>(out), n_in, n_out, K, cin);
  return (int)cudaGetLastError();
}

template <bool WT>
int launch_tc(const void* feats, const int* nbr, const void* w, const float* bias,
              void* out, int n_in, int n_out, int K, int cin, int cout,
              cudaStream_t stream) {
  switch (cout) {
    case 16:
      return launch_tc_inst<16, WT>(feats, nbr, w, bias, out, n_in, n_out, K, cin, stream);
    case 32:
      return launch_tc_inst<32, WT>(feats, nbr, w, bias, out, n_in, n_out, K, cin, stream);
    case 64:
      return launch_tc_inst<64, WT>(feats, nbr, w, bias, out, n_in, n_out, K, cin, stream);
    case 128:
      return launch_tc_inst<128, WT>(feats, nbr, w, bias, out, n_in, n_out, K, cin, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

constexpr int kWRows = 32;  // output rows K6's f32 block stages per step

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

// ---- K6 bf16: the gathered GEMM on the tensor cores -------------------------

// One instance's shape: output rows a pipeline step stages (`k6_tile_rows` in
// ops/sparse_conv.py), a warp's tile of dW (kWM x kWN), how many warps split
// the rows of a step, and the dynamic shared memory: two stages of
// [rows][cin + 8] and [rows][cout + 8] bf16, or the warps' [split][cin][cout
// + 8] f32 sums, which reuse them.
template <int CIN, int COUT>
struct WgradTc {
  static constexpr int kRows = CIN + COUT > 128 ? 64 : 128;
  static constexpr int kWM = CIN < 64 ? CIN : 64;
  static constexpr int kWN = COUT < 64 ? COUT : 64;
  static constexpr int kSplit = kTcWarps / ((CIN / kWM) * (COUT / kWN));
  static constexpr int kAS = CIN + 8, kBS = COUT + 8, kRS = COUT + 8;
  static constexpr int kPipe = kTcStages * kRows * (kAS + kBS) * 2;
  static constexpr int kRed = kSplit * CIN * kRS * 4;
  static constexpr int kSmem = kPipe > kRed ? kPipe : kRed;
  static_assert(kSplit >= 1 && (kRows / 16) % kSplit == 0, "warp split");
};

// One staged tile's products into a warp's sums: its kWM x kWN tile of dW at
// (m0, n0), over the k16 steps wk, wk + kSplit, ... of the tile's rows. A =
// X^T from the [rows][cin] stage a, B = g from the [rows][cout] stage b.
template <typename P, int MT, int NT>
__device__ __forceinline__ void wgrad_tile_mma(float (&acc)[MT][NT][4], uint32_t a, uint32_t b,
                                               int m0, int n0, int wk, int lane) {
#pragma unroll
  for (int j = 0; j < P::kRows / 16 / P::kSplit; ++j) {
    const int kk = j * P::kSplit + wk;
    uint32_t af[MT][4];
#pragma unroll
    for (int mi = 0; mi < MT; ++mi) {
      // matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15), (m 8-15,
      // k 8-15), each stored as 8 rows (k) of 8 input channels (m)
      const int r = kk * 16 + (lane >> 4) * 8 + (lane & 7);
      ldmatrix_x4_trans(af[mi], a + (r * P::kAS + m0 + mi * 16 + ((lane >> 3) & 1) * 8) * 2);
    }
#pragma unroll
    for (int np = 0; np < NT / 2; ++np) {
      // matrices (k 0-7, n 0-7), (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15)
      uint32_t bf[4];
      const int r = kk * 16 + ((lane >> 3) & 1) * 8 + (lane & 7);
      ldmatrix_x4_trans(bf, b + (r * P::kBS + n0 + np * 16 + (lane >> 4) * 8) * 2);
#pragma unroll
      for (int mi = 0; mi < MT; ++mi) {
        mma_bf16(acc[mi][2 * np], af[mi], bf[0], bf[1]);
        mma_bf16(acc[mi][2 * np + 1], af[mi], bf[2], bf[3]);
      }
    }
  }
}

template <int CIN, int COUT>
__global__ void __launch_bounds__(kTcThreads)
    sparse_conv_wgrad_tc_kernel(const __nv_bfloat16* __restrict__ feats,
                                const __nv_bfloat16* __restrict__ g,
                                const int* __restrict__ nbr,
                                float* __restrict__ partial, int n_in, int n_out,
                                int K, int rows_per_chunk) {
  using P = WgradTc<CIN, COUT>;
  constexpr int T = P::kRows;
  constexpr int kMT = P::kWM / 16, kNT = P::kWN / 8;
  constexpr int kAP = CIN / 8, kBP = COUT / 8;  // 16-byte pieces of a feature row, of a g row
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int s_src[2][T];  // map entries of the tile being staged, by tile parity
  __nv_bfloat16* sA = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* sB = sA + kTcStages * T * P::kAS;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wk = warp % P::kSplit, wt = warp / P::kSplit;
  const int m0 = wt / (COUT / P::kWN) * P::kWM, n0 = wt % (COUT / P::kWN) * P::kWN;
  const int k = blockIdx.x;
  const long long r0 = (long long)blockIdx.y * rows_per_chunk;
  const long long r1 = min(r0 + rows_per_chunk, (long long)n_out);

  // thread tid's map entry at tap k for row base + tid of a tile: -1 for no
  // neighbour, an input past n_in, a row past the chunk or tid >= T
  auto entry = [&](long long base) {
    int v = -1;
    if (tid < T && base + tid < r1) v = __ldg(nbr + (base + tid) * K + k);
    return v >= 0 && v < n_in ? v : -1;
  };
  // copy the tile at base (map entries src) into stage buf; zeros where src < 0.
  // The copy loops stay rolled: unrolled, they cost registers (ptxas: 214 at
  // 128 x 128 and spills at 16 x 64 and 16 x 128; rolled, 166 and none).
  auto stage = [&](long long base, const int* src, int buf) {
    const uint32_t a = smem_addr(sA + buf * T * P::kAS);
#pragma unroll 1
    for (int i = tid; i < T * kAP; i += kTcThreads) {
      const int r = i / kAP, p = i % kAP;
      const int s = src[r];
      cp_async16(a + (r * P::kAS + p * 8) * 2, feats + (long long)(s >= 0 ? s : 0) * CIN + p * 8, s >= 0);
    }
    const uint32_t b = smem_addr(sB + buf * T * P::kBS);
#pragma unroll 1
    for (int i = tid; i < T * kBP; i += kTcThreads) {
      const int r = i / kBP, p = i % kBP;
      const bool ok = src[r] >= 0;  // then base + r < r1
      cp_async16(b + (r * P::kBS + p * 8) * 2, g + (ok ? base + r : 0) * COUT + p * 8, ok);
    }
  };

  float acc[kMT][kNT][4];
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  int next = entry(r0);
  int buf = 0, ready = -1;  // ready: the stage whose tile's products are still to run
  int par = 0;
  for (long long base = r0; base < r1; base += T, par ^= 1) {
    const int v = next;
    if (tid < T) s_src[par][tid] = v;
    next = entry(base + T);  // in flight while this tile is staged and the last one multiplied
    if (!__syncthreads_or(v >= 0)) continue;  // no neighbour at tap k in the tile
    stage(base, s_src[par], buf);
    cp_async_commit();
    if (ready >= 0) {
      cp_async_wait<1>();  // the ready stage's copies have landed
      __syncthreads();     // ... for every thread
      wgrad_tile_mma<P>(acc, smem_addr(sA + ready * T * P::kAS), smem_addr(sB + ready * T * P::kBS),
                        m0, n0, wk, lane);
    }
    ready = buf;
    buf ^= 1;
  }
  if (ready >= 0) {
    cp_async_wait<0>();
    __syncthreads();
    wgrad_tile_mma<P>(acc, smem_addr(sA + ready * T * P::kAS), smem_addr(sB + ready * T * P::kBS),
                      m0, n0, wk, lane);
  }
  __syncthreads();  // every warp is done with the stages, which the sums reuse

  // the warps' sums into shared memory, then added in warp order and stored
  float* red = reinterpret_cast<float*>(smem);
  const int gid = lane >> 2, tig = lane & 3;
#pragma unroll
  for (int mi = 0; mi < kMT; ++mi)
#pragma unroll
    for (int ni = 0; ni < kNT; ++ni)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ci = m0 + mi * 16 + gid + 8 * h, co = n0 + ni * 8 + 2 * tig;
        *reinterpret_cast<float2*>(red + (wk * CIN + ci) * P::kRS + co) =
            make_float2(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
  __syncthreads();
  float* out = partial + ((long long)blockIdx.y * K + k) * CIN * COUT;
  for (int i = tid; i < CIN * COUT; i += kTcThreads) {
    const int ci = i / COUT, co = i % COUT;
    float s = red[ci * P::kRS + co];
#pragma unroll
    for (int q = 1; q < P::kSplit; ++q) s += red[(q * CIN + ci) * P::kRS + co];
    out[i] = s;
  }
}

// once per instance: allow the dynamic shared memory it needs above 48 KB
template <int CIN, int COUT>
cudaError_t wgrad_tc_prepare() {
  constexpr int bytes = WgradTc<CIN, COUT>::kSmem;
  if constexpr (bytes > 48 * 1024) {
    static const cudaError_t attr = cudaFuncSetAttribute(
        sparse_conv_wgrad_tc_kernel<CIN, COUT>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    return attr;
  } else {
    return cudaSuccess;
  }
}

// F::run<CIN, COUT>(args...) for the instance of (cin, cout), each one of 16,
// 32, 64, 128; cudaErrorInvalidValue for any other width
template <typename F, int CIN, typename... A>
int for_cout(int cout, A... a) {
  switch (cout) {
    case 16: return F::template run<CIN, 16>(a...);
    case 32: return F::template run<CIN, 32>(a...);
    case 64: return F::template run<CIN, 64>(a...);
    case 128: return F::template run<CIN, 128>(a...);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename F, typename... A>
int for_widths(int cin, int cout, A... a) {
  switch (cin) {
    case 16: return for_cout<F, 16>(cout, a...);
    case 32: return for_cout<F, 32>(cout, a...);
    case 64: return for_cout<F, 64>(cout, a...);
    case 128: return for_cout<F, 128>(cout, a...);
    default: return (int)cudaErrorInvalidValue;
  }
}

struct WgradLaunch {
  template <int CIN, int COUT>
  static int run(const void* feats, const void* g, const int* nbr, float* partial, int n_in,
                 int n_out, int K, int chunks, int rows_per_chunk, int dtype, cudaStream_t s) {
    if (dtype == 0) {
      if (rows_per_chunk % kWRows) return (int)cudaErrorInvalidValue;
      sparse_conv_wgrad_kernel<float, CIN, COUT><<<dim3(chunks, K), kThreads, 0, s>>>(
          static_cast<const float*>(feats), static_cast<const float*>(g), nbr, partial, n_in, n_out,
          K, rows_per_chunk);
    } else {
      using P = WgradTc<CIN, COUT>;
      if (rows_per_chunk % P::kRows) return (int)cudaErrorInvalidValue;
      const cudaError_t attr = wgrad_tc_prepare<CIN, COUT>();
      if (attr != cudaSuccess) return (int)attr;
      sparse_conv_wgrad_tc_kernel<CIN, COUT><<<dim3(K, chunks), kTcThreads, P::kSmem, s>>>(
          static_cast<const __nv_bfloat16*>(feats), static_cast<const __nv_bfloat16*>(g), nbr,
          partial, n_in, n_out, K, rows_per_chunk);
    }
    return (int)cudaGetLastError();
  }
};

struct WgradOccupancy {
  template <int CIN, int COUT>
  static int run(int* blocks) {
    const cudaError_t attr = wgrad_tc_prepare<CIN, COUT>();
    if (attr != cudaSuccess) return (int)attr;
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, sparse_conv_wgrad_tc_kernel<CIN, COUT>, kTcThreads, WgradTc<CIN, COUT>::kSmem);
  }
};

}  // namespace

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel). cin a multiple of 16, cout one of 16, 32, 64, 128, K <= 27; bias
// may be null. w_layout 0: w is [K, cin, cout]; 1 (bfloat16 only): w is
// [K, cout, cin] and is read as its transpose.
extern "C" int sparse_conv_fwd(const void* feats, const int* nbr, const void* w,
                               const float* bias, void* out, int n_in,
                               int n_out, int K, int cin, int cout, int dtype,
                               int w_layout, void* stream) {
  if (K < 1 || K > kMaxTaps || cin < 16 || cin % 16 != 0) return (int)cudaErrorInvalidValue;
  if (w_layout != 0 && (w_layout != 1 || dtype != 1)) return (int)cudaErrorInvalidValue;
  if (n_out <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_f32(feats, nbr, w, bias, out, n_in, n_out, K, cin, cout, s);
  if (dtype == 1) {
    return w_layout ? launch_tc<true>(feats, nbr, w, bias, out, n_in, n_out, K, cin, cout, s)
                    : launch_tc<false>(feats, nbr, w, bias, out, n_in, n_out, K, cin, cout, s);
  }
  return (int)cudaErrorInvalidValue;
}

// dtype: 0 = float32 (the CUDA-core kernel), 1 = bfloat16 (the tensor-core
// kernel). cin and cout each one of 16, 32, 64, 128, K <= 27. The rows are
// split into `chunks` (at most 65535) chunks of rows_per_chunk rows, a whole
// number of tiles (32 rows in float32, `k6_tile_rows` in bfloat16), with
// chunks * rows_per_chunk >= n_out; partial is scratch of chunks * K * cin *
// cout floats, dw receives K * cin * cout floats.
extern "C" int sparse_conv_wgrad(const void* feats, const void* g, const int* nbr,
                                 float* partial, float* dw, int n_in, int n_out,
                                 int K, int cin, int cout, int chunks, int rows_per_chunk,
                                 int dtype, void* stream) {
  if (K < 1 || K > kMaxTaps || chunks < 1 || chunks > 65535 || rows_per_chunk < 1 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (n_out <= 0) return 0;
  if ((long long)chunks * rows_per_chunk < n_out) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = for_widths<WgradLaunch>(cin, cout, feats, g, nbr, partial, n_in, n_out, K, chunks,
                                          rows_per_chunk, dtype, s);
  if (err != 0) return err;
  const long long n = (long long)K * cin * cout;
  sparse_conv_wgrad_reduce_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(partial, dw, chunks, n);
  return (int)cudaGetLastError();
}

// the blocks of K6's bfloat16 instance for (cin, cout) that one SM holds at
// once, into *blocks
extern "C" int sparse_conv_wgrad_blocks_per_sm(int cin, int cout, int* blocks) {
  return for_widths<WgradOccupancy>(cin, cout, blocks);
}
