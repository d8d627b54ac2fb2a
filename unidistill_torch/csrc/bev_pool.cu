// K1 bev_pool_fwd: fused depth x context BEV pooling (forward), as a
// deterministic interval reduce over a cell-sorted plan.
//
// Replaces the Pallas `_pool_kernel` / `_bev_pool_scatter_pallas` of the JAX
// package (unidistill_tpu/ops/bev_pool.py:158,177), which holds the whole
// BEV accumulator in VMEM and walks the frustum points one by one.
//
//   out[b, cell[p], c] += depth[p] * ctx[b, ray(p), c]
//
// over every frustum point p = (b, n, d, h, w); ray(p) = (b, n, h, w). The
// [points, C] depth x context product is never written to device memory.
//
// The plan (`ops/bev_pool.bev_pool_plan`, plain PyTorch on the card) numbers
// the points ray-major, q = ray * D + d, and sorts them stably by output row
// b * ncells + cell: `order` lists the in-grid points row by row, ray and
// then depth bin ascending inside a row, and the points of row k are
// order[offsets[k] .. offsets[k+1]). Points outside the grid sort past
// offsets[B * ncells] and are never read.
//
// What bounds it on an H100: at B = 4 the function moves 165 MB (17.3 MB of
// context, 7.6 MB each of depth and cells, 132.7 MB of output), 0.0493 ms at
// 3.35 TB/s. The design:
//   * one warp per output row (b, cell), over every row: each lane keeps 8
//     channels per chunk of 256 in registers;
//   * the warp loads 32 of its points at once (one `order` entry and one
//     depth value per lane) and walks them through shuffles; it sums the
//     depth of a run of points of one ray in a scalar and, when the ray
//     changes, adds that sum times the ray's context row to its registers:
//     one coalesced 1 KB row read per (row, ray) run, from L2 (the context
//     fits the 50 MB L2);
//   * it writes its output row once, zeros for an empty row: no float
//     atomics, no memset, and every sum in a fixed order, so the result is
//     bit-identical from run to run.
// It sums (sum_d depth) * ctx where the plain version sums depth * ctx: the
// two differ by float32 round-off.
//
// The launch allocates nothing and runs on the caller's stream; it writes
// every element of out.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kPerLane = 8;            // channels per lane per chunk
constexpr int kChunk = 32 * kPerLane;  // 256 channels per chunk
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ void add_row(float* acc, const float* __restrict__ ctx_row,
                                        float w, int c0, int C, int lane) {
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    int c = c0 + k * 32 + lane;
    if (c < C) acc[k] += w * ctx_row[c];
  }
}

__global__ void bev_pool_fwd_kernel(const long long* __restrict__ order,
                                    const long long* __restrict__ offsets,
                                    const float* __restrict__ depth,
                                    const float* __restrict__ ctx,
                                    float* __restrict__ out, int n_rows, int D,
                                    int HW, int C) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (row >= n_rows) return;
  const long long begin = offsets[row];
  const long long end = offsets[row + 1];
  float* __restrict__ out_row = out + (long long)row * C;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    float acc[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;
    long long run = -1;  // ray of the run summed in w_run, -1 for none
    float w_run = 0.f;
    for (long long i0 = begin; i0 < end; i0 += 32) {
      const int n = (int)min(32LL, end - i0);
      long long my_ray = 0;
      float my_w = 0.f;
      if (lane < n) {
        const long long q = order[i0 + lane];
        my_ray = q / D;
        const long long d = q - my_ray * D;
        const long long cam = my_ray / HW;  // b * NC + n
        const long long hw = my_ray - cam * HW;
        my_w = depth[(cam * D + d) * HW + hw];
      }
      for (int j = 0; j < n; ++j) {
        const long long ray = __shfl_sync(kFull, my_ray, j);
        const float w = __shfl_sync(kFull, my_w, j);
        if (ray != run) {
          if (run >= 0) add_row(acc, ctx + run * C, w_run, c0, C, lane);
          run = ray;
          w_run = 0.f;
        }
        w_run += w;
      }
    }
    if (run >= 0) add_row(acc, ctx + run * C, w_run, c0, C, lane);
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      int c = c0 + k * 32 + lane;
      if (c < C) out_row[c] = acc[k];
    }
  }
}

// K5 bev_pool_bwd: the backward of K1, both gradients in one pass.
//
// Replaces the backward `_pool_bwd` of the JAX package's custom VJP
// `bev_pool_outer_pallas` (unidistill_tpu/ops/bev_pool.py:229,282), which
// differentiates the XLA scatter into a gather:
//
//   g_depth[p]     = <g[b, cell[p], :], ctx[b, ray(p), :]>  (0 outside the grid)
//   g_ctx[ray, :]  = sum over the ray's points p in the grid of depth[p] * g[b, cell[p], :]
//
// One warp per ray (it reads the cells in the JAX layout, not K1's plan):
// the ray's context (8 values per lane per chunk of 256 channels) and its
// g_ctx sums stay in registers across its D depth bins. A point's g row is
// loaded once (16-byte-coalesced 128-byte rows per k) and serves both the
// warp-reduced dot product and the g_ctx sum; a run of equal cells along
// the ray reuses the loaded row. Every output element is written by the one
// warp that owns its ray, with no atomics: the result is deterministic.
// With C > 256 the ray's g_depth is summed over the chunks by lane 0 of
// that warp, in chunk order.
//
// What bounds it on an H100: at B = 4 the function moves 190 MB (g is
// 132.7 MB of it), 0.0567 ms at 3.35 TB/s, and its FMAs are few (1.5 M
// valid points x 2 x 256, 23 us at 67 TFLOP/s f32); the gathered g rows (up
// to 1 KB per point before L2 reuse; g does not fit the 50 MB L2) are what
// hold it back.
//
// The launch allocates nothing and runs on the caller's stream; it writes
// every element of g_depth and g_ctx.
__global__ void bev_pool_bwd_kernel(const int* __restrict__ cell,
                                    const float* __restrict__ depth,
                                    const float* __restrict__ ctx,
                                    const float* __restrict__ g,
                                    float* __restrict__ g_depth,
                                    float* __restrict__ g_ctx, int n_rays,
                                    int rays_per_batch, int D, int HW, int C,
                                    int ncells) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ray >= n_rays) return;
  const int cam = ray / HW;
  const int hw = ray - cam * HW;
  const long long b = ray / rays_per_batch;
  const float* __restrict__ ctx_row = ctx + (long long)ray * C;
  float* __restrict__ gctx_row = g_ctx + (long long)ray * C;
  const long long pbase = (long long)cam * D * HW + hw;
  const float* __restrict__ g_b = g + b * (long long)ncells * C;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    float v[kPerLane];
    float acc[kPerLane];
    float row[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      int c = c0 + k * 32 + lane;
      v[k] = c < C ? ctx_row[c] : 0.f;
      acc[k] = 0.f;
      row[k] = 0.f;
    }
    int run = -1;  // cell whose g row is in `row`, -1 for none
    for (int d = 0; d < D; ++d) {
      const long long p = pbase + (long long)d * HW;
      const int q = cell[p];
      if (q < 0 || q >= ncells) {
        if (c0 == 0 && lane == 0) g_depth[p] = 0.f;
        continue;
      }
      if (q != run) {
        const float* __restrict__ g_row = g_b + (long long)q * C;
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) {
          int c = c0 + k * 32 + lane;
          row[k] = c < C ? g_row[c] : 0.f;
        }
        run = q;
      }
      const float w = depth[p];
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) {
        dot += row[k] * v[k];
        acc[k] += w * row[k];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) g_depth[p] = c0 == 0 ? dot : g_depth[p] + dot;
    }
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      int c = c0 + k * 32 + lane;
      if (c < C) gctx_row[c] = acc[k];
    }
  }
}

}  // namespace

extern "C" int bev_pool_bwd(const int* cell, const float* depth,
                            const float* ctx, const float* g, float* g_depth,
                            float* g_ctx, int n_rays, int rays_per_batch, int D,
                            int HW, int C, int ncells, void* stream) {
  if (n_rays <= 0) return 0;
  dim3 block(32 * kWarpsPerBlock);
  dim3 grid((n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock);
  bev_pool_bwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      cell, depth, ctx, g, g_depth, g_ctx, n_rays, rays_per_batch, D, HW, C,
      ncells);
  return (int)cudaGetLastError();
}

extern "C" int bev_pool_fwd(const long long* order, const long long* offsets,
                            const float* depth, const float* ctx, float* out,
                            int n_rows, int D, int HW, int C, void* stream) {
  if (n_rows <= 0) return 0;
  dim3 block(32 * kWarpsPerBlock);
  dim3 grid((n_rows + kWarpsPerBlock - 1) / kWarpsPerBlock);
  bev_pool_fwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      order, offsets, depth, ctx, out, n_rows, D, HW, C);
  return (int)cudaGetLastError();
}
