// K1 bev_pool_fwd: fused depth x context BEV scatter-add (forward).
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
// What bounds it on an H100: the bytes are small (at B = 4: 17 MB of context,
// 7.6 MB of depth, 7.6 MB of cells, 33 MB of output, about 20 us at
// 3.35 TB/s), but the scatter is C float atomics per valid point (about 484 M
// at B = 4 if every point is in the grid), which the L2's atomic units
// serialise per address. The design cuts the atomics and the context reads:
//   * one warp per ray (b, n, h, w): the lanes load the ray's C context values
//     into registers once (8 per lane per chunk of 256 channels) and reuse
//     them for all D depth bins of the ray;
//   * neighbouring depth bins of one ray often fall into the same BEV cell, so
//     the warp sums a run of equal cells in registers and issues one atomic
//     per channel per run instead of one per point;
//   * points outside the grid (cell < 0 or >= ncells) are skipped; there are
//     no dump rows (the TPU kernel needed them only against a
//     read-modify-write hazard of its own pipeline).
// The atomics make the order of the sums vary from run to run: results agree
// with the plain version to float32 round-off, not bit for bit.
//
// The launch allocates nothing and runs on the caller's stream; the output
// must be zeroed by the caller.
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kPerLane = 8;            // channels per lane per chunk
constexpr int kChunk = 32 * kPerLane;  // 256 channels per chunk

__device__ __forceinline__ void flush(float* __restrict__ out_row,
                                      const float* acc, int c0, int C,
                                      int lane) {
#pragma unroll
  for (int k = 0; k < kPerLane; ++k) {
    int c = c0 + k * 32 + lane;
    if (c < C) atomicAdd(out_row + c, acc[k]);
  }
}

__global__ void bev_pool_fwd_kernel(const int* __restrict__ cell,
                                    const float* __restrict__ depth,
                                    const float* __restrict__ ctx,
                                    float* __restrict__ out, int n_rays,
                                    int rays_per_batch, int D, int HW, int C,
                                    int ncells) {
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (ray >= n_rays) return;
  const int cam = ray / HW;  // b * NC + n
  const int hw = ray - cam * HW;
  const long long b = ray / rays_per_batch;
  const float* __restrict__ ctx_row = ctx + (long long)ray * C;
  const long long pbase = (long long)cam * D * HW + hw;  // point (cam, d=0, hw)
  float* __restrict__ out_b = out + b * (long long)ncells * C;

  for (int c0 = 0; c0 < C; c0 += kChunk) {
    float v[kPerLane];
    float acc[kPerLane];
#pragma unroll
    for (int k = 0; k < kPerLane; ++k) {
      int c = c0 + k * 32 + lane;
      v[k] = c < C ? ctx_row[c] : 0.f;
      acc[k] = 0.f;
    }
    int run = -1;  // cell of the run summed in acc, -1 for none
    for (int d = 0; d < D; ++d) {
      const long long p = pbase + (long long)d * HW;
      const int q = cell[p];
      if (q < 0 || q >= ncells) continue;
      const float w = depth[p];
      if (q != run) {
        if (run >= 0) flush(out_b + (long long)run * C, acc, c0, C, lane);
#pragma unroll
        for (int k = 0; k < kPerLane; ++k) acc[k] = 0.f;
        run = q;
      }
#pragma unroll
      for (int k = 0; k < kPerLane; ++k) acc[k] += w * v[k];
    }
    if (run >= 0) flush(out_b + (long long)run * C, acc, c0, C, lane);
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
// The same shape as K1: one warp per ray, the ray's context (8 values per
// lane per chunk of 256 channels) and its g_ctx sums in registers across its
// D depth bins. A point's g row is loaded once (16-byte-coalesced 128-byte
// rows per k) and serves both the warp-reduced dot product and the g_ctx
// sum; a run of equal cells along the ray reuses the loaded row. Every
// output element is written by the one warp that owns its ray, with no
// atomics: the result is deterministic. With C > 256 the ray's g_depth is
// summed over the chunks by lane 0 of that warp, in chunk order.
//
// What bounds it on an H100: unique bytes are small (at B = 4 about 90 MB,
// 27 us at 3.35 TB/s) and the FMAs few (1.5 M valid points x 2 x 256, 23 us
// at 67 TFLOP/s f32); the gathered g rows (up to 1 KB per point before L2
// reuse; g is 33 MB and mostly fits the 50 MB L2) are what hold it back.
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

extern "C" int bev_pool_fwd(const int* cell, const float* depth,
                            const float* ctx, float* out, int n_rays,
                            int rays_per_batch, int D, int HW, int C,
                            int ncells, void* stream) {
  if (n_rays <= 0) return 0;
  dim3 block(32 * kWarpsPerBlock);
  dim3 grid((n_rays + kWarpsPerBlock - 1) / kWarpsPerBlock);
  bev_pool_fwd_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      cell, depth, ctx, out, n_rays, rays_per_batch, D, HW, C, ncells);
  return (int)cudaGetLastError();
}
