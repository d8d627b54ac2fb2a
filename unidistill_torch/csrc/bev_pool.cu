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

// K5 bev_pool_bwd: the backward of K1, both gradients in one pass, owned by
// camera columns.
//
// Replaces the backward `_pool_bwd` of the JAX package's custom VJP
// `bev_pool_outer_pallas` (unidistill_tpu/ops/bev_pool.py:230,282), which
// differentiates the XLA scatter into a gather:
//
//   g_depth[p]     = <g[b, cell[p], :], ctx[b, ray(p), :]>  (0 outside the grid)
//   g_ctx[ray, :]  = sum over the ray's points p in the grid of depth[p] * g[b, cell[p], :]
//
// What bounds it on an H100: at B = 4 the function moves 190 MB (g is
// 132.7 MB of it), 0.0567 ms at 3.35 TB/s; its FMAs are few (1.5 M valid
// points x 2 x 256, 23 us at 67 TFLOP/s f32). The design before (one warp
// per ray) read one 1 KB g row per run of equal cells along a ray: 1.32 M
// gathered rows, 1.35 GB through L2 from a g that does not fit the 50 MB
// L2. The rays of one image column of one camera share their BEV cell at
// each depth bin (a point's ego x-y follows its column u and depth d; the
// row v moves mostly its height), so this design reads each row about once
// per column, plus the 17.3 MB of context once. At full width its schedule
// gives 98 256 rows (101 MB) on the level nuScenes-like cameras and 180 652
// under the training image augmentation, whose rotation spreads a column's
// rays over several cells (`bev_pool_bwd_reads` in ops/bev_pool.py models
// the count). `tools/k5_variants.py` times the kernel without each of the
// mechanisms below.
//   * One block per two neighbouring camera columns (b, n, w) and
//     (b, n, w + 1); it walks 16 rays of each at once (all of them at full
//     width, more in further passes). Each half-warp owns a ray, and a
//     warp's two rays are the two columns' rays of one row h, so that its
//     cell, depth and g_depth accesses pair up in 32-byte sectors (the
//     per-point arrays have the column innermost: at one column a block
//     they cost a sector a value). The ray's context chunk (16 values per
//     lane per chunk of 256 channels) and its g_ctx sums stay in registers.
//     512 threads, 64 registers and 99 KB of shared memory at D = 112: two
//     blocks a SM.
//   * A schedule is built before the walk: the depth bins are split into
//     groups of consecutive bins whose rays' cells are all equal; each
//     group's distinct in-grid cells are its g rows, numbered in walk order.
//     The rows are cut into batches: the groups whose first row lies in
//     [16k, 16k + 16). The block's cell and depth loads are all in flight
//     at once (eight a thread).
//   * The rows stream through a ring of kRing rows in shared memory with
//     16-byte cp.async, one batch ahead of the walk (TMA cannot gather
//     rows); two barriers per batch, not one per depth bin.
//   * Four depth bins at a time, a half-warp sums its four dot products
//     with one transposed shuffle reduction (5 shuffles, not 16).
//   * Each ray sums its depth bins in ascending order, each dot product over
//     its chunk in a fixed order, and with C > 256 g_depth over the chunks
//     in chunk order. Every output element is written by the one warp that
//     owns its ray: no atomics, and reruns are bit-identical.
//
// The launch allocates nothing and runs on the caller's stream; it writes
// every element of g_depth and g_ctx.
constexpr int kCols = 2;                // neighbouring camera columns a block owns
constexpr int kRows = 16;               // rays of each column walked at once
constexpr int kSlots = kCols * kRows;   // a half-warp each: slot kCols * h + column
constexpr int kBwdWarps = kSlots / 2;
constexpr int kThreads = 32 * kBwdWarps;
constexpr int kBatchRows = 16;      // a batch: the groups whose first row is in [16k, 16k + 16)
// g rows in the shared-memory ring: two batches, each within 16 + kSlots rows
constexpr int kRing = 2 * kBatchRows + kSlots;

// batches of a pass at most, plus one
__host__ __device__ constexpr int bwd_batches(int D) { return D * kSlots / kBatchRows + 2; }

template <int BYTES>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// floats of K5's ring of g rows, which holds the pass's cells and the rows
// of each bin while the schedule is built
__host__ __device__ constexpr int bwd_ring_floats(int D) {
  return kRing * kChunk > 2 * D * kSlots ? kRing * kChunk : 2 * D * kSlots;
}

// bytes of K5's dynamic shared memory for D depth bins
__host__ __device__ constexpr long long bwd_smem_bytes(int D) {
  return 4LL * bwd_ring_floats(D)  // ring of g rows
         + 9LL * D * kSlots        // depth (f32) and rank (int8) of each point, g row of each load (int)
         + 4LL * (5 * D + 2 + bwd_batches(D));  // per bin: base, nrows, flag; per group: first bin,
                                                  // first row; first group of each batch
}

constexpr int kHalfPerLane = kChunk / 16;  // channels per lane of a half-warp per chunk

// channel of value k of lane l (0-15) of a half-warp in a chunk: VEC 4
// reads float4s, lane-contiguous (conflict-free shared loads); VEC 1 floats
template <int VEC>
__device__ __forceinline__ int chan(int k, int l) {
  return VEC == 4 ? (k >> 2) * 64 + l * 4 + (k & 3) : k * 16 + l;
}

// x = row[c .. c + VEC), zeros past len
template <int VEC>
__device__ __forceinline__ void load_values(float* x, const float* __restrict__ row, int c, int len) {
  if (VEC == 4) {
    const float4 t = c < len ? *reinterpret_cast<const float4*>(row + c) : make_float4(0.f, 0.f, 0.f, 0.f);
    x[0] = t.x, x[1] = t.y, x[2] = t.z, x[3] = t.w;
  } else {
    x[0] = c < len ? row[c] : 0.f;
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
bev_pool_bwd_kernel(const int* __restrict__ cell, const float* __restrict__ depth,
                    const float* __restrict__ ctx, const float* __restrict__ g,
                    float* __restrict__ g_depth, float* __restrict__ g_ctx, int NC, int D,
                    int fH, int fW, int C, int ncells) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* dep = ring + bwd_ring_floats(D);        // [D][kSlots] depth of each point
  int* rowsrc = reinterpret_cast<int*>(dep + D * kSlots);  // [D * kSlots] g row (b*ncells + cell) of each load
  int* base = rowsrc + D * kSlots;  // [D] number of the first row of the bin's group
  int* nrows = base + D;            // [D] distinct in-grid cells of the bin
  int* flag = nrows + D;            // [D] 1 where a group starts
  int* gfirst = flag + D;           // [D + 1] first bin of each group
  int* gbase = gfirst + D + 1;      // [D + 1] number of the group's first row
  int* bstart = gbase + D + 1;      // [bwd_batches(D)] first group of each batch
  signed char* rank = reinterpret_cast<signed char*>(bstart + bwd_batches(D));  // [D][kSlots], -1 outside
  int* qs = reinterpret_cast<int*>(ring);   // [D][kSlots] cells (-1 outside), while scheduling
  int* lrow = qs + D * kSlots;              // [D][kSlots] g rows of each bin's distinct cells, ditto
  __shared__ int n_groups, n_batches;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int col_groups = (fW + kCols - 1) / kCols;
  const int cam = blockIdx.x / col_groups;  // b * NC + n
  const int w0 = kCols * (blockIdx.x - cam * col_groups);  // the columns w0 .. w0 + kCols - 1 (if < fW)
  const long long HW = (long long)fH * fW;
  const long long cam_pts = (long long)cam * D * HW;
  const long long g_first_row = (long long)(cam / NC) * ncells;

  for (int h0 = 0; h0 < fH; h0 += kRows) {
    // ---- schedule: the pass's cells and depths, eight loads in flight a thread
    for (int i0 = 0; i0 < D * kSlots; i0 += 8 * kThreads) {
      int q[8];
      float dv[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads + tid, d = i / kSlots, j = i % kSlots;
        q[u] = -1;
        dv[u] = 0.f;
        if (i < D * kSlots && h0 + j / kCols < fH && w0 + j % kCols < fW) {
          const long long p = cam_pts + d * HW + (long long)(h0 + j / kCols) * fW + w0 + j % kCols;
          q[u] = cell[p];
          dv[u] = depth[p];
        }
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int i = i0 + u * kThreads + tid;
        if (i < D * kSlots) {
          qs[i] = q[u] >= 0 && q[u] < ncells ? q[u] : -1;
          dep[i] = dv[u];
        }
      }
    }
    __syncthreads();
    // one warp a depth bin, a lane a slot: the bin's distinct in-grid cells
    // by match, and whether any cell differs from the previous bin's
    for (int d = warp; d < D; d += kBwdWarps) {
      const bool slot_lane = lane < kSlots;
      const int q = slot_lane ? qs[d * kSlots + lane] : -1;
      const bool changed = __any_sync(kFull, slot_lane && (d == 0 || q != qs[(d - 1) * kSlots + lane]));
      const unsigned inside = __ballot_sync(kFull, q >= 0);
      int leader = -1;
      if (q >= 0) leader = __ffs(__match_any_sync(inside, q)) - 1;
      const unsigned leaders = __ballot_sync(kFull, q >= 0 && leader == lane);
      const int r = q >= 0 ? __popc(leaders & ((1u << leader) - 1)) : -1;
      if (slot_lane) rank[d * kSlots + lane] = (signed char)r;
      if (q >= 0 && leader == lane) lrow[d * kSlots + r] = (int)(g_first_row + q);
      if (lane == 0) {
        nrows[d] = __popc(leaders);
        flag[d] = changed;
      }
    }
    __syncthreads();
    // groups and row numbers: inclusive scans over the bins (warp 0)
    if (warp == 0) {
      int groups = 0, rows = 0;
      for (int d0 = 0; d0 < D; d0 += 32) {
        const int d = d0 + lane;
        const int f = d < D ? flag[d] : 0;
        const int m = d < D ? nrows[d] : 0;
        int sf = f, sr = f ? m : 0;
#pragma unroll
        for (int off = 1; off < 32; off <<= 1) {
          const int a = __shfl_up_sync(kFull, sf, off);
          const int c = __shfl_up_sync(kFull, sr, off);
          if (lane >= off) sf += a, sr += c;
        }
        if (d < D) {
          base[d] = rows + sr - m;
          if (f) gfirst[groups + sf - 1] = d, gbase[groups + sf - 1] = rows + sr - m;
        }
        groups += __shfl_sync(kFull, sf, 31);
        rows += __shfl_sync(kFull, sr, 31);
      }
      if (lane == 0) gfirst[groups] = D, gbase[groups] = rows, n_groups = groups, n_batches = rows / kBatchRows + 1;
    }
    __syncthreads();
    const int G = n_groups, nb = n_batches;
    // the rows in load order; the first group of each batch (a binary search)
    for (int i = tid; i < D * kSlots; i += kThreads) {
      const int d = i / kSlots, r = i % kSlots;
      if (flag[d] && r < nrows[d]) rowsrc[base[d] + r] = lrow[i];
    }
    for (int k = tid; k <= nb; k += kThreads) {
      int lo = 0, hi = G;  // first group with gbase >= k * kBatchRows
      while (lo < hi) {
        const int mid = (lo + hi) / 2;
        if (gbase[mid] < k * kBatchRows) lo = mid + 1; else hi = mid;
      }
      bstart[k] = k == nb ? G : lo;
    }
    __syncthreads();

    // the warp's two rays, a half-warp each: with two columns, row h0 + warp
    // of column w0 (lanes 0-15) and of column w0 + 1 (lanes 16-31)
    const int l16 = lane & 15, slot = 2 * warp + (lane >> 4);
    const int h = h0 + slot / kCols, w = w0 + slot % kCols;
    const bool mine = h < fH && w < fW;
    const int hw = h * fW + w;
    for (int c0 = 0; c0 < C; c0 += kChunk) {
      const int len = min(kChunk, C - c0);
      const int pieces = (len + VEC - 1) / VEC;  // of VEC floats a row
      const int rstep = kThreads / pieces, my_r = tid / pieces, my_pc = tid - my_r * pieces;
      auto fetch = [&](int k) {  // the copies of batch k's rows
        const int r0 = gbase[bstart[k]], r1 = gbase[bstart[k + 1]];
        if (my_r >= rstep) return;
        for (int r = r0 + my_r; r < r1; r += rstep)
          cp_async<4 * VEC>(ring + (r % kRing) * kChunk + my_pc * VEC,
                            g + (long long)rowsrc[r] * C + c0 + my_pc * VEC);
      };
      // the copies fill [0, len) of a ring row: zeros past it (and over the
      // schedule's tables) let the walk read whole rows unmasked
      if (len < kChunk)
        for (int i = tid; i < kRing * kChunk; i += kThreads)
          if (i % kChunk >= len) ring[i] = 0.f;
      float v[kHalfPerLane], acc[kHalfPerLane];
      const float* ctx_row = ctx + ((long long)cam * HW + hw) * C + c0;
#pragma unroll
      for (int k = 0; k < kHalfPerLane; k += VEC) load_values<VEC>(v + k, ctx_row, chan<VEC>(k, l16), mine ? len : 0);
#pragma unroll
      for (int k = 0; k < kHalfPerLane; ++k) acc[k] = 0.f;
      fetch(0);
      cp_async_commit();
      for (int k = 0; k < nb; ++k) {
        // batch k + 1's rows fit the ring beside batch k's: together they
        // lie in [16k, 16k + 32 + kSlots)
        if (k + 1 < nb) fetch(k + 1);
        cp_async_commit();
        cp_async_wait_1();
        __syncthreads();
        const int d_end = gfirst[bstart[k + 1]];
        for (int d0 = gfirst[bstart[k]]; d0 < d_end; d0 += 4) {  // four bins at a time
          float dot[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int d = d0 + u;
            const int r = mine && d < d_end ? rank[d * kSlots + slot] : -1;
            dot[u] = 0.f;
            if (r >= 0) {
              const float* row = ring + ((base[d] + r) % kRing) * kChunk;
              const float wd = dep[d * kSlots + slot];
#pragma unroll
              for (int k = 0; k < kHalfPerLane; k += VEC) {  // VEC values at a time: few live registers
                float x[VEC];
                load_values<VEC>(x, row, chan<VEC>(k, l16), kChunk);
#pragma unroll
                for (int i = 0; i < VEC; ++i) {
                  dot[u] += x[i] * v[k + i];
                  acc[k + i] += wd * x[i];
                }
              }
            }
          }
          // the four dot products over each half-warp at once: lanes with
          // bit 3 set keep bins 2 and 3, then lanes with bit 2 set the odd
          // bin; lane l then holds bin (l >> 2) & 3 summed over its half
          const bool b3 = lane & 8, b2 = lane & 4;
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
        }
        __syncthreads();  // batch k's rows are free for batch k + 2
      }
      if (mine) {
        float* out = g_ctx + ((long long)cam * HW + hw) * C + c0;
#pragma unroll
        for (int k = 0; k < kHalfPerLane; k += VEC) {
          const int c = chan<VEC>(k, l16);
          if (c >= len) continue;
          if (VEC == 4)
            *reinterpret_cast<float4*>(out + c) = make_float4(acc[k], acc[k + 1], acc[k + 2], acc[k + 3]);
          else
            out[c] = acc[k];
        }
      }
    }
  }
}

}  // namespace

// lets K5 take `smem` bytes of dynamic shared memory, with all of L1 as
// shared memory (2 blocks a SM); set once for each device and larger size
template <int VEC>
cudaError_t bwd_attributes(long long smem) {
  constexpr int kDevices = 64;
  static long long allowed[kDevices] = {};
  if (smem > 232448) return cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kDevices && smem <= allowed[dev]) return cudaSuccess;
  err = cudaFuncSetAttribute(bev_pool_bwd_kernel<VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bev_pool_bwd_kernel<VEC>, cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess && dev < kDevices) allowed[dev] = smem;
  return err;
}

template <int VEC>
int launch_bwd(const int* cell, const float* depth, const float* ctx, const float* g, float* g_depth,
               float* g_ctx, int B, int NC, int D, int fH, int fW, int C, int ncells, cudaStream_t stream) {
  const long long smem = bwd_smem_bytes(D);
  cudaError_t err = bwd_attributes<VEC>(smem);
  if (err != cudaSuccess) return (int)err;
  bev_pool_bwd_kernel<VEC><<<B * NC * ((fW + kCols - 1) / kCols), kThreads, smem, stream>>>(
      cell, depth, ctx, g, g_depth, g_ctx, NC, D, fH, fW, C, ncells);
  return (int)cudaGetLastError();
}

// vec 4: C % 4 == 0 and ctx, g, g_ctx 16-byte aligned (float4 and 16-byte
// cp.async); vec 1 otherwise
extern "C" int bev_pool_bwd(const int* cell, const float* depth, const float* ctx, const float* g,
                            float* g_depth, float* g_ctx, int B, int NC, int D, int fH, int fW,
                            int C, int ncells, int vec, void* stream) {
  if (B * NC * fW <= 0 || fH <= 0 || D <= 0) return 0;
  if (vec == 4)
    return launch_bwd<4>(cell, depth, ctx, g, g_depth, g_ctx, B, NC, D, fH, fW, C, ncells, (cudaStream_t)stream);
  return launch_bwd<1>(cell, depth, ctx, g, g_depth, g_ctx, B, NC, D, fH, fW, C, ncells, (cudaStream_t)stream);
}

// K5's schedule, for its read count in ops/bev_pool.py: the camera columns
// a block owns and the rays of each it walks at once
extern "C" int bev_pool_bwd_schedule(int* columns, int* rays_per_pass) {
  *columns = kCols;
  *rays_per_pass = kRows;
  return 0;
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
