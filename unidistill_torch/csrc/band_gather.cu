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
//   * K10: a block copies whole rows as consecutive 16-byte pieces, its
//     threads on consecutive pieces across row ends: a tile of at most
//     1024 pieces (12 rows at 1280-byte rows). Its first threads find the
//     tile's source rows once (w and idx loads, the clip) into shared
//     memory; each thread then walks its 4 pieces 256 apart by adding a
//     constant step to (row, piece) with one carry, no division per
//     piece, and makes all 4 loads before its 4 stores; the stores
//     stream (st.global.cs), so the output does not evict band rows that
//     later tiles read again from L2. 32-bit offsets inside a tile,
//     64-bit row offsets into the table and the output. About 21 SASS
//     instructions a piece, 28 with the thread's set-up (a thread a
//     piece ran ~76, two 64-bit divisions among them);
//     `tools/k10_variants.py` times it without each mechanism;
//   * K11: the product onehot[R, band] @ band[band, W] on the tensor cores
//     (bf16 mma.sync m16n8k16, f32 sums, cast to bf16), run only where the
//     one-hot is not all zero. A block owns (an R-row block j, a chunk of
//     256 of its rows in slab order, 128 columns). It orders the R-row
//     block's rows by slab (16 band rows, one k16 step)
//     with a stable counting sort in shared memory (counts per slab and
//     warp, a scan, a scatter that keeps the rows whose ranks fall in its
//     chunk): every block of the R-row block must find the same order, or
//     two chunks would share rows of a slab that straddles them. A warp
//     owns 32 sorted rows, two m16 groups; it stages each distinct slab
//     of its rows once (16 rows x 128 columns by cp.async into one of
//     two tiles, the next in flight while the current one's products run;
//     only the band rows its rows sit on are read, the others zero-filled)
//     and runs the products of each group that has a row in the slab, B by
//     ldmatrix.trans, the one-hot A fragments made in registers from the
//     rows' band positions. A group's rows then go through a C tile in
//     shared memory to their own places, 16-byte stores.
//     `ops/band_gather.onehot_slabs_plain` counts the products: at the
//     published size 2.8 slabs a group instead of band / 16 = 256. Each
//     output is a sum with one nonzero term, so it equals the gathered
//     value: a product whose one-hot factor is 0 adds exactly 0 for a
//     finite table, so skipping it changes no bit.
// What bounds them on an H100: moving bytes (each distinct source row read
// once, each output row written once: 50 + 84 MB at the published size).
// K11's products are 3.7 GFLOP there (0.004 ms at the bf16 peak); its
// warps stage 9 638 slabs per 128 columns, reading 74 MB of their used
// rows from L2 (197 MB if read whole). Before this design K11 ran every slab of
// every group, 2·S·band·W = 344 GFLOP, 0.35 ms at the bf16 peak.
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

// ---- K10 region: tools/k10_variants.py compiles edits of the text up to its end
constexpr int kTThreads = 256;
constexpr int kTPieces = 4;                     // pieces a thread: loads in flight before its stores
constexpr int kTTile = kTThreads * kTPieces;    // pieces a block
constexpr int kTMaxRows = 256;                  // rows a block (rows of up to 128 bytes)

__device__ __forceinline__ uint4 take_load(const uint4* p) { return __ldg(p); }
__device__ __forceinline__ void take_store(uint4* p, const uint4& v) { __stcs(p, v); }

// rows [row0, row0 + rows), row0 = blockIdx.x * rows_per_block; a row has
// vpr pieces; step_r, step_c = divmod(kTThreads, vpr)
__global__ void __launch_bounds__(kTThreads)
    band_gather_take_kernel(const uint4* __restrict__ tab, const int* __restrict__ idx,
                            const int* __restrict__ w, uint4* __restrict__ out, int n_tab, int S,
                            int R, int band, int vpr, int rows_per_block, int step_r, int step_c) {
  __shared__ const uint4* src[kTMaxRows];
  const int row0 = blockIdx.x * rows_per_block;
  const int rows = min(rows_per_block, S - row0);
  for (int r = threadIdx.x; r < rows; r += kTThreads) {
    const int k = row0 + r;
    const int lo = __ldg(w + k / R);
    const int i = min(max(__ldg(idx + k), lo), lo + band - 1);
    src[r] = tab + (long long)min(max(i, 0), n_tab - 1) * vpr;  // memory safety when w breaks its contract
  }
  __syncthreads();
  uint4* dst = out + (long long)row0 * vpr;
  const int n = rows * vpr;
  int r = threadIdx.x / vpr, c = threadIdx.x - r * vpr;
  for (int p0 = threadIdx.x; p0 < n; p0 += kTTile) {  // one pass unless a row has over kTTile pieces
    uint4 v[kTPieces];
#pragma unroll
    for (int u = 0; u < kTPieces; ++u) {
      if (p0 + u * kTThreads < n) v[u] = take_load(src[r] + c);
      r += step_r;
      c += step_c;
      if (c >= vpr) {
        c -= vpr;
        ++r;
      }
    }
#pragma unroll
    for (int u = 0; u < kTPieces; ++u)
      if (p0 + u * kTThreads < n) take_store(dst + p0 + u * kTThreads, v[u]);
  }
}

void take_launch(const uint4* tab, const int* idx, const int* w, uint4* out, int n_tab, int S, int R,
                 int band, int vpr, cudaStream_t st) {
  const int rows_per_block = std::max(1, std::min(kTMaxRows, kTTile / vpr));
  const unsigned blocks = (unsigned)((S + rows_per_block - 1LL) / rows_per_block);
  band_gather_take_kernel<<<blocks, kTThreads, 0, st>>>(tab, idx, w, out, n_tab, S, R, band, vpr,
                                                         rows_per_block, kTThreads / vpr, kTThreads % vpr);
}
// ---- end of the K10 region

constexpr int kOWarps = 8;
constexpr int kOThreads = kOWarps * 32;
constexpr int kOChunk = kOWarps * 32;  // sorted rows per block: a row a lane, two m16 groups a warp
constexpr int kON = 128;               // columns a block
constexpr int kOSS = kON + 8;          // bf16 per staged row (conflict-free ldmatrix and C stores)
constexpr int kOTile = 16 * kOSS;      // bf16 per staged 16-row tile
constexpr int kOBufBytes = kOWarps * 3 * kOTile * 2;  // a warp's two slab tiles and its C tile
constexpr int kOWindow = 2048;         // slabs per window of the sort
constexpr int kOBatch = 8;             // rows a lane of the sort loads at once
constexpr int kOSmem = kOBufBytes + 2 * kOChunk * 4 + (kOWarps + 1) * 4;
static_assert(kOWindow * kOWarps * 4 <= kOBufBytes, "the sort's counters live where the tiles go later");

__device__ __forceinline__ void mma_bf16(float* d, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, L2 only; zero-filled (nothing read) if !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// two one-hot entries (band positions k, k+1 of a row whose position is loc)
// packed as bf16 {lo, hi}; bf16 1.0 is 0x3f80
__device__ __forceinline__ uint32_t onehot_pair(int loc, int k) {
  return (loc == k ? 0x3f80u : 0u) | (loc == k + 1 ? 0x3f800000u : 0u);
}

// band position of row k of the block whose band starts at lo
__device__ __forceinline__ int band_loc(const int* __restrict__ idx, long long k, int lo, int band) {
  return min(max(__ldg(idx + k), lo), lo + band - 1) - lo;
}

// band positions of rows r, r + 32, ... (kOBatch of them) of the block at
// r0, -1 from v1 on: all loads issued before any is used
__device__ __forceinline__ void batch_locs(int* loc, const int* __restrict__ idx, long long r0, int r, int v1,
                                           int lo, int band) {
#pragma unroll
  for (int u = 0; u < kOBatch; ++u) loc[u] = r + 32 * u < v1 ? band_loc(idx, r0 + r + 32 * u, lo, band) : -1;
}

// cnt[v * nb + b] <- base + the exclusive prefix sums of cnt taken in
// (slab b, warp v) order, over the block; returns the sum. A thread scans a
// contiguous run of that order, the warps' totals join in sred[0, kOWarps].
// Ends with a barrier.
__device__ int slab_warp_exclusive_scan(int* cnt, int nb, int base, int* sred) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n = nb * kOWarps, per = (n + kOThreads - 1) / kOThreads;
  const int b = min(n, tid * per), e = min(n, b + per);
  auto at = [&](int i) -> int& { return cnt[(i % kOWarps) * nb + i / kOWarps]; };
  int sum = 0;
  for (int i = b; i < e; ++i) sum += at(i);
  int inc = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int t = __shfl_up_sync(0xffffffffu, inc, d);
    if (lane >= d) inc += t;
  }
  if (lane == 31) sred[warp] = inc;
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int i = 0; i < kOWarps; ++i) {
      const int t = sred[i];
      sred[i] = run;
      run += t;
    }
    sred[kOWarps] = run;
  }
  __syncthreads();
  int run = base + sred[warp] + inc - sum;
  for (int i = b; i < e; ++i) {
    const int t = at(i);
    at(i) = run;
    run += t;
  }
  const int total = sred[kOWarps];
  __syncthreads();
  return total;
}

// the lanes whose key equals this lane's (keys in [0, 2^bits), or -1 for
// none), as __match_any_sync gives them, by one ballot a key bit
__device__ __forceinline__ unsigned same_key_lanes(int key, int bits) {
  const unsigned some = __ballot_sync(0xffffffffu, key >= 0);
  unsigned m = key >= 0 ? some : ~some;
  for (int i = 0; i < bits; ++i) {
    const bool bit = (key >> i) & 1;
    const unsigned x = __ballot_sync(0xffffffffu, bit);
    m &= bit ? x : ~x;
  }
  return m;
}

// block (columns [kON x, kON x + kON), chunk y of sorted rows, R-row block z)
__global__ void __launch_bounds__(kOThreads, 2)
    band_gather_onehot_kernel(const __nv_bfloat16* __restrict__ tab, const int* __restrict__ idx,
                              const int* __restrict__ w, __nv_bfloat16* __restrict__ out,
                              int n_tab, int S, int W, int R, int band) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  int* cnt = reinterpret_cast<int*>(smem);  // the sort's counters, before any tile is staged
  int* srow = reinterpret_cast<int*>(smem + kOBufBytes);
  int* sloc = srow + kOChunk;
  int* sred = sloc + kOChunk;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.z * R;
  const int n_rows = (int)min((long long)R, (long long)S - r0);
  const int c0 = blockIdx.y * kOChunk;
  if (c0 >= n_rows) return;
  const int n_mine = min(kOChunk, n_rows - c0);
  const int lo = __ldg(w + blockIdx.z);
  const int n0 = blockIdx.x * kON;
  const int nslab = band / 16;

  // ---- order the block's rows by slab (loc / 16), equal slabs by row
  // number, and keep the rows of ranks [c0, c0 + n_mine). Every block of
  // this R-block must find the same order, or two chunks would share rows
  // of a slab that straddles them; so the sort is stable: warp v counts its
  // own run of rows [v L, v L + L) in cnt[v][slab], an exclusive scan in
  // (slab, warp) order gives each warp its first rank in each slab, and
  // the warp ranks its rows in order, lanes of one slab by lane. Slabs go
  // in windows of kOWindow.
  int before = 0;
  const int per_warp = (n_rows + kOWarps - 1) / kOWarps;
  const int v0 = warp * per_warp, v1 = min(n_rows, v0 + per_warp);
  for (int b0 = 0; b0 < nslab; b0 += kOWindow) {
    const int nb = min(kOWindow, nslab - b0);
    int* mine = cnt + warp * nb;
    for (int i = tid; i < nb * kOWarps; i += kOThreads) cnt[i] = 0;
    __syncthreads();
    for (int rb = v0; rb < v1; rb += 32 * kOBatch) {
      int loc[kOBatch];
      batch_locs(loc, idx, r0, rb + lane, v1, lo, band);
#pragma unroll
      for (int u = 0; u < kOBatch; ++u) {
        const int sl = loc[u] >= 0 ? (loc[u] >> 4) - b0 : -1;
        if (sl >= 0 && sl < nb) atomicAdd(mine + sl, 1);  // counts: the order does not matter
      }
    }
    __syncthreads();
    const int total = slab_warp_exclusive_scan(cnt, nb, before, sred);
    if (before < c0 + n_mine && before + total > c0) {
      const int bits = 32 - __clz(max(nb - 1, 1));
      for (int rb = v0; rb < v1; rb += 32 * kOBatch) {
        int loc[kOBatch];
        batch_locs(loc, idx, r0, rb + lane, v1, lo, band);
#pragma unroll
        for (int u = 0; u < kOBatch; ++u) {
          int sl = loc[u] >= 0 ? (loc[u] >> 4) - b0 : -1;
          sl = sl < nb ? sl : -1;  // below 0 or -1: not in this window
          const unsigned peers = same_key_lanes(sl < 0 ? -1 : sl, bits);
          const int first = sl >= 0 ? mine[sl] : 0;
          __syncwarp();
          if (sl >= 0 && lane == __ffs(peers) - 1) mine[sl] = first + __popc(peers);
          __syncwarp();
          const int q = first + __popc(peers & ((1u << lane) - 1u)) - c0;
          if (sl >= 0 && q >= 0 && q < n_mine) {
            srow[q] = rb + lane + 32 * u;
            sloc[q] = loc[u];
          }
        }
      }
    }
    before += total;
    __syncthreads();
    if (before >= c0 + n_mine) break;
  }

  // ---- products: a warp owns sorted rows [32 warp, 32 warp + 32), groups
  // g = 0, 1 of 16; it stages each distinct slab of its rows once and runs
  // the products of each group that has a row in it. The slabs stream
  // through two tiles, slab t + 1 in flight during slab t.
  const int q0 = warp * 32;
  if (q0 >= n_mine) return;
  const bool valid = q0 + lane < n_mine;
  const int my_loc = valid ? sloc[q0 + lane] : -1;
  const int my_slab = valid ? my_loc >> 4 : -1;
  const int prev_slab = __shfl_up_sync(0xffffffffu, my_slab, 1);
  const unsigned starts = __ballot_sync(0xffffffffu, valid && (lane == 0 || prev_slab != my_slab));
  const int n_slabs = __popc(starts);
  unsigned pending = starts;  // the slabs not staged yet
  const int gid = lane >> 2, tig = lane & 3;
  int aloc[2][2];  // band positions of rows gid and gid + 8 of each group (-1: no row)
#pragma unroll
  for (int g = 0; g < 2; ++g)
#pragma unroll
    for (int h = 0; h < 2; ++h) aloc[g][h] = __shfl_sync(0xffffffffu, my_loc, g * 16 + gid + 8 * h);
  __nv_bfloat16* wt = tiles + warp * 3 * kOTile;
  __nv_bfloat16* ct = wt + 2 * kOTile;

  // the next slab (the lowest run start in `pending`): its 16 band rows x
  // columns [n0, n0 + kON) into tile buf, 8 pieces of 16 bytes a lane;
  // returns the slab. Only the band rows that one of the warp's rows sits
  // on are read; the others, whose one-hot entries are 0 in every row, are
  // zero-filled.
  auto stage = [&](int buf) {
    const int s = __shfl_sync(0xffffffffu, my_slab, __ffs(pending) - 1);
    pending &= pending - 1;
    const unsigned used = __reduce_or_sync(0xffffffffu, valid && my_slab == s ? 1u << (my_loc & 15) : 0u);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int p = lane + 32 * i, r = p >> 4, c = (p & 15) * 8;
      const int trow = min(max(lo + 16 * s + r, 0), n_tab - 1);  // memory safety when w breaks its contract
      const bool ok = (used >> r & 1u) && n0 + c < W;
      cp_async16(smem_addr(wt + buf * kOTile + r * kOSS + c), tab + (long long)trow * W + n0 + (ok ? c : 0), ok);
    }
    cp_async_commit();
    return s;
  };

  float acc[kON / 8][4];
#pragma unroll
  for (int ni = 0; ni < kON / 8; ++ni)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;

  // acc += onehot(group g's rows, slab s) @ staged tile
  auto products = [&](uint32_t tile, int g, int s) {
    const int kb = 16 * s + 2 * tig;
    uint32_t a[4];
    a[0] = onehot_pair(aloc[g][0], kb);
    a[1] = onehot_pair(aloc[g][1], kb);
    a[2] = onehot_pair(aloc[g][0], kb + 8);
    a[3] = onehot_pair(aloc[g][1], kb + 8);
    const int k = ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
    for (int np = 0; np < kON / 16; ++np) {
      if (n0 + np * 16 < W) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, tile + (k * kOSS + np * 16 + (lane >> 4) * 8) * 2);
        mma_bf16(acc[2 * np], a, b[0], b[1]);
        if (n0 + np * 16 + 8 < W) mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
      }
    }
  };

  // group g's rows to their own places: C tile in shared memory, then a
  // half-warp a row with 16-byte stores
  auto flush = [&](int g) {
#pragma unroll
    for (int ni = 0; ni < kON / 8; ++ni) {
      const int c = ni * 8 + 2 * tig;
      *reinterpret_cast<__nv_bfloat162*>(ct + gid * kOSS + c) = __floats2bfloat162_rn(acc[ni][0], acc[ni][1]);
      *reinterpret_cast<__nv_bfloat162*>(ct + (gid + 8) * kOSS + c) = __floats2bfloat162_rn(acc[ni][2], acc[ni][3]);
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[ni][e] = 0.f;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = 2 * i + (lane >> 4), c = (lane & 15) * 8, q = q0 + g * 16 + r;
      if (q < n_mine && n0 + c < W)
        *reinterpret_cast<uint4*>(out + (r0 + srow[q]) * W + n0 + c) =
            *reinterpret_cast<const uint4*>(ct + r * kOSS + c);
    }
    __syncwarp();
  };

  int s = stage(0);
  bool first_done = false;
  for (int t = 0; t < n_slabs; ++t) {
    int s_next = -1;
    if (t + 1 < n_slabs) {
      s_next = stage((t + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncwarp();
    const unsigned in_slab = __ballot_sync(0xffffffffu, valid && my_slab == s);
    const uint32_t tile = smem_addr(wt + (t & 1) * kOTile);
    if (in_slab & 0xffffu) products(tile, 0, s);
    if (in_slab >> 16) {  // slabs ascend: group 0 has no row past its first shared slab with group 1
      if (!first_done) {
        flush(0);
        first_done = true;
      }
      products(tile, 1, s);
    }
    __syncwarp();  // tile t & 1 takes slab t + 2 next
    s = s_next;
  }
  flush(first_done ? 1 : 0);
}

bool bad_args(int n_tab, long long S, int row_bytes, int R, int band) {
  return n_tab <= 0 || S < 0 || row_bytes <= 0 || R <= 0 || band <= 0 || band > n_tab;
}

}  // namespace

extern "C" {

// variant 0: K9 unroll 1, 1: K9 unroll 4, 2: K10 (S < 2^31); row_bytes
// and both pointers multiples of 16
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
      if (S >= (1LL << 31)) return cudaErrorInvalidValue;
      take_launch(tp, ip, wp, op, n_tab, (int)S, R, band, vpr, st);
      break;
    default:
      return cudaErrorInvalidValue;
  }
  return cudaGetLastError();
}

// K11: bf16 tab [n_tab, W] with W % 8 == 0, R % 128 == 0, band % 32 == 0
int band_gather_onehot(const void* tab, const void* idx, const void* w, void* out, int n_tab, int S,
                       int W, int R, int band, void* stream) {
  if (bad_args(n_tab, S, 2 * W, R, band) || W % 8 != 0 || R % 128 != 0 || band % 32 != 0 ||
      (S + 127) / 128 > 65535)
    return cudaErrorInvalidValue;
  if (S == 0) return cudaSuccess;
  constexpr int kDevices = 64;
  static bool allowed[kDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= kDevices || !allowed[dev]) {
    err = cudaFuncSetAttribute(band_gather_onehot_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kOSmem);
    if (err == cudaSuccess)  // two blocks a SM
      err = cudaFuncSetAttribute(band_gather_onehot_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                                 cudaSharedmemCarveoutMaxShared);
    if (err != cudaSuccess) return err;
    if (dev < kDevices) allowed[dev] = true;
  }
  const dim3 grid((W + kON - 1) / kON, (std::min(R, S) + kOChunk - 1) / kOChunk,
                  (unsigned)(((long long)S + R - 1) / R));
  band_gather_onehot_kernel<<<grid, kOThreads, kOSmem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(tab), static_cast<const int*>(idx),
      static_cast<const int*>(w), static_cast<__nv_bfloat16*>(out), n_tab, S, W, R, band);
  return cudaGetLastError();
}

}  // extern "C"
