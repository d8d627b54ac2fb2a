// K2 rotated_iou (float IoU and NMS bitmask) and K3 nms_greedy_select.
//
// K2 replaces the Pallas `rotated_iou_bev_pallas` of the JAX package
// (unidistill_tpu/ops/nms.py:317; tile body `_iou_block_kernel_2d` :308 ->
// `_intersection_area_tile` :182 -> `_clip_contrib_2d` :144), and on the
// eval path also the XLA `rotated_iou_upper_blocked` (:251) that JAX runs by
// default. The pairwise IoU of rotated BEV boxes (cx, cy, dx, dy, rot):
// every edge of one box is clipped against the other box's four half-planes
// (sort-free Liang-Barsky) and the clipped segments are summed with the
// shoelace formula; `exclude_boundary` applies to the second box's edges
// only, so an edge shared by both boxes counts once. The float math follows
// `_clip_contrib_2d` term for term (same _EPS, PAR and BND), and the library
// is built with -fmad=false so that no multiply-add is contracted.
//
// K3 replaces the XLA `_greedy_suppress_blocked` (:366) and `_keep_select`
// (:409): serial greedy suppression over the bitmask, whose result the JAX
// fixpoint iteration provably equals.
//
// What bounds them on an H100. K2's mask mode: a clipped pair costs about
// 32 IEEE divisions and 530 other float operations, but few pairs need it.
// Decoded candidates cluster, and a pair whose boxes cannot meet has IoU 0,
// which is no bit at any thr >= 0. So the mask mode tests every upper pair
// with a cheap filter (a few dozen operations) and clips only the pairs
// that pass, densely, a pair a thread; it is bound by the tiles' filter
// scan, the launch and the clips of the pairs that do meet. K3 is latency:
// a chain of dependent steps per lane, one a row walked (a row's bit test
// and OR) up to the end of the 64-row block in which the post_max-th row is
// kept; its design keeps every memory access off that chain (below, at its
// kernel).
//
// The filter, and why a pair it rejects has bit 0 whatever the clip gives
// (thr >= 0; at thr < 0 every pair is clipped). Let X bound a box's
// coordinates, S = |cx| + |cy| + |dx| + |dy| >= X its scale, and a box
// "tame" when S < 5 km and min(|dx|, |dy|) >= 1e-5 (1 m + |cx| + |cy|): its
// float corners lie within ~2.4e-7 X of the exact rectangle (each is
// cx + lx c - ly s, a few roundings), 40 times less than its least side, so
// they form a convex quad with edges >> kEps and angles within ~3 degrees
// of square. (Every box the detectors decode is tame: dims >= 1 mm, centres
// within 61.2 m.)
// A point that the clip keeps on an edge of P (length len <= S_P) lies, for
// each half-plane of Q, inside it within num's round-off if the plane cuts
// the edge, or within BND + PAR len if the plane is treated as parallel
// (|den| <= PAR len and num <= BND). With the corners' and the filter's own
// round-off (together under 1e-6 (S_a + S_b)), a nonzero contribution needs
// the two exact rectangles within
//   1e-5 m + 1e-5 S_P + 1e-6 (S_a + S_b)
// of each other. That is less than the margin
//   m = 1 cm + 1e-5 (S_a + S_b)
// for tame boxes (S_a + S_b < 10 km; 1 cm is 1000 x BND, and 160 x the
// corners' round-off at the 61.2 m of `post_center_limit_range`). The filter rejects
// a pair when the rectangles lie farther apart than m along any of the four
// axes of the two boxes (the separating-axis test, exact for rectangles).
// Then every edge's clipped interval is empty or `par_out`, the shoelace
// total is 0, inter = 0 and the IoU is exactly 0.
// A box that is not tame (or not finite) gets S = inf: every test of its
// pairs passes, and they are clipped.
//   No area bound: IoU > thr needs min(a, b) > thr max(a, b) only where
// inter <= min(a, b), and the clip breaks that for boxes that touch. Where
// two boxes share a boundary (an edge of one within BND of the other's),
// `exclude_boundary` keeps one box's edge and drops the other's, the
// clipped chain is not closed, and its shoelace total depends on the
// origin: two touching boxes 60 m out give an IoU of 2.2 to 7e9 (the
// reference's value, which this kernel repeats). A pair that touches is
// within the margin, so the axis test clips it.
//
// Launches allocate nothing and run on the caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-8f;
constexpr float kPar = 1e-5f;
constexpr float kBnd = 1e-5f;
constexpr int kTile = 64;
constexpr int kMaskThreads = 256;
constexpr float kMargin = 1e-2f;     // m, beside 1e-5 x the pair's scale
constexpr float kRelMargin = 1e-5f;
constexpr float kTame = 1e-5f;       // min dim >= kTame (1 m + |cx| + |cy|)
constexpr float kMaxScale = 5e3f;    // m: a tame box has S below it

struct Box {
  float x[4], y[4];    // ccw corners
  float nx[4], ny[4];  // inward unit normal of edge k (corner k -> k+1)
  float len[4];        // |edge k| + eps
  float area;
};

__device__ __forceinline__ Box box_terms(const float* __restrict__ b) {
  Box o;
  const float cx = b[0], cy = b[1], dx = b[2], dy = b[3], r = b[4];
  const float c = cosf(r), s = sinf(r);
  const float hx = dx * 0.5f, hy = dy * 0.5f;
  const float sx[4] = {1.f, -1.f, -1.f, 1.f};
  const float sy[4] = {1.f, 1.f, -1.f, -1.f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float lx = sx[k] * hx, ly = sy[k] * hy;
    o.x[k] = cx + lx * c - ly * s;
    o.y[k] = cy + lx * s + ly * c;
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int k1 = (k + 1) & 3;
    const float ex = o.x[k1] - o.x[k], ey = o.y[k1] - o.y[k];
    const float elen = sqrtf(ex * ex + ey * ey) + kEps;
    o.nx[k] = -ey / elen;
    o.ny[k] = ex / elen;
    o.len[k] = elen;
  }
  o.area = dx * dy;
  return o;
}

// Shoelace term of edge k of box P clipped to box Q (`_clip_contrib_2d`).
__device__ __forceinline__ float clip_edge(const Box& P, int k, const Box& Q,
                                           bool exclude_boundary) {
  const int k1 = (k + 1) & 3;
  const float p0x = P.x[k], p0y = P.y[k];
  const float dx = P.x[k1] - p0x, dy = P.y[k1] - p0y;
  const float dlen = P.len[k];
  const float thresh = exclude_boundary ? -kBnd : kBnd;
  float t_lo = 0.f, t_hi = 1.f;
  bool par_out = false;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float den = Q.nx[i] * dx + Q.ny[i] * dy;
    const float num = Q.nx[i] * (Q.x[i] - p0x) + Q.ny[i] * (Q.y[i] - p0y);
    const bool is_par = fabsf(den) <= kPar * dlen;
    const float t = num / (is_par ? 1.f : den);
    if (!is_par && den > 0.f) t_lo = fmaxf(t_lo, t);
    if (!is_par && den < 0.f) t_hi = fminf(t_hi, t);
    par_out = par_out || (is_par && num > thresh);
  }
  const float t0 = fminf(fmaxf(t_lo, 0.f), 1.f);
  const float t1 = fminf(fmaxf(t_hi, 0.f), 1.f);
  if (!(t1 > t0) || par_out) return 0.f;
  const float q0x = p0x + t0 * dx, q0y = p0y + t0 * dy;
  const float q1x = p0x + t1 * dx, q1y = p0y + t1 * dy;
  return q0x * q1y - q0y * q1x;
}

__device__ __forceinline__ float pair_iou(const Box& A, const Box& B) {
  float total = 0.f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    total = total + clip_edge(A, k, B, false);
    total = total + clip_edge(B, k, A, true);
  }
  const float inter = fmaxf(0.5f * total, 0.f);
  return inter / fmaxf(A.area + B.area - inter, kEps);
}

// The pair filter of the mask mode reads, per box, two float4:
// (cx, cy, cos, sin) of the yaw as `box_terms` takes them, and (hx, hy,
// scale, 0) with the half-extents and the scale of the header, +inf for a
// box that is not tame, which turns the test of its pairs off.
__device__ __forceinline__ void reach_terms(const float* __restrict__ b, float4* o) {
  const float cx = b[0], cy = b[1], adx = fabsf(b[2]), ady = fabsf(b[3]);
  const float scale = fabsf(cx) + fabsf(cy) + adx + ady;
  const bool tame = fminf(adx, ady) >= kTame * (1.f + fabsf(cx) + fabsf(cy)) && scale < kMaxScale;
  o[0] = make_float4(cx, cy, cosf(b[4]), sinf(b[4]));
  o[1] = make_float4(adx * 0.5f, ady * 0.5f, tame ? scale : __int_as_float(0x7f800000), 0.f);
}

// False when the row box a and the column box b provably have IoU 0: their
// rectangles lie more than the margin apart along one of the four axes of
// the two boxes (the separating-axis test, exact for rectangles). No branch:
// a warp's 32 pairs take the test together. `pairs_to_clip_plain` in
// ops/nms.py repeats this arithmetic.
__device__ __forceinline__ bool may_meet(const float4* a, const float4* b) {
  const float4 a0 = a[0], a1 = a[1], b0 = b[0], b1 = b[1];
  const float m = kMargin + kRelMargin * (a1.z + b1.z);
  const float ddx = b0.x - a0.x, ddy = b0.y - a0.y;
  const float co = fabsf(a0.z * b0.z + a0.w * b0.w), si = fabsf(a0.w * b0.z - a0.z * b0.w);
  const bool apart = (fabsf(ddx * a0.z + ddy * a0.w) > a1.x + b1.x * co + b1.y * si + m) |
                     (fabsf(ddy * a0.z - ddx * a0.w) > a1.y + b1.x * si + b1.y * co + m) |
                     (fabsf(ddx * b0.z + ddy * b0.w) > b1.x + a1.x * co + a1.y * si + m) |
                     (fabsf(ddy * b0.z - ddx * b0.w) > b1.y + a1.x * si + a1.y * co + m);
  return !apart;
}

// (a) float IoU [L, M, N]. Thread = column; the 64 row boxes of the tile are
// staged in shared memory, so each thread's stores run along a row.
__global__ void iou_f32_kernel(const float* __restrict__ a,
                               const float* __restrict__ b,
                               float* __restrict__ out, int M, int N) {
  __shared__ Box rows[kTile];
  const int l = blockIdx.z;
  const int r0 = blockIdx.y * kTile;
  const int j = blockIdx.x * kTile + threadIdx.x;
  if (r0 + threadIdx.x < M)
    rows[threadIdx.x] = box_terms(a + ((long long)l * M + r0 + threadIdx.x) * 5);
  __syncthreads();
  if (j >= N) return;
  const Box B = box_terms(b + ((long long)l * N + j) * 5);
  const int nr = min(kTile, M - r0);
  for (int r = 0; r < nr; ++r)
    out[((long long)l * M + r0 + r) * N + j] = pair_iou(rows[r], B);
}

// (b) NMS mask [L, C, C/64] uint64: bit j of word (i, cb) is set when
// column c = 64 cb + j has c > i, valid[c] and iou(i, c) > thr; every word
// below the diagonal is 0. One block of 256 threads per 64 x 64 tile on or
// above the diagonal (T(T+1)/2 tiles a lane, T = C/64); the tile (rb, cb),
// rb < cb, also writes the zero words of its mirror (cb, rb).
//  1. Each box's clip terms (`box_terms`) and reach terms once, in shared
//     memory.
//  2. The tile's pairs are tested cheaply (`may_meet`): a thread keeps one
//     column's reach terms in registers and walks 16 rows; a warp's
//     pairs that pass go to its own segment of a shared list (ballot,
//     popcount rank; no atomics).
//  3. The list is clipped densely, a pair a thread; a set bit is an integer
//     atomicOr on the tile's shared words (OR does not depend on order, so
//     reruns are bit-identical). Each word is written once.
// At most 64 registers a thread, so that four blocks (32 warps) share an SM:
// the clips are latency-bound chains of divisions.
__global__ void __launch_bounds__(kMaskThreads, 4)
iou_mask_kernel(const float* __restrict__ boxes, const uint8_t* __restrict__ valid,
                unsigned long long* __restrict__ mask, int C, float thr,
                bool filter) {
  constexpr int kWarps = kMaskThreads / 32, kSegment = kTile * kTile / kWarps;
  __shared__ Box rows[kTile], cols[kTile];
  __shared__ float4 rreach[kTile][2], creach[kTile][2];
  __shared__ unsigned long long words[kTile];
  __shared__ unsigned short pairs[kTile * kTile];  // kWarps segments
  __shared__ int seg_end[kWarps];
  __shared__ unsigned col_ok[2];
  const int T = C / kTile;
  const int l = blockIdx.y;
  int rb = 0, t = blockIdx.x;  // the t-th upper tile, row-major
  while (t >= T - rb) {
    t -= T - rb;
    ++rb;
  }
  const int cb = rb + t, r0 = rb * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* lane_boxes = boxes + (long long)l * C * 5;
  unsigned long long* lane_mask = mask + (long long)l * C * T;
  if (tid < kTile) {
    const float* b = lane_boxes + (long long)(cb * kTile + tid) * 5;
    cols[tid] = box_terms(b);
    reach_terms(b, creach[tid]);
    const unsigned ok = __ballot_sync(0xffffffffu, valid[(long long)l * C + cb * kTile + tid] != 0);
    if (lane == 0) col_ok[warp] = ok;
  } else if (tid < 2 * kTile) {
    const int k = tid - kTile;
    const float* b = lane_boxes + (long long)(r0 + k) * 5;
    rows[k] = box_terms(b);
    reach_terms(b, rreach[k]);
    words[k] = 0ull;
  } else if (tid < 3 * kTile) {
    const int k = tid - 2 * kTile;
    if (rb < cb) lane_mask[(long long)(cb * kTile + k) * T + rb] = 0ull;
  }
  __syncthreads();
  const unsigned long long ok_cols = col_ok[0] | (unsigned long long)col_ok[1] << 32;
  const int c = tid & (kTile - 1);
  int n_seg = 0;  // this warp's pairs that pass
  if (ok_cols != 0ull) {
    const float4 b[2] = {creach[c][0], creach[c][1]};
    const bool col_live = (ok_cols >> c) & 1ull;
    // pair p = 64 r + c, r = 4 k + tid / 64: a warp's 32 lanes share the row
#pragma unroll 4
    for (int k = 0; k < kTile / 4; ++k) {
      const int r = 4 * k + (tid >> 6);
      bool pass = col_live && (cb > rb || c > r);
      if (filter) pass = pass && may_meet(rreach[r], b);
      const unsigned ballot = __ballot_sync(0xffffffffu, pass);
      if (pass) pairs[warp * kSegment + n_seg + __popc(ballot & ((1u << lane) - 1u))] = (unsigned short)(r * kTile + c);
      n_seg += __popc(ballot);
    }
  }
  if (lane == 0) seg_end[warp] = n_seg;
  __syncthreads();
  int n = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) n += seg_end[w];
  for (int e = tid; e < n; e += kMaskThreads) {
    int w = 0, i = e;
    while (i >= seg_end[w]) i -= seg_end[w++];
    const int p = pairs[w * kSegment + i], r = p >> 6, cc = p & (kTile - 1);
    if (pair_iou(rows[r], cols[cc]) > thr) atomicOr(&words[r], 1ull << cc);
  }
  __syncthreads();
  if (tid < kTile) lane_mask[(long long)(r0 + tid) * T + cb] = words[tid];
}

// K3: one warp (a block of 32 threads) per lane walks the C rows in score
// order, 64 at a time. Row i is kept when it is valid and no kept row before
// it has its bit set. The "removed" words start as the invalid rows' bits
// (two ballots a word over coalesced loads of `valid`, 16 loads in flight)
// and live in shared memory. For row block b:
//  - the walk reads only the diagonal words (row, b) of the block's 64 rows:
//    a row is kept when its bit of removed[b] is clear, and then ORs in its
//    diagonal word (bits of later rows only); the loads do not wait on the
//    chain, so each row costs a few dependent integer operations;
//  - the walk is cut at post_max kept rows, and the kept rows' indices are
//    written at their popcount ranks;
//  - lane t ORs word w > b of kept rows t and t + 32 in a register, the warp
//    ORs its 32 registers together (`__reduce_or_sync`), and removed[w] is
//    updated once.
// While block b is walked, block b + 1's rows (words b + 1 .. W - 1) are
// staged in shared memory by 8-byte cp.async (two buffers; where 2 x 64 W
// words do not fit in 48 KB, rows are read from global memory instead). The
// staging hides each block's wait for its rows behind the previous block's
// walk: read from global memory, K3 took 1.9-3.1x as long on an H100
// (`tools/nms_variants.py` k3_global). No block barrier: the warp
// synchronises with __syncwarp.
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }
__device__ __forceinline__ void cp_async_wait_0() { asm volatile("cp.async.wait_group 0;\n" ::); }

constexpr int kStageBytes = 48 * 1024;  // dynamic shared memory without opting in

__device__ __forceinline__ void stage_rows(unsigned long long* dst, const unsigned long long* rows,
                                           int b, int W, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {  // words b .. W - 1 of rows lane and lane + 32
    const int j = 32 * h + lane;
    for (int w = b; w < W; ++w) cp_async8(dst + j * W + w, rows + (long long)j * W + w);
  }
}

__global__ void __launch_bounds__(32) greedy_kernel(const unsigned long long* __restrict__ mask,
                                                    const uint8_t* __restrict__ valid,
                                                    int* __restrict__ keep_idx,
                                                    uint8_t* __restrict__ keep_mask, int C,
                                                    int post_max, bool staged) {
  extern __shared__ unsigned long long smem[];  // removed[W], then 2 x 64 x W staged words
  const int l = blockIdx.x, lane = threadIdx.x, W = C / kTile;
  unsigned long long* removed = smem;
  unsigned long long* stage = smem + W;
  const unsigned long long* lane_mask = mask + (long long)l * C * W;
  const uint8_t* v = valid + (long long)l * C;
  int* idx = keep_idx + (long long)l * post_max;
  if (staged) {
    stage_rows(stage, lane_mask, 0, W, lane);
    cp_async_commit();
  }
  for (int w0 = 0; w0 < W; w0 += 8) {  // 16 loads in flight, then the ballots
    bool gone[16];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int w = min(w0 + u, W - 1);
      gone[2 * u] = v[w * kTile + lane] == 0;
      gone[2 * u + 1] = v[w * kTile + 32 + lane] == 0;
    }
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const unsigned lo = __ballot_sync(0xffffffffu, gone[2 * u]);
      const unsigned hi = __ballot_sync(0xffffffffu, gone[2 * u + 1]);
      if (lane == 0 && w0 + u < W) removed[w0 + u] = lo | (unsigned long long)hi << 32;
    }
  }
  int count = 0;
  for (int b = 0; b < W && count < post_max; ++b) {
    const unsigned long long* rows = lane_mask + (long long)b * kTile * W;
    if (staged) {
      if (b + 1 < W) {
        stage_rows(stage + ((b + 1) & 1) * kTile * W, rows + kTile * W, b + 1, W, lane);
        cp_async_commit();
        cp_async_wait_1();
      } else {
        cp_async_wait_0();
      }
      rows = stage + (b & 1) * kTile * W;
    }
    __syncwarp();
    unsigned long long rem = removed[b], keep = 0ull;
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      const unsigned long long d = rows[j * W + b];
      if (!((rem >> j) & 1ull)) {
        rem |= d;
        keep |= 1ull << j;
      }
    }
    int m = post_max - count;  // the first m kept rows of the block stay
    for (unsigned long long extra = keep; extra; extra &= extra - 1)
      if (m-- <= 0) keep &= ~(extra & (~extra + 1ull));
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int j = 32 * h + lane;
      if ((keep >> j) & 1ull) idx[count + __popcll(keep & ((1ull << j) - 1ull))] = b * kTile + j;
    }
    count += __popcll(keep);
    // lane t ORs kept rows t and t + 32 into each later word, then the warp
    // ORs the lanes' words together
    const bool k0 = (keep >> lane) & 1ull, k1 = (keep >> (32 + lane)) & 1ull;
#pragma unroll 4
    for (int w = b + 1; w < W && count < post_max; ++w) {
      const unsigned long long acc = (k0 ? rows[lane * W + w] : 0ull) | (k1 ? rows[(32 + lane) * W + w] : 0ull);
      const unsigned lo = __reduce_or_sync(0xffffffffu, (unsigned)acc);
      const unsigned hi = __reduce_or_sync(0xffffffffu, (unsigned)(acc >> 32));
      if (lane == 0) removed[w] |= lo | (unsigned long long)hi << 32;
    }
    __syncwarp();  // the buffer and removed[] are read before they change
  }
  if (staged) cp_async_wait_0();
  for (int k = lane; k < post_max; k += 32) {
    keep_mask[(long long)l * post_max + k] = k < count;
    if (k >= count) idx[k] = C;
  }
}

}  // namespace

extern "C" int rotated_iou_f32(const float* a, const float* b, float* out,
                               int L, int M, int N, void* stream) {
  if (L <= 0 || M <= 0 || N <= 0) return 0;
  dim3 grid((N + kTile - 1) / kTile, (M + kTile - 1) / kTile, L);
  iou_f32_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(a, b, out, M, N);
  return (int)cudaGetLastError();
}

extern "C" int rotated_iou_mask(const float* boxes, const uint8_t* valid,
                                unsigned long long* mask, int L, int C,
                                float thr, void* stream) {
  if (L <= 0 || C <= 0) return 0;
  const long long T = C / kTile;
  dim3 grid((unsigned)(T * (T + 1) / 2), L);
  // the filter holds for thr >= 0 only: a pair that cannot meet has IoU 0
  const bool filter = thr >= 0.f;
  iou_mask_kernel<<<grid, kMaskThreads, 0, (cudaStream_t)stream>>>(boxes, valid, mask, C,
                                                                    thr, filter);
  return (int)cudaGetLastError();
}

extern "C" int nms_greedy_select(const unsigned long long* mask,
                                 const uint8_t* valid, int* keep_idx,
                                 uint8_t* keep_mask, int L, int C,
                                 int post_max, void* stream) {
  if (L <= 0) return 0;
  const long long W = C / kTile;
  const bool staged = (W + 2 * kTile * W) * 8 <= kStageBytes;
  const long long smem = (staged ? W + 2 * kTile * W : W) * 8;
  greedy_kernel<<<L, 32, smem, (cudaStream_t)stream>>>(mask, valid, keep_idx, keep_mask, C,
                                                       post_max, staged);
  return (int)cudaGetLastError();
}
