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
// What bounds them on an H100: K2 is arithmetic (about 32 divisions and
// 700 other float operations per pair, 24 lanes x 512 x 512 pairs at B = 4,
// half of them skipped below the diagonal in mask mode), with a few kB of
// input; its design stages the 64 column boxes' corners and edge normals in
// shared memory once per 64 x 64 tile, so each pair costs only the clipping.
// K3 is latency: a chain of C dependent steps per lane. One block per lane
// holds the "removed" bits in shared memory and ORs in one 64-bit mask row
// per kept box, as mmdet3d's `iou3d_nms_cuda` does; lanes run in parallel.
//
// Launches allocate nothing and run on the caller's stream.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1e-8f;
constexpr float kPar = 1e-5f;
constexpr float kBnd = 1e-5f;
constexpr int kTile = 64;

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
// column c = 64 cb + j has c > i, valid[c] and iou(i, c) > thr.
// Thread = row; the 64 column boxes of the tile are in shared memory.
__global__ void iou_mask_kernel(const float* __restrict__ boxes,
                                const uint8_t* __restrict__ valid,
                                unsigned long long* __restrict__ mask, int C,
                                float thr) {
  __shared__ Box cols[kTile];
  __shared__ uint8_t col_ok[kTile];
  const int l = blockIdx.z;
  const int rb = blockIdx.y, cb = blockIdx.x;
  const int W = C / kTile;
  const int i = rb * kTile + threadIdx.x;
  unsigned long long* dst = mask + ((long long)l * C + i) * W + cb;
  if (cb < rb) {  // strictly below the diagonal: nothing to suppress
    *dst = 0ull;
    return;
  }
  const int c = cb * kTile + threadIdx.x;
  cols[threadIdx.x] = box_terms(boxes + ((long long)l * C + c) * 5);
  col_ok[threadIdx.x] = valid[(long long)l * C + c];
  __syncthreads();
  const Box A = box_terms(boxes + ((long long)l * C + i) * 5);
  unsigned long long word = 0ull;
  for (int jj = 0; jj < kTile; ++jj) {
    const int col = cb * kTile + jj;
    if (col > i && col_ok[jj] && pair_iou(A, cols[jj]) > thr)
      word |= 1ull << jj;
  }
  *dst = word;
}

// K3: one block per lane walks the C rows in score order. Row i is kept when
// it is valid and no kept row before it has its bit set; keeping it ORs its
// mask row into `removed`. The first post_max kept rows are written out.
__global__ void greedy_kernel(const unsigned long long* __restrict__ mask,
                              const uint8_t* __restrict__ valid,
                              int* __restrict__ keep_idx,
                              uint8_t* __restrict__ keep_mask, int C,
                              int post_max) {
  extern __shared__ unsigned long long removed[];
  const int l = blockIdx.x;
  const int W = C / kTile;
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    unsigned long long bits = 0ull;
    for (int j = 0; j < kTile; ++j)
      if (!valid[(long long)l * C + w * kTile + j]) bits |= 1ull << j;
    removed[w] = bits;
  }
  __syncthreads();
  int count = 0;
  for (int i = 0; i < C && count < post_max; ++i) {
    const bool gone = (removed[i / kTile] >> (i % kTile)) & 1ull;
    __syncthreads();  // every thread has read removed[] before it changes
    if (gone) continue;
    if (threadIdx.x == 0) keep_idx[(long long)l * post_max + count] = i;
    ++count;
    const unsigned long long* row = mask + ((long long)l * C + i) * W;
    for (int w = i / kTile + threadIdx.x; w < W; w += blockDim.x)
      removed[w] |= row[w];
    __syncthreads();
  }
  for (int k = threadIdx.x; k < post_max; k += blockDim.x) {
    keep_mask[(long long)l * post_max + k] = k < count;
    if (k >= count) keep_idx[(long long)l * post_max + k] = C;
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
  dim3 grid(C / kTile, C / kTile, L);
  iou_mask_kernel<<<grid, kTile, 0, (cudaStream_t)stream>>>(boxes, valid, mask,
                                                            C, thr);
  return (int)cudaGetLastError();
}

extern "C" int nms_greedy_select(const unsigned long long* mask,
                                 const uint8_t* valid, int* keep_idx,
                                 uint8_t* keep_mask, int L, int C,
                                 int post_max, void* stream) {
  if (L <= 0) return 0;
  const int W = C / kTile;
  greedy_kernel<<<L, 32, W * sizeof(unsigned long long),
                  (cudaStream_t)stream>>>(mask, valid, keep_idx, keep_mask, C,
                                          post_max);
  return (int)cudaGetLastError();
}
