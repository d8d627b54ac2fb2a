// The port's copy of the JAX package's runtime/topology.cc, built by
// unidistill_torch/kernels/build.py (host_library) and bound by
// unidistill_torch/data/native.py.
//
// Host-side sparse-topology planner for the chunked LiDAR encoder —
// C++ implementation of unidistill_tpu/data/topology_host.py
// (plan_frame_topology), exact to the integer.
//
// The reference delegates rulebook construction to spconv's native code
// (ref layers/blocks_3d/det3d/spconv_backbone.py:253-343); here the
// dataloader workers plan the whole frame's gather topology on the host.
// The vectorized-numpy planner costs ~500 ms/frame at nuScenes scale
// (searchsorted + table popcounts dominate); this direct-addressed C++
// version is ~20x faster, keeping the loader ahead of the device step.
//
// Semantics are specified by the numpy module and the device builders
// (ops/sparse_conv_chunked.py); cross-checked integer-exact in
// tests/test_topology_host.py::test_native_planner_matches_numpy.
#include <algorithm>
#include <cstdint>
#include <cmath>
#include <cstring>
#include <vector>

namespace {

constexpr int CHUNK = 4;

inline int nch_of(int D) { return (D + CHUNK - 1) / CHUNK; }

// Dense column map with epoch stamping (no per-frame memset of the
// H*W-sized arrays).
struct ColMap {
  std::vector<int32_t> base;
  std::vector<int32_t> bits;
  std::vector<int32_t> stamp;
  int32_t epoch = 0;
  int64_t hw = 0;

  void reset(int64_t new_hw) {
    if ((int64_t)stamp.size() < new_hw) {
      base.resize(new_hw);
      bits.resize(new_hw);
      stamp.assign(new_hw, 0);
      epoch = 0;
    }
    hw = new_hw;
    ++epoch;
  }
  inline void set(int64_t key, int32_t b, int32_t bm) {
    base[key] = b;
    bits[key] = bm;
    stamp[key] = epoch;
  }
  inline bool get(int64_t key, int32_t* b, int32_t* bm) const {
    if (key < 0 || key >= hw || stamp[key] != epoch) return false;
    *b = base[key];
    *bm = bits[key];
    return true;
  }
};

// 3-way chunk resolve (device `_resolve` semantics): chunk s -> case 0,
// else s-1 -> case 1, else s+1 -> case 2; miss -> idx=S, case=2.
inline int32_t resolve_pack(bool has, int32_t base, int32_t bits, int s,
                            int nch, int32_t S) {
  if (has) {
    for (int c = 0; c < 3; ++c) {
      static const int d[3] = {0, -1, 1};
      int q = s + d[c];
      if (q >= 0 && q < nch && ((bits >> q) & 1)) {
        int32_t idx = base + __builtin_popcount(bits & ((1 << q) - 1));
        return idx * 4 + c;
      }
    }
  }
  return S * 4 + 2;
}

inline int32_t resolve_exact(bool has, int32_t base, int32_t bits, int s,
                             int nch, int32_t S) {
  if (has && s >= 0 && s < nch && ((bits >> s) & 1)) {
    return base + __builtin_popcount(bits & ((1 << s) - 1));
  }
  return S;
}

// [9, S] packed idx*4+case for the 3^3 subm conv's 9 xy offsets.
void subm_tables(const ColMap& cm, const int32_t* colkey,
                 const int32_t* chunk, int32_t n_valid, int32_t S, int D,
                 int H, int W, int32_t* out /* [9*S] */) {
  int nch = nch_of(D);
  int32_t miss = S * 4 + 2;
  for (int o = 0; o < 9; ++o) {
    int dy = o / 3 - 1, dx = o % 3 - 1;
    int32_t* row = out + (int64_t)o * S;
    for (int32_t i = 0; i < n_valid; ++i) {
      int64_t y = colkey[i] / W + dy, x = colkey[i] % W + dx;
      int32_t b, bm;
      bool has = (y >= 0 && y < H && x >= 0 && x < W) &&
                 cm.get(y * W + x, &b, &bm);
      row[i] = resolve_pack(has, b, bm, chunk[i], nch, S);
    }
    for (int32_t i = n_valid; i < S; ++i) row[i] = miss;
  }
}

struct Stage {
  std::vector<int32_t> colkey, chunk;  // [S]; colkey = H*W sentinel invalid
  int32_t n_valid = 0;
  int H = 0, W = 0, D = 0;
};

// Dense per-column z-occupancy bitmasks (uint64; D <= 63 after the +1
// window shift), epoch-stamped like ColMap.
struct ZMask {
  std::vector<uint64_t> m;
  std::vector<int32_t> stamp;
  int32_t epoch = 0;
  int64_t hw = 0;
  void reset(int64_t new_hw) {
    if ((int64_t)stamp.size() < new_hw) {
      m.resize(new_hw);
      stamp.assign(new_hw, 0);
      epoch = 0;
    }
    hw = new_hw;
    ++epoch;
  }
  inline void add(int64_t key, uint64_t bit) {
    if (stamp[key] != epoch) {
      m[key] = 0;
      stamp[key] = epoch;
    }
    m[key] |= bit;
  }
  inline uint64_t get(int64_t key) const {
    if (key < 0 || key >= hw || stamp[key] != epoch) return 0;
    return m[key];
  }
};

// Exact out-site occupancy of the k3/s2/p1 down conv ([S_out] int32 4-bit
// z bitmaps): out z active iff >=1 input z in [2z-1, 2z+1] within the 3x3
// strided footprint (spconv site rule; numpy spec _down_occ_bits).
void down_occ(const ZMask& zin, const Stage& out_st, int H_in, int W_in,
              int32_t S_out, int32_t* occ /* [S_out] */) {
  std::fill(occ, occ + S_out, 0);
  for (int32_t i = 0; i < out_st.n_valid; ++i) {
    int64_t yo = out_st.colkey[i] / out_st.W;
    int64_t xo = out_st.colkey[i] % out_st.W;
    uint64_t acc = 0;
    for (int ky = 0; ky < 3; ++ky) {
      for (int kx = 0; kx < 3; ++kx) {
        int64_t yi = 2 * yo - 1 + ky, xi = 2 * xo - 1 + kx;
        if (yi < 0 || yi >= H_in || xi < 0 || xi >= W_in) continue;
        acc |= zin.get(yi * W_in + xi);
      }
    }
    acc <<= 1;  // bit z+1: window [2z-1, 2z+1] = bits [2z, 2z+2]
    int32_t bitsv = 0;
    for (int zi = 0; zi < CHUNK; ++zi) {
      int zo = CHUNK * out_st.chunk[i] + zi;
      if (zo >= out_st.D) continue;
      if ((acc >> (2 * zo)) & 7ULL) bitsv |= 1 << zi;
    }
    occ[i] = bitsv;
  }
}

// Stage column z-masks from slot occupancy bitmaps.
void stage_zmask(const Stage& st, const int32_t* occ, ZMask* zm) {
  zm->reset((int64_t)st.H * st.W);
  for (int32_t i = 0; i < st.n_valid; ++i) {
    uint64_t m = 0;
    for (int zi = 0; zi < CHUNK; ++zi)
      if ((occ[i] >> zi) & 1) m |= 1ULL << (CHUNK * st.chunk[i] + zi);
    if (m) zm->add(st.colkey[i], m);
  }
}

// Build the dense column map of a stage's sorted slot skeleton.
void build_colmap(const Stage& st, ColMap* cm) {
  cm->reset((int64_t)st.H * st.W);
  int32_t i = 0;
  while (i < st.n_valid) {
    int32_t key = st.colkey[i];
    int32_t base = i, bits = 0;
    while (i < st.n_valid && st.colkey[i] == key) {
      bits |= 1 << st.chunk[i];
      ++i;
    }
    cm->set(key, base, bits);
  }
}

// Down-stage (k3/s2/p1) output skeleton + fwd gather tables; mirrors
// topology_host._down_sites (column-rank cap, then slot-rank cap).
void down_sites(const ColMap& cm_in, const Stage& in, const Stage& out_shape,
                int32_t S_in, int32_t S_out, Stage* out,
                int32_t* a_pack /* [9*S_out] */,
                int32_t* b_idx /* [9*S_out] */) {
  int D = in.D, H = in.H, W = in.W;
  int D2 = out_shape.D, H2 = out_shape.H, W2 = out_shape.W;
  int nch_in = nch_of(D), nch_out = nch_of(D2);

  // out chunk bitmap contributed per input chunk s: out z in [2s, 2s+2]
  int32_t obit_of[16];
  for (int s = 0; s < nch_in; ++s) {
    int lo = 2 * s, hi = std::min(2 * s + 2, D2 - 1);
    int m = 0;
    for (int zo = lo; zo <= hi; ++zo) m |= 1 << (zo / CHUNK);
    obit_of[s] = m;
  }

  // candidate (out column, obits) pairs from each occupied input column
  std::vector<std::pair<int64_t, int32_t>> cand;
  cand.reserve((size_t)in.n_valid * 4);
  {
    int32_t i = 0;
    while (i < in.n_valid) {
      int32_t key = in.colkey[i];
      int32_t obits = 0;
      while (i < in.n_valid && in.colkey[i] == key) {
        obits |= obit_of[in.chunk[i]];
        ++i;
      }
      // NOTE: obits may be 0 (every occupied chunk maps above D2); the
      // numpy planner still emits its candidates — they count toward the
      // column-rank cap — so no skip here (integer exactness).
      int64_t yc = key / W, xc = key % W;
      for (int ay = 0; ay <= 1; ++ay) {
        for (int ax = 0; ax <= 1; ++ax) {
          int64_t yo = (yc + 1) / 2 - ay;
          int64_t xo = (xc + 1) / 2 - ax;
          if (2 * yo + 1 >= yc && yc >= 2 * yo - 1 && 2 * xo + 1 >= xc &&
              xc >= 2 * xo - 1 && yo >= 0 && yo < H2 && xo >= 0 && xo < W2) {
            cand.emplace_back(yo * W2 + xo, obits);
          }
        }
      }
    }
  }
  std::sort(cand.begin(), cand.end(),
            [](const auto& a, const auto& b) { return a.first < b.first; });

  // dedup (OR bitmaps) with column-rank cap, then expand to slots with
  // slot-rank cap — chunks ascending within a column
  out->n_valid = 0;
  int64_t hw2 = (int64_t)H2 * W2;
  out->colkey.assign(S_out, (int32_t)hw2);
  out->chunk.assign(S_out, 0);
  size_t ci = 0;
  int32_t ncols = 0;
  while (ci < cand.size() && ncols < S_out && out->n_valid < S_out) {
    int64_t key = cand[ci].first;
    int32_t bits = 0;
    while (ci < cand.size() && cand[ci].first == key) {
      bits |= cand[ci].second;
      ++ci;
    }
    ++ncols;
    for (int b = 0; b < nch_out && out->n_valid < S_out; ++b) {
      if ((bits >> b) & 1) {
        out->colkey[out->n_valid] = (int32_t)key;
        out->chunk[out->n_valid] = b;
        ++out->n_valid;
      }
    }
  }

  // fwd gather tables into the INPUT slot space
  int32_t miss_a = S_in * 4 + 2;
  for (int o = 0; o < 9; ++o) {
    int ky = o / 3, kx = o % 3;
    int32_t* ra = a_pack + (int64_t)o * S_out;
    int32_t* rb = b_idx + (int64_t)o * S_out;
    for (int32_t i = 0; i < out->n_valid; ++i) {
      int64_t yi = 2LL * (out->colkey[i] / W2) - 1 + ky;
      int64_t xi = 2LL * (out->colkey[i] % W2) - 1 + kx;
      int32_t b, bm;
      bool has = (yi >= 0 && yi < H && xi >= 0 && xi < W) &&
                 cm_in.get(yi * W + xi, &b, &bm);
      ra[i] = resolve_pack(has, b, bm, 2 * out->chunk[i], nch_in, S_in);
      rb[i] = resolve_exact(has, b, bm, 2 * out->chunk[i] + 1, nch_in, S_in);
    }
    for (int32_t i = out->n_valid; i < S_out; ++i) {
      ra[i] = miss_a;
      rb[i] = S_in;
    }
  }
}

// [9, S_in] packed out-row*4+case for the down-conv BACKWARD gather.
void rev_tables(const ColMap& cm_out, const Stage& in, int D2, int H2, int W2,
                int32_t S_in, int32_t S_out, int32_t* out /* [9*S_in] */) {
  int nch_out = nch_of(D2);
  int32_t miss = S_out * 4 + 2;
  for (int o = 0; o < 9; ++o) {
    int ky = o / 3, kx = o % 3;
    int32_t* row = out + (int64_t)o * S_in;
    for (int32_t i = 0; i < in.n_valid; ++i) {
      int64_t ny = (int64_t)(in.colkey[i] / in.W) + 1 - ky;
      int64_t nx = (int64_t)(in.colkey[i] % in.W) + 1 - kx;
      bool ok = (ny % 2 == 0) && (nx % 2 == 0) && ny >= 0 && ny < 2LL * H2 &&
                nx >= 0 && nx < 2LL * W2;
      int32_t b, bm;
      bool has = ok && cm_out.get((ny / 2) * W2 + nx / 2, &b, &bm);
      row[i] = resolve_pack(has, b, bm, in.chunk[i] / 2, nch_out, S_out);
    }
    for (int32_t i = in.n_valid; i < S_in; ++i) row[i] = miss;
  }
}

thread_local ColMap g_cm0, g_cm2, g_cm3;
thread_local ZMask g_zm0, g_zm2;

}  // namespace

extern "C" {

// Plans one frame's full chunked-encoder topology (stages s0, s2, s3).
// coords: [V, 3] int32 (z, y, x), -1 padding, key-sorted. Outputs are
// caller-allocated with the shapes in topology_host.plan_frame_topology
// (s0 arrays sized S0cap). Slots past S0cap are dropped BEFORE table
// building, so tables see the cut voxels as absent — identical to the
// device build at the same slot_cap. Returns the dropped-slot count (>= 0)
// or -1 on error.
int32_t plan_frame_topology_native_v2(
    const int32_t* coords, int64_t V, int32_t S0cap,
    int32_t nx, int32_t ny, int32_t nz,
    int32_t S2, int32_t S3,
    int32_t* ck0, int32_t* ch0, int32_t* src0 /* [S0*4] */,
    int32_t* nbr0 /* [9*S0] */,
    int32_t* ck2, int32_t* ch2, int32_t* a2, int32_t* b2, int32_t* nbr2,
    int32_t* rev2 /* [9*S0] */,
    int32_t* ck3, int32_t* ch3, int32_t* a3, int32_t* b3, int32_t* nbr3,
    int32_t* rev3 /* [9*S2] */,
    int32_t* occ2 /* [S2] */, int32_t* occ3 /* [S3] */) {
  // stage shapes, mirroring VoxelResBackBone8x.__call__
  Stage s0, s2, s3;
  s0.D = nz + 1; s0.H = ny; s0.W = nx;
  s2.D = (s0.D - 1) / 2 + 1; s2.H = (s0.H - 1) / 2 + 1; s2.W = (s0.W - 1) / 2 + 1;
  s3.D = (s2.D - 1) / 2 + 1; s3.H = (s2.H - 1) / 2 + 1; s3.W = (s2.W - 1) / 2 + 1;
  if (nch_of(s2.D) > 8 || nch_of(s3.D) > 8) return -1;  // 3-bit chunk packing

  int32_t S0 = S0cap;
  int64_t hw0 = (int64_t)s0.H * s0.W;

  // slot skeleton + voxel -> slot-z source map. The src0 miss sentinel is
  // V (the appended zero row; consumers test occupancy with `src0 < V`,
  // chunked_from_host) — NOT S0: when the slot cap binds (eval: V=160000 >
  // s0_slot_cap=131072) an S0 fill would mark every empty z-site occupied
  // and gather real voxel #S0's features.
  s0.colkey.assign(S0, (int32_t)hw0);
  s0.chunk.assign(S0, 0);
  std::fill(src0, src0 + (int64_t)S0 * CHUNK, (int32_t)V);
  s0.n_valid = 0;
  int32_t n_dropped = 0;
  bool cur_kept = false;
  int64_t prev_ck = -1;
  int32_t prev_ch = -1;
  g_zm0.reset(hw0);
  for (int64_t v = 0; v < V; ++v) {
    int32_t z = coords[v * 3], y = coords[v * 3 + 1], x = coords[v * 3 + 2];
    if (z < 0) continue;
    int64_t ck = (int64_t)y * s0.W + x;
    int32_t ch = z / CHUNK, zp = z % CHUNK;
    if (ck != prev_ck || ch != prev_ch) {
      if (s0.n_valid < S0) {
        s0.colkey[s0.n_valid] = (int32_t)ck;
        s0.chunk[s0.n_valid] = ch;
        ++s0.n_valid;
        cur_kept = true;
      } else {
        ++n_dropped;
        cur_kept = false;
      }
      prev_ck = ck;
      prev_ch = ch;
    }
    if (cur_kept) {
      src0[(int64_t)(s0.n_valid - 1) * CHUNK + zp] = (int32_t)v;
      g_zm0.add(ck, 1ULL << z);
    }
  }

  build_colmap(s0, &g_cm0);
  subm_tables(g_cm0, s0.colkey.data(), s0.chunk.data(), s0.n_valid, S0, s0.D,
              s0.H, s0.W, nbr0);

  down_sites(g_cm0, s0, s2, S0, S2, &s2, a2, b2);
  build_colmap(s2, &g_cm2);
  subm_tables(g_cm2, s2.colkey.data(), s2.chunk.data(), s2.n_valid, S2, s2.D,
              s2.H, s2.W, nbr2);
  rev_tables(g_cm2, s0, s2.D, s2.H, s2.W, S0, S2, rev2);

  down_sites(g_cm2, s2, s3, S2, S3, &s3, a3, b3);
  build_colmap(s3, &g_cm3);
  subm_tables(g_cm3, s3.colkey.data(), s3.chunk.data(), s3.n_valid, S3, s3.D,
              s3.H, s3.W, nbr3);
  rev_tables(g_cm3, s2, s3.D, s3.H, s3.W, S2, S3, rev3);

  down_occ(g_zm0, s2, s0.H, s0.W, S2, occ2);
  stage_zmask(s2, occ2, &g_zm2);
  down_occ(g_zm2, s3, s2.H, s2.W, S3, occ3);

  std::memcpy(ck0, s0.colkey.data(), (size_t)S0 * 4);
  std::memcpy(ch0, s0.chunk.data(), (size_t)S0 * 4);
  std::memcpy(ck2, s2.colkey.data(), (size_t)S2 * 4);
  std::memcpy(ch2, s2.chunk.data(), (size_t)S2 * 4);
  std::memcpy(ck3, s3.colkey.data(), (size_t)S3 * 4);
  std::memcpy(ch3, s3.chunk.data(), (size_t)S3 * 4);
  return n_dropped;
}

// Back-compat entry (no s0 slot cap): 0 on success, 1 on error.
int32_t plan_frame_topology_native(
    const int32_t* coords, int64_t V, int32_t nx, int32_t ny, int32_t nz,
    int32_t S2, int32_t S3,
    int32_t* ck0, int32_t* ch0, int32_t* src0, int32_t* nbr0,
    int32_t* ck2, int32_t* ch2, int32_t* a2, int32_t* b2, int32_t* nbr2,
    int32_t* rev2,
    int32_t* ck3, int32_t* ch3, int32_t* a3, int32_t* b3, int32_t* nbr3,
    int32_t* rev3) {
  std::vector<int32_t> occ2(S2), occ3(S3);
  int32_t rc = plan_frame_topology_native_v2(
      coords, V, (int32_t)V, nx, ny, nz, S2, S3, ck0, ch0, src0, nbr0, ck2,
      ch2, a2, b2, nbr2, rev2, ck3, ch3, a3, b3, nbr3, rev3, occ2.data(),
      occ3.data());
  return rc < 0 ? 1 : 0;
}

}  // extern "C"

extern "C" {

// Host voxelization + mean VFE (spconv PointToVoxel + MeanVFE semantics,
// xy-major key-sorted output) — C++ version of
// unidistill_tpu/data/voxelize_host.voxelize_mean_sorted. coords rows are
// (z, y, x) with -1 padding. Returns the voxel count.
int64_t voxelize_mean_sorted_native(
    const float* points, int64_t N, int64_t C,
    const float* pc_range /* [6] */, const float* voxel_size /* [3] */,
    int64_t nx, int64_t ny, int64_t nz,
    int64_t max_voxels, int64_t max_points_per_voxel,
    float* feats /* [max_voxels, C] zeroed by callee */,
    int32_t* coords /* [max_voxels, 3] */) {
  std::fill(feats, feats + max_voxels * C, 0.0f);
  std::fill(coords, coords + max_voxels * 3, -1);

  struct Entry {
    int64_t key;
    int32_t idx;
  };
  std::vector<Entry> ent;
  ent.reserve((size_t)N);
  for (int64_t i = 0; i < N; ++i) {
    const float* p = points + i * C;
    int64_t vx = (int64_t)std::floor((p[0] - pc_range[0]) / voxel_size[0]);
    int64_t vy = (int64_t)std::floor((p[1] - pc_range[1]) / voxel_size[1]);
    int64_t vz = (int64_t)std::floor((p[2] - pc_range[2]) / voxel_size[2]);
    if (vx < 0 || vx >= nx || vy < 0 || vy >= ny || vz < 0 || vz >= nz)
      continue;
    ent.push_back({(vy * nx + vx) * nz + vz, (int32_t)i});
  }
  std::stable_sort(ent.begin(), ent.end(),
                   [](const Entry& a, const Entry& b) { return a.key < b.key; });

  int64_t nv = 0;
  size_t i = 0;
  std::vector<double> acc((size_t)C);
  while (i < ent.size() && nv < max_voxels) {
    int64_t key = ent[i].key;
    std::fill(acc.begin(), acc.end(), 0.0);
    int64_t n = 0;
    size_t j = i;
    while (j < ent.size() && ent[j].key == key) {
      if (n < max_points_per_voxel) {
        const float* p = points + (int64_t)ent[j].idx * C;
        for (int64_t c = 0; c < C; ++c) acc[c] += p[c];
        ++n;
      }
      ++j;
    }
    float* f = feats + nv * C;
    for (int64_t c = 0; c < C; ++c) f[c] = (float)(acc[c] / (double)n);
    coords[nv * 3 + 0] = (int32_t)(key % nz);
    coords[nv * 3 + 1] = (int32_t)(key / nz / nx);
    coords[nv * 3 + 2] = (int32_t)(key / nz % nx);
    ++nv;
    i = j;
  }
  return nv;
}

}  // extern "C"
