// The port's copy of the JAX package's runtime/pointprep.cc, built by
// unidistill_torch/kernels/build.py (host_library) and bound by
// unidistill_torch/data/native.py.
//
// Host-side point-cloud preparation kernels (C++, ctypes ABI).
//
// TPU-native replacement for the reference's host hot loops: the numba-JIT
// geometry kernels (ref unidistill/data/multisensorfusion/functional.py:51-441)
// and the per-sweep numpy matmul chain in CollectLidarSweeps
// (ref transforms3d.py:379-414). These run in dataloader workers on the CPU
// critical path; C++ with tight loops beats numpy temporaries ~3-10x and
// removes the numba dependency entirely.
//
// ABI: plain C functions over float32 row-major buffers (ctypes-friendly).

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// Transform sweep points into the key frame and write the relative-timestamp
// channel. points: [n, 5] (x, y, z, intensity, ts) modified in place.
// m: row-major 4x4.
void transform_points_4x4(float* pts, int64_t n, const double* m, double dt) {
  for (int64_t i = 0; i < n; ++i) {
    float* p = pts + i * 5;
    const double x = p[0], y = p[1], z = p[2];
    p[0] = static_cast<float>(m[0] * x + m[1] * y + m[2] * z + m[3]);
    p[1] = static_cast<float>(m[4] * x + m[5] * y + m[6] * z + m[7]);
    p[2] = static_cast<float>(m[8] * x + m[9] * y + m[10] * z + m[11]);
    p[4] = static_cast<float>(dt);
  }
}

// xy range filter + pad into a fixed [cap, 5] buffer. Returns number kept
// (<= cap). out must be zero-initialised by the caller or will be cleared.
int64_t range_filter_pad(const float* pts, int64_t n, const double* range,
                         float* out, uint8_t* mask, int64_t cap) {
  std::memset(out, 0, sizeof(float) * cap * 5);
  std::memset(mask, 0, cap);
  const float x0 = static_cast<float>(range[0]), y0 = static_cast<float>(range[1]);
  const float x1 = static_cast<float>(range[3]), y1 = static_cast<float>(range[4]);
  int64_t k = 0;
  for (int64_t i = 0; i < n && k < cap; ++i) {
    const float* p = pts + i * 5;
    if (p[0] >= x0 && p[0] <= x1 && p[1] >= y0 && p[1] <= y1) {
      std::memcpy(out + k * 5, p, sizeof(float) * 5);
      mask[k] = 1;
      ++k;
    }
  }
  return k;
}

// Points-in-rotated-bev-boxes test (numba points_in_rbbox replacement,
// ref functional.py:316-441). boxes: [m, 7] (x, y, z, dx, dy, dz, yaw).
// out: [m, n] uint8.
void points_in_rbbox(const float* pts, int64_t n, int64_t stride,
                     const float* boxes, int64_t m, uint8_t* out) {
  for (int64_t b = 0; b < m; ++b) {
    const float cx = boxes[b * 7 + 0], cy = boxes[b * 7 + 1];
    const float hx = boxes[b * 7 + 3] * 0.5f, hy = boxes[b * 7 + 4] * 0.5f;
    const float c = std::cos(-boxes[b * 7 + 6]), s = std::sin(-boxes[b * 7 + 6]);
    uint8_t* row = out + b * n;
    for (int64_t i = 0; i < n; ++i) {
      const float px = pts[i * stride] - cx;
      const float py = pts[i * stride + 1] - cy;
      const float lx = px * c - py * s;
      const float ly = px * s + py * c;
      row[i] = (std::fabs(lx) <= hx && std::fabs(ly) <= hy) ? 1 : 0;
    }
  }
}

// Reference-exact host voxelizer (spconv PointToVoxel semantics: voxels in
// FIRST-OCCURRENCE order, first max_pts points kept per voxel). Used for
// golden tests of the device voxelizer and for CPU eval pipelines.
// Returns the number of voxels. coords_out: [max_voxels, 3] (z, y, x).
int64_t voxelize_first_occurrence(
    const float* pts, int64_t n, int64_t nfeat, const double* pc_range,
    const double* voxel_size, const int64_t* grid,  // (nx, ny, nz)
    int64_t max_voxels, int64_t max_pts,
    float* voxels_out,   // [max_voxels, max_pts, nfeat]
    int32_t* coords_out, // [max_voxels, 3]
    int32_t* npts_out,   // [max_voxels]
    int32_t* hash_tmp    // [nx*ny*nz] scratch, must be -1-initialised
) {
  const int64_t nx = grid[0], ny = grid[1], nz = grid[2];
  std::memset(voxels_out, 0, sizeof(float) * max_voxels * max_pts * nfeat);
  std::memset(npts_out, 0, sizeof(int32_t) * max_voxels);
  int64_t nv = 0;
  for (int64_t i = 0; i < n; ++i) {
    const float* p = pts + i * nfeat;
    const int64_t ix = static_cast<int64_t>(
        std::floor((p[0] - pc_range[0]) / voxel_size[0]));
    const int64_t iy = static_cast<int64_t>(
        std::floor((p[1] - pc_range[1]) / voxel_size[1]));
    const int64_t iz = static_cast<int64_t>(
        std::floor((p[2] - pc_range[2]) / voxel_size[2]));
    if (ix < 0 || ix >= nx || iy < 0 || iy >= ny || iz < 0 || iz >= nz)
      continue;
    const int64_t key = (iz * ny + iy) * nx + ix;
    int32_t v = hash_tmp[key];
    if (v < 0) {
      if (nv >= max_voxels) continue;
      v = static_cast<int32_t>(nv++);
      hash_tmp[key] = v;
      coords_out[v * 3 + 0] = static_cast<int32_t>(iz);
      coords_out[v * 3 + 1] = static_cast<int32_t>(iy);
      coords_out[v * 3 + 2] = static_cast<int32_t>(ix);
    }
    if (npts_out[v] < max_pts) {
      std::memcpy(voxels_out + (static_cast<int64_t>(v) * max_pts +
                                npts_out[v]) * nfeat,
                  p, sizeof(float) * nfeat);
      npts_out[v] += 1;
    }
  }
  // reset scratch for reuse
  for (int64_t v = 0; v < nv; ++v) {
    const int64_t key =
        (static_cast<int64_t>(coords_out[v * 3 + 0]) * ny +
         coords_out[v * 3 + 1]) * nx + coords_out[v * 3 + 2];
    hash_tmp[key] = -1;
  }
  return nv;
}

// Image normalization: (img - mean) / std with optional channel swap
// (the reference's mmcv.imnormalize(to_rgb=True) quirk, transforms3d.py:361).
void normalize_image_u8(const uint8_t* img, int64_t hw, const float* mean,
                        const float* stdinv, int swap, float* out) {
  for (int64_t i = 0; i < hw; ++i) {
    const uint8_t* p = img + i * 3;
    float c0 = p[0], c1 = p[1], c2 = p[2];
    if (swap) { const float t = c0; c0 = c2; c2 = t; }
    out[i * 3 + 0] = (c0 - mean[0]) * stdinv[0];
    out[i * 3 + 1] = (c1 - mean[1]) * stdinv[1];
    out[i * 3 + 2] = (c2 - mean[2]) * stdinv[2];
  }
}

}  // extern "C"
