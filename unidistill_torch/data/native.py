"""ctypes bindings of the host C++ library (`csrc/host/pointprep.cc`,
`csrc/host/topology.cc`); the port's counterpart of the JAX package's
`data/native.py`.

The library replaces the reference's numba geometry kernels and numpy hot
loops in the data-loader workers. It is built from the port's own sources
with the host `c++` at first use (`kernels.build.host_library`); a failed
build or load raises: there is no fallback. The one dispatch left is the
JAX rule of `normalize_image`, whose C++ path takes `uint8` images only
(others take the numpy path).

Each function keeps its plain version, numpy or torch, beside it (the
`*_plain` functions, and `HostVoxelizer.plain`); the tests hold each
against the other and against the JAX package's library:

  transform_points            4×4 transform of [N, 5] sweep points + Δt
  range_filter_pad            xy range filter, padded to a cap
  points_in_rbbox             points in rotated BEV boxes [M, N]
  HostVoxelizer               first-occurrence voxeliser (spconv order)
  voxelize_mean_sorted_native voxels + mean VFE, xy-major key order (the
                              loader's voxeliser, `ops.voxelize.voxelize_frame`)
  plan_frame_topology_native  the chunked encoder's topology planner
                              (`data.topology_host.plan_frame_topology`)
  normalize_image             (img − mean) / std with the channel swap
  available                   True once the library is built and loaded
"""
from __future__ import annotations

import ctypes
from typing import Dict, Tuple

import numpy as np
import torch

from unidistill_torch.kernels.build import host_library

_F = ctypes.POINTER(ctypes.c_float)
_D = ctypes.POINTER(ctypes.c_double)
_I32 = ctypes.POINTER(ctypes.c_int32)
_I64 = ctypes.POINTER(ctypes.c_int64)
_U8 = ctypes.POINTER(ctypes.c_uint8)
_L = ctypes.c_int64
# name -> (restype, argtypes)
SIGNATURES = {
    "transform_points_4x4": (None, [_F, _L, _D, ctypes.c_double]),
    "range_filter_pad": (_L, [_F, _L, _D, _F, _U8, _L]),
    "points_in_rbbox": (None, [_F, _L, _L, _F, _L, _U8]),
    "voxelize_first_occurrence": (_L, [_F, _L, _L, _D, _D, _I64, _L, _L, _F, _I32, _I32, _I32]),
    "normalize_image_u8": (None, [_U8, _L, _F, _F, ctypes.c_int, _F]),
    "plan_frame_topology_native_v2": (ctypes.c_int32, [_I32, _L] + [ctypes.c_int32] * 6 + [_I32] * 18),
    "voxelize_mean_sorted_native": (_L, [_F, _L, _L, _F, _F] + [_L] * 5 + [_F, _I32]),
}
_BOUND = False


def _lib() -> ctypes.CDLL:
    global _BOUND
    lib = host_library()
    if not _BOUND:
        for name, (restype, argtypes) in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = restype, argtypes
        _BOUND = True
    return lib


def _p(a: np.ndarray, ptype):
    return a.ctypes.data_as(ptype)


def available() -> bool:
    """True once the library is built and loaded; a failure raises."""
    _lib()
    return True


# ---- sweeps ------------------------------------------------------------------------


def transform_points(points: np.ndarray, m: np.ndarray, dt: float) -> np.ndarray:
    """[N, 5] points (float32, transformed in place when already contiguous
    float32) by the 4×4 `m`, the last channel set to `dt`."""
    points = np.ascontiguousarray(points, np.float32)
    m = np.ascontiguousarray(m, np.float64)
    _lib().transform_points_4x4(_p(points, _F), points.shape[0], _p(m, _D), float(dt))
    return points


def transform_points_plain(points: np.ndarray, m: np.ndarray, dt: float) -> np.ndarray:
    points = np.ascontiguousarray(points, np.float32)
    hom = np.ones((points.shape[0], 4))
    hom[:, :3] = points[:, :3]
    points[:, :3] = (m @ hom.T).T[:, :3].astype(np.float32)
    points[:, 4] = dt
    return points


def range_filter_pad(points: np.ndarray, pc_range, cap: int) -> Tuple[np.ndarray, np.ndarray, int]:
    """The [N, 5] points inside the xy range, in order, padded to [cap, 5]:
    (padded, mask [cap], kept)."""
    points = np.ascontiguousarray(points, np.float32)
    out = np.empty((cap, 5), np.float32)
    mask = np.empty(cap, np.uint8)
    rng = np.ascontiguousarray(pc_range, np.float64)
    n = _lib().range_filter_pad(_p(points, _F), points.shape[0], _p(rng, _D), _p(out, _F), _p(mask, _U8), cap)
    return out, mask.astype(bool), int(n)


def range_filter_pad_plain(points: np.ndarray, pc_range, cap: int) -> Tuple[np.ndarray, np.ndarray, int]:
    points = np.ascontiguousarray(points, np.float32)
    m = ((points[:, 0] >= pc_range[0]) & (points[:, 0] <= pc_range[3])
         & (points[:, 1] >= pc_range[1]) & (points[:, 1] <= pc_range[4]))
    kept = points[m][:cap]
    out = np.zeros((cap, points.shape[1]), np.float32)
    out[: len(kept)] = kept
    mask = np.zeros(cap, bool)
    mask[: len(kept)] = True
    return out, mask, len(kept)


def points_in_rbbox(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    """[M, N] bool: point n inside BEV box m (boxes [M, >= 7])."""
    points = np.ascontiguousarray(points, np.float32)
    boxes = np.ascontiguousarray(boxes[:, :7], np.float32)
    out = np.empty((boxes.shape[0], points.shape[0]), np.uint8)
    _lib().points_in_rbbox(_p(points, _F), points.shape[0], points.shape[1], _p(boxes, _F), boxes.shape[0],
                           _p(out, _U8))
    return out.astype(bool)


def points_in_rbbox_plain(points: np.ndarray, boxes: np.ndarray) -> np.ndarray:
    points = np.asarray(points, np.float32)
    boxes = np.asarray(boxes[:, :7], np.float32)
    px = points[None, :, 0] - boxes[:, None, 0]
    py = points[None, :, 1] - boxes[:, None, 1]
    c, s = np.cos(-boxes[:, None, 6]), np.sin(-boxes[:, None, 6])
    lx, ly = px * c - py * s, px * s + py * c
    return (np.abs(lx) <= boxes[:, None, 3] / 2) & (np.abs(ly) <= boxes[:, None, 4] / 2)


# ---- voxels ------------------------------------------------------------------------


class HostVoxelizer:
    """Reference-exact first-occurrence voxeliser (spconv PointToVoxel
    semantics): (voxels [V, max_pts, C], coords [V, 3] (z, y, x),
    points a voxel [V]) in first-occurrence order."""

    def __init__(self, pc_range, voxel_size, grid, max_voxels: int, max_pts: int):
        self.pc_range = np.ascontiguousarray(pc_range, np.float64)
        self.voxel_size = np.ascontiguousarray(voxel_size, np.float64)
        self.grid = np.ascontiguousarray(grid, np.int64)
        self.max_voxels, self.max_pts = max_voxels, max_pts
        self._hash = np.full(int(np.prod(grid)), -1, np.int32)

    def _buffers(self, points):
        C = points.shape[1]
        return (np.empty((self.max_voxels, self.max_pts, C), np.float32),
                np.empty((self.max_voxels, 3), np.int32), np.empty(self.max_voxels, np.int32))

    def __call__(self, points: np.ndarray):
        points = np.ascontiguousarray(points, np.float32)
        voxels, coords, npts = self._buffers(points)
        nv = int(_lib().voxelize_first_occurrence(
            _p(points, _F), points.shape[0], points.shape[1], _p(self.pc_range, _D), _p(self.voxel_size, _D),
            _p(self.grid, _I64), self.max_voxels, self.max_pts, _p(voxels, _F), _p(coords, _I32),
            _p(npts, _I32), _p(self._hash, _I32)))
        return voxels[:nv], coords[:nv], npts[:nv]

    def plain(self, points: np.ndarray):
        points = np.ascontiguousarray(points, np.float32)
        voxels, coords, npts = self._buffers(points)
        voxels[:] = 0
        npts[:] = 0
        nv, lut = 0, {}
        vc = np.floor((points[:, :3] - self.pc_range[:3]) / self.voxel_size).astype(int)
        ok = ((vc >= 0) & (vc < self.grid[None, :])).all(1)
        for i in np.nonzero(ok)[0]:
            key = (vc[i, 2], vc[i, 1], vc[i, 0])
            v = lut.get(key)
            if v is None:
                if nv >= self.max_voxels:
                    continue
                v = lut[key] = nv
                coords[v] = key
                nv += 1
            if npts[v] < self.max_pts:
                voxels[v, npts[v]] = points[i]
                npts[v] += 1
        return voxels[:nv], coords[:nv], npts[:nv]


def voxelize_mean_sorted_native(points: np.ndarray, pc_range, voxel_size, grid_size, max_voxels: int,
                                max_points_per_voxel: int) -> Tuple[np.ndarray, np.ndarray]:
    """Voxels + mean VFE of [N, C] points: (feats [max_voxels, C] float32,
    coords [max_voxels, 3] int32 (z, y, x), -1 on unused slots), voxels in
    ascending xy-major key order, each the mean (summed in float64) of its
    first `max_points_per_voxel` points."""
    points = np.ascontiguousarray(points, np.float32)
    C = points.shape[1]
    nx, ny, nz = (int(g) for g in grid_size)
    feats = np.empty((max_voxels, C), np.float32)
    coords = np.empty((max_voxels, 3), np.int32)
    pcr = np.ascontiguousarray(pc_range, np.float32)
    vsz = np.ascontiguousarray(voxel_size, np.float32)
    _lib().voxelize_mean_sorted_native(_p(points, _F), points.shape[0], C, _p(pcr, _F), _p(vsz, _F), nx, ny, nz,
                                       max_voxels, max_points_per_voxel, _p(feats, _F), _p(coords, _I32))
    return feats, coords


def voxelize_mean_sorted_plain(points: np.ndarray, pc_range, voxel_size, grid_size, max_voxels: int,
                               max_points_per_voxel: int) -> Tuple[np.ndarray, np.ndarray]:
    """The same by `ops.voxelize.voxelize` on the CPU (means summed in
    float32: within 1e-6 of the library's)."""
    from unidistill_torch.ops.voxelize import voxelize

    pts = torch.from_numpy(np.ascontiguousarray(points, np.float32))[None]
    feats, coords = voxelize(pts, torch.ones(pts.shape[:2], dtype=torch.bool), pc_range, voxel_size, grid_size,
                             max_voxels, max_points_per_voxel)
    return feats[0].numpy(), coords[0].numpy()


# ---- topology ----------------------------------------------------------------------


def plan_frame_topology_native(coords: np.ndarray, grid_size, stage_caps, s0_cap=None) -> Dict[str, np.ndarray]:
    """The chunked encoder's topology of one frame (the JAX planner's keys,
    the reverse tables `rev2`, `rev3` included), integer-equal to the numpy
    planner; `s0_dropped` counts the slots the s0 cap cut."""
    coords = np.ascontiguousarray(coords, np.int32)
    V = coords.shape[0]
    S0 = V if s0_cap is None else min(V, int(s0_cap))
    S2, S3 = int(stage_caps[0]), int(stage_caps[1])
    nx, ny, nz = (int(g) for g in grid_size)
    shapes = dict(ck0=S0, ch0=S0, src0=(S0, 4), nbr0=(9, S0), ck2=S2, ch2=S2, a2=(9, S2), b2=(9, S2),
                  nbr2=(9, S2), rev2=(9, S0), ck3=S3, ch3=S3, a3=(9, S3), b3=(9, S3), nbr3=(9, S3),
                  rev3=(9, S2), occ2=S2, occ3=S3)
    out = {k: np.empty(s, np.int32) for k, s in shapes.items()}
    rc = _lib().plan_frame_topology_native_v2(_p(coords, _I32), V, S0, nx, ny, nz, S2, S3,
                                              *(_p(out[k], _I32) for k in shapes))
    if rc < 0:
        raise RuntimeError(f"the native topology planner failed ({rc})")
    out["s0_dropped"] = np.int32(rc)
    return out


def plan_frame_topology_plain(coords: np.ndarray, grid_size, stage_caps, s0_cap=None) -> Dict[str, np.ndarray]:
    """The port's numpy planner (`data.topology_host.plan_frame_topology_numpy`:
    every table but the reverse ones)."""
    from unidistill_torch.data.topology_host import plan_frame_topology_numpy

    return plan_frame_topology_numpy(coords, grid_size, stage_caps, s0_cap=s0_cap)


# ---- images ------------------------------------------------------------------------


def normalize_image(img: np.ndarray, mean, std, swap_channels: bool = True) -> np.ndarray:
    """(img − mean) / std of an [H, W, 3] image as float32, the channels
    reversed first with `swap_channels`; the library multiplies by 1/std.
    Non-`uint8` images take the numpy path (the JAX rule)."""
    if img.dtype != np.uint8:
        return normalize_image_plain(img, mean, std, swap_channels)
    img = np.ascontiguousarray(img)
    out = np.empty(img.shape, np.float32)
    mean = np.ascontiguousarray(mean, np.float32)
    stdinv = np.ascontiguousarray(1.0 / np.asarray(std, np.float32), np.float32)
    _lib().normalize_image_u8(_p(img, _U8), img.shape[0] * img.shape[1], _p(mean, _F), _p(stdinv, _F),
                              1 if swap_channels else 0, _p(out, _F))
    return out


def normalize_image_plain(img: np.ndarray, mean, std, swap_channels: bool = True) -> np.ndarray:
    from unidistill_torch.data.transforms import normalize_image as numpy_normalize

    return numpy_normalize(img, mean, std, swap_channels)
