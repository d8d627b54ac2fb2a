"""Host-side data transforms, numpy + PIL; the port's copy of the JAX
package's `data/transforms.py`. As there, the sweeps' transform runs in the
host C++ library (`data/native.py`); `normalize_image` here is the numpy
version (the dataset calls `native.normalize_image`).

ref unidistill/data/multisensorfusion/transforms3d.py and functional.py:
  * CollectLidarSweeps — ego-motion chain of 10 sweeps into the key frame with
    a relative-timestamp channel (transforms3d.py:379-414);
  * ImageAffineTransformation (IDA) — resize/crop/flip/rotate + the 4×4 matrix
    (transforms3d.py:298-347; functional.py:560-593);
  * BevAffineTransformation (BDA) — rot/scale/trans/flip of boxes + points,
    matrix kept for the camera branch (transforms3d.py:417-443;
    functional.py:595-646);
  * ObjectRangeFilter — xy point mask + corner-in-range box mask
    (transforms3d.py:242-287);
  * ImageNormalize — (x - mean)/std with the reference's channel-swap quirk
    (mmcv.imnormalize(to_rgb=True) on already-RGB input flips to BGR; kept
    behind `swap_channels` for checkpoint parity, transforms3d.py:350-368).

The GT-sampling path is absent, as in the JAX package: the reference's
`GTSampling` references an undefined `DataBaseSampler` and every active exp
disables it.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
from PIL import Image

from unidistill_torch.data import native


def quaternion_rotation_matrix(q) -> np.ndarray:
    """[w, x, y, z] → 3×3 rotation matrix (replaces pyquaternion)."""
    w, x, y, z = np.asarray(q, dtype=np.float64)
    n = w * w + x * x + y * y + z * z
    s = 0.0 if n < 1e-12 else 2.0 / n
    wx, wy, wz = s * w * x, s * w * y, s * w * z
    xx, xy, xz = s * x * x, s * x * y, s * x * z
    yy, yz, zz = s * y * y, s * y * z, s * z * z
    return np.array(
        [
            [1 - (yy + zz), xy - wz, xz + wy],
            [xy + wz, 1 - (xx + zz), yz - wx],
            [xz - wy, yz + wx, 1 - (xx + yy)],
        ]
    )


def collect_lidar_sweeps(
    points: np.ndarray,
    sweeps: list,
    key_lidar_to_ego: np.ndarray,
    key_ego_to_global: np.ndarray,
    key_timestamp: float,
    sweep_infos: list,
) -> np.ndarray:
    """Aggregate sweeps into key-frame coords (ref transforms3d.py:379-414).
    points [N, 5]; each sweep [M, 5]; sweep_infos: dicts with
    'sweep_lidar_to_ego' (inv car_from_global — the reference's naming is off,
    it is actually sweep ego_to_global) and 'sweep_lidar_timestamp'."""
    all_points = points.copy()
    if all_points.shape[-1] == 5:
        all_points[:, -1] = 0.0
    out = [all_points]
    inv_key_l2e = np.linalg.inv(key_lidar_to_ego)
    inv_key_e2g = np.linalg.inv(key_ego_to_global)
    for frame, info in zip(sweeps, sweep_infos):
        m = inv_key_l2e @ inv_key_e2g @ info["sweep_lidar_to_ego"] @ key_lidar_to_ego
        dt = (key_timestamp - info["sweep_lidar_timestamp"]) / 1e6
        frame = np.array(frame, np.float32)
        if frame.shape[-1] == 5:
            out.append(native.transform_points(frame, m, dt))
            continue
        hom = np.ones((frame.shape[0], 4))
        hom[:, :3] = frame[:, :3]
        frame[:, :3] = (m @ hom.T).T[:, :3].astype(np.float32)
        out.append(frame)
    return np.concatenate(out, axis=0)


def sample_ida_augs(
    rng: np.random.RandomState,
    src_hw: Tuple[int, int],
    final_dim: Tuple[int, int],
    resize_lim: Tuple[float, float],
    rot_lim: Tuple[float, float],
    rand_flip: bool,
    bot_pct_lim: Tuple[float, float],
    is_train: bool,
):
    """ref transforms3d.py:304-329."""
    H, W = src_hw
    fH, fW = final_dim
    if is_train:
        resize = rng.uniform(*resize_lim)
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - rng.uniform(*bot_pct_lim)) * newH) - fH
        crop_w = int(rng.uniform(0, max(0, newW - fW)))
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = bool(rand_flip and rng.choice([0, 1]))
        rotate = rng.uniform(*rot_lim)
    else:
        resize = max(fH / H, fW / W)
        resize_dims = (int(W * resize), int(H * resize))
        newW, newH = resize_dims
        crop_h = int((1 - np.mean(bot_pct_lim)) * newH) - fH
        crop_w = int(max(0, newW - fW) / 2)
        crop = (crop_w, crop_h, crop_w + fW, crop_h + fH)
        flip = False
        rotate = 0.0
    return resize, resize_dims, crop, flip, rotate


def _aff3(A=None, b=(0.0, 0.0)) -> np.ndarray:
    """2D affine op as a 3×3 homogeneous matrix."""
    M = np.eye(3)
    if A is not None:
        M[:2, :2] = A
    M[:2, 2] = b
    return M


def img_transform(img: Image.Image, resize, resize_dims, crop, flip, rotate):
    """PIL image aug + 4×4 IDA matrix.

    The matrix is the composition of the four pixel-space ops applied to the
    image, each written as a homogeneous affine and left-multiplied in
    application order — numerically identical to the reference's running
    (rot, tran) accumulation (ref functional.py:560-593; equivalence
    oracle-tested in tests/test_data_pipeline.py)."""
    img = img.resize(resize_dims).crop(crop)
    if flip:
        img = img.transpose(method=Image.FLIP_LEFT_RIGHT)
    img = img.rotate(rotate)

    cw, ch = crop[2] - crop[0], crop[3] - crop[1]
    M = _aff3(np.eye(2) * resize)                       # scale about origin
    M = _aff3(b=(-crop[0], -crop[1])) @ M               # crop translation
    if flip:
        M = _aff3(np.diag([-1.0, 1.0]), (cw, 0.0)) @ M  # mirror in crop box
    ang = np.deg2rad(rotate)
    R = np.array([[np.cos(ang), np.sin(ang)],
                  [-np.sin(ang), np.cos(ang)]])
    ctr = np.array([cw, ch]) / 2.0
    M = _aff3(R, ctr - R @ ctr) @ M                     # rotate about center

    ida_mat = np.eye(4)
    ida_mat[:2, :2] = M[:2, :2]
    ida_mat[:2, 3] = M[:2, 2]
    return img, ida_mat


def bev_transform(gt_boxes, rotate_deg, scale_ratio, trans, flip_dx, flip_dy):
    """BDA on boxes; returns (boxes, 4×4 matrix) (ref functional.py:595-646)."""
    ang = rotate_deg / 180 * np.pi
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]])
    scale = np.diag([scale_ratio, scale_ratio, scale_ratio, 1.0])
    tr = np.eye(4)
    tr[:3, 3] = trans
    flip = np.eye(4)
    if flip_dx:
        flip = flip @ np.diag([-1.0, 1, 1, 1])
    if flip_dy:
        flip = flip @ np.diag([1.0, -1, 1, 1])
    m = flip @ tr @ scale @ rot
    gt_boxes = gt_boxes.copy()
    if gt_boxes.shape[0] > 0:
        hom = np.ones((gt_boxes.shape[0], 4))
        hom[:, :3] = gt_boxes[:, :3]
        gt_boxes[:, :3] = (m @ hom.T).T[:, :3]
        gt_boxes[:, 3:6] *= scale_ratio
        gt_boxes[:, 6] += ang
        if flip_dx:
            gt_boxes[:, 6] = np.pi - gt_boxes[:, 6]
        if flip_dy:
            gt_boxes[:, 6] = -gt_boxes[:, 6]
        if gt_boxes.shape[1] > 7:
            gt_boxes[:, 7:9] = (m[:2, :2] @ gt_boxes[:, 7:9].T).T
    return gt_boxes, m


def apply_bda_to_points(points: np.ndarray, m: np.ndarray) -> np.ndarray:
    pts = points.copy()
    hom = np.ones((pts.shape[0], 4))
    hom[:, :3] = pts[:, :3]
    pts[:, :3] = (m @ hom.T).T[:, :3]
    return pts


def _corners_3d(centers, dims, angles):
    """[N, 8, 3] box corners, z-axis yaw, origin at center."""
    template = (
        np.array(
            [
                [-1, -1, -1], [-1, -1, 1], [-1, 1, -1], [-1, 1, 1],
                [1, -1, -1], [1, -1, 1], [1, 1, -1], [1, 1, 1],
            ],
            dtype=np.float64,
        )
        * 0.5
    )
    corners = dims[:, None, :] * template[None]
    c, s = np.cos(angles), np.sin(angles)
    rot = np.stack(
        [
            np.stack([c, -s, np.zeros_like(c)], -1),
            np.stack([s, c, np.zeros_like(c)], -1),
            np.stack([np.zeros_like(c), np.zeros_like(c), np.ones_like(c)], -1),
        ],
        axis=1,
    )  # [N, 3, 3]
    corners = np.einsum("nij,nkj->nki", rot, corners)
    return corners + centers[:, None, :]


def object_range_filter(
    points: Optional[np.ndarray],
    gt_boxes: Optional[np.ndarray],
    gt_labels: Optional[np.ndarray],
    pc_range,
    is_train: bool,
):
    """ref transforms3d.py:242-287 (xy mask for points; ≥1-corner-in-range for
    boxes, train only)."""
    pc_range = np.asarray(pc_range, np.float32)
    if points is not None:
        m = (
            (points[:, 0] >= pc_range[0])
            & (points[:, 0] <= pc_range[3])
            & (points[:, 1] >= pc_range[1])
            & (points[:, 1] <= pc_range[4])
        )
        points = points[m]
    if gt_boxes is not None and len(gt_boxes) > 0 and is_train:
        corners = _corners_3d(gt_boxes[:, :3], gt_boxes[:, 3:6], gt_boxes[:, 6])
        ok = ((corners >= pc_range[0:3]) & (corners <= pc_range[3:6])).all(axis=2)
        mask = ok.sum(axis=1) >= 1
        gt_boxes = gt_boxes[mask]
        if gt_labels is not None:
            gt_labels = gt_labels[mask]
    return points, gt_boxes, gt_labels


def normalize_image(
    img: np.ndarray, mean, std, swap_channels: bool = True
) -> np.ndarray:
    """(img - mean) / std. `swap_channels=True` replicates the reference's
    mmcv.imnormalize(to_rgb=True) BGR↔RGB flip applied to already-RGB input
    (transforms3d.py:361) — training and checkpoints are consistent with it."""
    img = np.asarray(img, np.float32)
    if swap_channels:
        img = img[..., ::-1]
    return (img - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
