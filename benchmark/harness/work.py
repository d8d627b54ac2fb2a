"""The table of peaks and the work of each measured op, counted from the
configuration's shapes and the cell's inputs, never from the op's arguments,
so that it reads the same whatever implements the op.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense): 989 TFLOP/s in
bf16 on the tensor cores, 67 TFLOP/s in float32 outside them, 3.35 TB/s of
HBM. A bound is max(bytes / bandwidth, operations / peak)."""
from __future__ import annotations

from contextlib import contextmanager
from typing import Callable, Dict, Iterator, List, Tuple


PEAKS = {"bf16_flops": 989e12, "f32_flops": 67e12, "hbm_bytes": 3.35e12}


def bound_s(bytes_: float, flops: float, peak_flops: float) -> float:
    return max(bytes_ / PEAKS["hbm_bytes"], flops / peak_flops)


def bev_pool_work(camera_cfg, batch: int, backward: bool) -> Tuple[float, float]:
    """(bytes, flops) of the BEV pool of one batch: the points' cells
    (int32), depth probabilities and context read once and the BEV map
    written once, 2 operations a point and channel; the backward reads the
    map's gradient, depth, context and cells once and writes the two
    gradients once, 4 operations a point and channel."""
    n, (fh, fw), D, C = camera_cfg.num_cams, camera_cfg.feat_hw, camera_cfg.depth_channels, camera_cfg.output_channels
    ny, nx = camera_cfg.bev_hw
    points = batch * n * D * fh * fw
    cells, depth = 4 * points, 4 * points
    context = 4 * batch * n * fh * fw * C
    bev = 4 * batch * ny * nx * C
    if not backward:
        return cells + depth + context + bev, 2.0 * points * C
    return bev + cells + 2 * (depth + context), 4.0 * points * C


def sparse_conv_work(convs: List[Dict]) -> Tuple[float, float]:
    """(bytes, flops) of sparse convolutions in bf16, each given as {pairs,
    n_in, n_out, taps, cin, cout}: the input features, the weight and the
    rulebook read once, the output written once; 2 operations a neighbour
    pair present and channel pair."""
    bytes_ = flops = 0.0
    for c in convs:
        bytes_ += 2 * c["n_in"] * c["cin"] + 2 * c["taps"] * c["cin"] * c["cout"] \
            + 4 * c["n_out"] * c["taps"] + 2 * c["n_out"] * c["cout"]
        flops += 2.0 * c["pairs"] * c["cin"] * c["cout"]
    return bytes_, flops


@contextmanager
def count_sparse_convs(counter=None) -> Iterator[List[Dict]]:
    """Record every reference sparse convolution run inside the block: its
    neighbour pairs present, site counts, taps and channels, and (given a
    running `FlopCounterMode`) the FLOPs that counter gave it."""
    from benchmark.reference import lidar_encoder, sparse

    log: List[Dict] = []
    plain = sparse.sparse_conv

    def counted(features, nbr, weight, bias=None):
        before = counter.get_total_flops() if counter is not None else 0
        out = plain(features, nbr, weight, bias)
        log.append(dict(pairs=int((nbr >= 0).sum()), n_in=features.shape[0], n_out=nbr.shape[0],
                        taps=weight.shape[0], cin=weight.shape[1], cout=weight.shape[2],
                        counted=(counter.get_total_flops() if counter is not None else 0) - before))
        return out
    # the reference's encoder looks the convolution up in its own module
    lidar_encoder.sparse_conv = counted
    try:
        yield log
    finally:
        lidar_encoder.sparse_conv = plain


def matmul_flops(fn: Callable[[], object]) -> Dict[str, float]:
    """Matrix-product FLOPs of one call of `fn` (the reference's code, run
    once): dense convolutions and products as `FlopCounterMode` counts them,
    and sparse convolutions by the neighbour pairs present, in place of what
    the counter made of the plain version's products. {"dense": F,
    "sparse": F, "total": F, "convs": the sparse convolutions as
    `count_sparse_convs` logs them}."""
    from torch.utils.flop_counter import FlopCounterMode

    counter = FlopCounterMode(display=False)
    with counter, count_sparse_convs(counter) as convs:
        fn()
    dense = float(counter.get_total_flops()) - sum(c.pop("counted") for c in convs)
    sparse_flops = sum(2.0 * c["pairs"] * c["cin"] * c["cout"] for c in convs)
    return {"dense": dense, "sparse": sparse_flops, "total": dense + sparse_flops, "convs": convs}
