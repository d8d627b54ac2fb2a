"""The metric arithmetic on hand-made traces and hand counts: the interval
union, busy and idle shares, kernels attributed to the op that launched
them, the breakdown, the roofline bounds and the FLOP count."""
from __future__ import annotations

import pytest
import torch

from benchmark.harness import spec as sp
from benchmark.harness import trace as tr
from benchmark.harness import work


def ev(cat, name, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid, "args": {}}
    if corr is not None:
        e["args"]["correlation"] = corr
    return e


# a slice of 0..100 µs: two ops on the host, each launching one kernel; a
# third kernel from outside any op; a copy overlapping the first kernel
EVENTS = [
    ev("user_annotation", "bench.slice", 0, 100),
    ev("user_annotation", "bench.request", 0, 40),
    ev("user_annotation", "bench.request", 50, 50),
    ev("cpu_op", "unidistill::bev_pool", 2, 10),
    ev("cpu_op", "aten::sort", 3, 4),
    ev("cuda_runtime", "cudaLaunchKernel", 4, 1, corr=7),
    ev("cpu_op", "aten::mm", 60, 5),
    ev("cuda_runtime", "cudaLaunchKernel", 61, 1, corr=8),
    ev("cuda_runtime", "cudaLaunchKernel", 70, 1, corr=9),
    ev("kernel", "sort_kernel", 10, 20, tid=7, corr=7),
    ev("gpu_memcpy", "Memcpy DtoH", 25, 10, tid=7),
    ev("kernel", "gemm", 62, 8, tid=7, corr=8),
    ev("kernel", "gemm", 75, 5, tid=7, corr=9),
]


def test_union_and_busy():
    assert tr.merge([(0, 2), (1, 3), (5, 6)]) == [(0, 3), (5, 6)]
    assert tr.covered([(0, 2), (1, 3), (5, 8)], (1, 6)) == 3
    # 10..35 (kernel + overlapping copy), 62..70, 75..80 inside 0..100
    assert tr.busy_s(EVENTS, [(0, 100)]) == pytest.approx(38e-6)
    # inside the two requests 0..40 and 50..100
    assert tr.busy_s(EVENTS, tr.annotations(EVENTS, "bench.request")) == pytest.approx(38e-6)
    # two iterations in the profiled slice, 50 µs an iteration untraced
    record = {"busy_s": 38e-6, "slice_s": 100e-6, "iterations": 2, "iteration_s": 50e-6}
    assert sp.metric_reader("idle_share.train").read(record) == pytest.approx(100 * (1 - 19 / 50))
    assert sp.metric_reader("idle_share.serve").read(record) == pytest.approx(100 * (1 - 19 / 50))
    assert sp.metric_reader("idle_share.train").read(dict(record, iteration_s=None)) is None


def test_kernels_under_an_op():
    under = tr.kernels_under(EVENTS, "unidistill::bev_pool")
    assert [e["args"]["correlation"] for e in under] == [7]
    assert tr.seconds(under) == pytest.approx(20e-6)
    assert [e["args"]["correlation"] for e in tr.kernels_under(EVENTS, "aten::mm")] == [8]
    assert len(tr.kernels_in(EVENTS, (0, 100))) == 3


def test_breakdown():
    ops = tr.device_ops(EVENTS, [(0, 100)], top=3)
    assert ops[0] == ["sort_kernel", pytest.approx(20e-6)]
    assert [n for n, _ in ops] == ["sort_kernel", "gemm", "Memcpy DtoH"]
    assert [n for n, _ in tr.device_ops(EVENTS, [(50, 100)])] == ["gemm"]
    # gaps: 0..10 (in the bev_pool op's sort), 35..62, 70..75, 80..100
    gaps = tr.idle_gaps(EVENTS, [(0, 100)], top=3)
    assert [s for _, s in gaps] == pytest.approx([27e-6, 20e-6, 10e-6])
    assert gaps[0][0] == "bench.request"  # 35 µs: inside the first request only
    assert gaps[2][0] == "bench.request"  # 0 µs: the request, inside the slice


def test_roofline_reader():
    record = {"events": EVENTS, "iterations": 2, "work": {"bev_pool_bound_s": 4e-6}}
    # bound 2 × 4 µs over the 20 µs of kernels under the op
    assert sp.metric_reader("bev_pool_roofline.serve").read(record) == pytest.approx(40.0)
    assert sp.metric_reader("sparse_conv_roofline.train").read(dict(record, work={"sparse_conv_bound_s": 1.0})) \
        is None  # no kernel under that op: nothing to read


def test_bev_pool_work_by_hand():
    from benchmark.reference.config import CameraEncoderConfig

    c = CameraEncoderConfig()  # 6 cameras, 16 x 44 features, 112 bins, 256 channels, 180 x 180
    pts = 4 * 6 * 112 * 16 * 44
    b, f = work.bev_pool_work(c, 4, backward=False)
    assert b == 4 * pts * 2 + 4 * 4 * 6 * 16 * 44 * 256 + 4 * 4 * 180 * 180 * 256
    assert f == 2 * pts * 256
    assert work.bound_s(b, f, work.PEAKS["f32_flops"]) == pytest.approx(b / 3.35e12)
    b2, f2 = work.bev_pool_work(c, 4, backward=True)
    assert b2 == 4 * 4 * 180 * 180 * 256 + 4 * pts + 2 * (4 * pts + 4 * 4 * 6 * 16 * 44 * 256)


def test_sparse_conv_work_by_hand():
    conv = dict(pairs=10, n_in=6, n_out=5, taps=27, cin=16, cout=32)
    b, f = work.sparse_conv_work([conv])
    assert f == 2 * 10 * 16 * 32
    assert b == 2 * 6 * 16 + 2 * 27 * 16 * 32 + 4 * 5 * 27 + 2 * 5 * 32
    assert work.bound_s(b, f, work.PEAKS["bf16_flops"]) == pytest.approx(b / 3.35e12)


def test_flop_count_by_hand():
    """A conv, a linear layer and a sparse conv of the reference: the
    dense ones as 2·outputs·reduction, the sparse one by its pairs present."""
    from benchmark.reference import lidar_encoder, sparse

    x = torch.randn(1, 3, 8, 8)
    conv = torch.nn.Conv2d(3, 4, 3, padding=1, bias=False)
    lin = torch.nn.Linear(5, 7)
    feats = torch.randn(6, 16)
    nbr = torch.full((5, 27), -1, dtype=torch.int32)
    nbr[:, 13] = torch.arange(5)
    nbr[0, 0] = 5  # 6 pairs present of 5 x 27
    w = torch.randn(27, 16, 32)

    def fn():
        conv(x)
        lin(torch.randn(2, 5))
        lidar_encoder.sparse_conv(feats, nbr, w)

    fl = work.matmul_flops(fn)
    assert fl["sparse"] == 2 * 6 * 16 * 32
    assert fl["dense"] == 2 * (4 * 8 * 8) * (3 * 9) + 2 * 2 * 7 * 5
    assert fl["total"] == fl["dense"] + fl["sparse"]
    assert fl["convs"] == [dict(pairs=6, n_in=6, n_out=5, taps=27, cin=16, cout=32)]
    assert lidar_encoder.sparse_conv is sparse.sparse_conv  # the count's patch is undone


def test_mfu_readers():
    # 4 frames an iteration of 989 GFLOP each, 0.1 s an iteration untraced, of 989 TFLOP/s
    rec = {"work": {"flops_per_frame": 989e9}, "frames_per_iteration": 4, "iteration_s": 0.1}
    assert sp.metric_reader("mfu.train").read(rec) == pytest.approx(4.0)
    assert sp.metric_reader("mfu.serve").read(rec) == pytest.approx(4.0)
    assert sp.metric_reader("mfu.train").read(dict(rec, iteration_s=None)) is None


def test_launches_reader():
    # three kernels over two iterations of 2 frames in the profiled slice
    rec = {"events": EVENTS, "window": (0, 100), "iterations": 2, "frames_per_iteration": 2}
    assert sp.metric_reader("launches_per_frame.train").read(rec) == pytest.approx(0.75)
    assert sp.metric_reader("launches_per_frame.serve").read(rec) == pytest.approx(0.75)
