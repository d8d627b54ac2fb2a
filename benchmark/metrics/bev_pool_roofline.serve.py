"""The BEV pool's share of its roofline, in %: the bound (bytes of the
cells, depth, context and BEV map at 3.35 TB/s; products at 67 TFLOP/s)
of the traced requests over the device time of the kernels launched under
`unidistill::bev_pool` (the plan and K1)."""
from benchmark.harness import trace


def read(record):
    t = trace.seconds(trace.kernels_under(record["events"], "unidistill::bev_pool"))
    bound = record["work"].get("bev_pool_bound_s")
    return 100.0 * bound * record["iterations"] / t if t and bound else None
