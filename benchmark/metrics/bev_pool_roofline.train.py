"""The BEV pool's share of its roofline over forward and backward, in %:
the bound of both (`harness/work.bev_pool_work`) for the traced steps over
the device time of the kernels launched under `unidistill::bev_pool` (plan,
K1) and `unidistill::bev_pool_bwd` (K5)."""
from benchmark.harness import trace


def read(record):
    ev = record["events"]
    t = trace.seconds(trace.kernels_under(ev, "unidistill::bev_pool")) + \
        trace.seconds(trace.kernels_under(ev, "unidistill::bev_pool_bwd"))
    bound = record["work"].get("bev_pool_bound_s")
    return 100.0 * bound * record["iterations"] / t if t and bound else None
