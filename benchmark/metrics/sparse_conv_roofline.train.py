"""The teacher's sparse convolutions' share of their roofline, in %: the
bound of the traced steps' convolutions (their neighbour pairs present, from
the reference's rulebooks on the same clouds, at 989 TFLOP/s bf16; features,
weights, rulebooks and outputs at 3.35 TB/s) over the device time of the
kernels launched under `unidistill::sparse_conv` (K4)."""
from benchmark.harness import trace


def read(record):
    t = trace.seconds(trace.kernels_under(record["events"], "unidistill::sparse_conv"))
    bound = record["work"].get("sparse_conv_bound_s")
    return 100.0 * bound / t if t and bound else None
