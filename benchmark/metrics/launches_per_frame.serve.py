"""Device kernels launched in the profiled slice, over its frames."""
from benchmark.harness import trace


def read(record):
    n = len(trace.kernels_in(record["events"], record["window"]))
    frames = record["iterations"] * record["frames_per_iteration"]
    return n / frames if n and frames else None
