"""The whole step's share of the chip's bf16 peak, in %: the matrix FLOPs
of a step (the reference's forward, backward and teacher forward on the
cell's batches, sparse convolutions by the pairs present) over the time a
step takes in the untraced head of the window, over 989 TFLOP/s."""
from benchmark.harness.work import PEAKS


def read(record):
    flops, t = record["work"].get("flops_per_frame"), record["iteration_s"]
    if not flops or not t:
        return None
    return 100.0 * flops * record["frames_per_iteration"] / t / PEAKS["bf16_flops"]
