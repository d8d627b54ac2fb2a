"""The target assigner, the detection loss and the distill losses: milliseconds a step in the `losses` span of
the spans' slice (CUDA events from the benchmark's hooks)."""


def read(record):
    ms = record["spans_ms"].get("losses")
    return ms / record["span_iterations"] if ms and record["span_iterations"] else None
