"""The backward (`Tensor.backward`; K5 inside): milliseconds a step in the `backward` span of
the spans' slice (CUDA events from the benchmark's hooks)."""


def read(record):
    ms = record["spans_ms"].get("backward")
    return ms / record["span_iterations"] if ms and record["span_iterations"] else None
