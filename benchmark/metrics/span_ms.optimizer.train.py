"""The optimizer (clip and AdamW): milliseconds a step in the `optimizer` span of
the spans' slice (CUDA events from the benchmark's hooks)."""


def read(record):
    ms = record["spans_ms"].get("optimizer")
    return ms / record["span_iterations"] if ms and record["span_iterations"] else None
