"""The BEV backbone and the CenterHead: milliseconds a request in the `bev_head` span of
the spans' slice (CUDA events from the benchmark's hooks)."""


def read(record):
    ms = record["spans_ms"].get("bev_head")
    return ms / record["span_iterations"] if ms and record["span_iterations"] else None
