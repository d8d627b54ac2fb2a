"""Decode and NMS (`generate_proposals`: top-K, K2, K3): milliseconds a request in the `decode_nms` span of
the spans' slice (CUDA events from the benchmark's hooks)."""


def read(record):
    ms = record["spans_ms"].get("decode_nms")
    return ms / record["span_iterations"] if ms and record["span_iterations"] else None
