"""The student's camera encoder forward (ResNet-50, SECONDFPN, depth net, geometry, BEV pool): milliseconds a step in the `camera_encoder` span of
the spans' slice (CUDA events from the benchmark's hooks)."""


def read(record):
    ms = record["spans_ms"].get("camera_encoder")
    return ms / record["span_iterations"] if ms and record["span_iterations"] else None
