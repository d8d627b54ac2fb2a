"""The frozen LiDAR teacher's forward (voxeliser, rulebooks, 21 sparse convs, BEV backbone, head): milliseconds a step in the `teacher` span of
the spans' slice (CUDA events from the benchmark's hooks)."""


def read(record):
    ms = record["spans_ms"].get("teacher")
    return ms / record["span_iterations"] if ms and record["span_iterations"] else None
