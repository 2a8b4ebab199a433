"""Tracking: the port's "projection search" spans (each stage's gather,
projection, windowed search and match inversion: two a steady frame),
summed over the traced window's frames before the profiled slice and
divided by those frames (ms a frame)."""


def read(run):
    spans = run["spans"].get("projection search")
    n = run["span_frames"]
    return sum(spans) / n * 1e3 if spans and n else None
