"""Tracking: the port's "pose GN" spans (each call of a pose optimiser: two
a steady frame), summed over the traced window's frames before the
profiled slice and divided by those frames (ms a frame)."""


def read(run):
    spans = run["spans"].get("pose GN")
    n = run["span_frames"]
    return sum(spans) / n * 1e3 if spans and n else None
