"""Tracking: the port's "pose prediction" and "track local map" spans,
summed over the traced window's frames before the profiled slice and
divided by those frames (ms a frame)."""


def read(run):
    spans = run["spans"]
    total = sum(sum(spans.get(k, ())) for k in ("pose prediction",
                                                 "track local map"))
    n = run["span_frames"]
    return total / n * 1e3 if n and total else None
