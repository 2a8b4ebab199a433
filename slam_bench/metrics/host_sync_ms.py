"""System: the port's "host sync" spans (each blocking transfer or wait
between host and card: the copy and the wait for the card), summed over the
traced window's frames before the profiled slice, keyframe events included,
and divided by those frames (ms a frame)."""


def read(run):
    spans = run["spans"].get("host sync")
    n = run["span_frames"]
    return sum(spans) / n * 1e3 if spans and n else None
