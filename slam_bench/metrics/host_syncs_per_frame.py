"""System: the port's "host sync" spans (each blocking transfer or wait
between host and card) over the traced window's frames before the profiled
slice, keyframe events included, a frame."""


def read(run):
    spans = run["spans"].get("host sync")
    n = run["span_frames"]
    return len(spans) / n if spans and n else None
