"""Front end: the port's "ORB extraction" spans, the host's time to queue
each frame's extraction (its image uploads, both images' ORB and the
stereo matching), summed over the traced window's frames before the
profiled slice and divided by those frames (ms a frame). frontend_ms is the
same call between two synchronizes, in the slice."""


def read(run):
    spans = run["spans"].get("ORB extraction")
    n = run["span_frames"]
    return sum(spans) / n * 1e3 if spans and n else None
