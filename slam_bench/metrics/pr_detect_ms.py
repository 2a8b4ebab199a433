"""Place recognition: the median of the port's "PR detection" span over
the keyframes of the traced window's frames before the profiled slice (ms)."""
import statistics


def read(run):
    t = run["spans"].get("PR detection") or []
    return statistics.median(t) * 1e3 if t else None
