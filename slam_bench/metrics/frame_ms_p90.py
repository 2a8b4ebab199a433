"""System layer: the 90th percentile of the host clock between consecutive
poses over the traced window's frames before the profiled slice (ms)."""
from slam_bench.profiling import percentile


def read(run):
    t = run.get("frame_s_before_slice") or []
    return percentile(t, 90) * 1e3 if len(t) >= 5 else None
