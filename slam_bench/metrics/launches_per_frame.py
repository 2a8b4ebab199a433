"""Device: kernels the profiler saw in the profiled slice, a frame."""


def read(run):
    s = run["slice"]
    return s["launches"] / s["n_frames"] if s and s["n_frames"] else None
