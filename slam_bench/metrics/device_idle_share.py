"""Device: 1 - the union of the device's operation intervals over the
profiled slice's host-clock length (a share of the slice)."""


def read(run):
    s = run["slice"]
    return 1.0 - s["busy_s"] / s["window_s"] if s and s["window_s"] > 0 else None
