"""Hand kernels: dense_frontend's share of its roofline in the profiled slice, the
least time of its launches at the cell's shapes (profiling's count of
bytes and operations, after chip_smoke.py's phase 3) over their device
time (%)."""


def read(run):
    k = (run["slice"] or {}).get("kernels", {}).get("dense_frontend")
    if not k or not k["bound_s"] or k["seconds"] <= 0:
        return None
    return 100.0 * k["bound_s"] / k["seconds"]
