"""Local mapping: the port's spans "KF insertion", "MP culling", "MP
creation", "local BA" and "KF culling", summed over the traced window's frames
before the profiled slice and divided by their keyframe events (ms an event)."""

STAGES = ("KF insertion", "MP culling", "MP creation", "local BA",
          "KF culling")


def read(run):
    spans = run["spans"]
    n = len(spans.get("KF insertion", ()))
    if n == 0:
        return None
    return sum(sum(spans.get(k, ())) for k in STAGES) / n * 1e3
