"""Front end: the mean host clock of one extraction call (a monocular
frame's ``prepare_frame`` or a stereo pair's ``prepare_frame_stereo``) in
the profiled slice, synchronized on both sides by the benchmark's wrapper
there and nowhere else (ms)."""


def read(run):
    t = run.get("frontend_s") or []
    return sum(t) / len(t) * 1e3 if t else None
