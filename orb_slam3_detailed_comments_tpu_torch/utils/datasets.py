"""Dataset loaders: EuRoC, TUM (mono/RGB-D), KITTI image sequences.

Counterpart of ``utils/datasets.py`` of the JAX package, with the same
functions and signatures (reference: the LoadImages / LoadIMU helpers of
each example, e.g. Examples/Monocular/mono_euroc.cc:33 LoadImages,
Examples/Stereo-Inertial/stereo_inertial_euroc.cc LoadIMU). Images are
PNG, decoded by the port's own ``utils/png`` (no OpenCV): ``read_gray``
returns what ``cv2.imread(path, IMREAD_GRAYSCALE)`` does, as float32, and
``read_depth`` ``IMREAD_UNCHANGED``'s values divided by ``factor``.
"""
from __future__ import annotations

import os

import numpy as np


def load_euroc_images(seq_dir: str, ts_file: str | None = None, cam: str = "cam0"):
    """EuRoC mav0 layout: <seq>/mav0/cam0/data/<ns>.png + data.csv.

    Returns (paths, timestamps_s).
    """
    base = os.path.join(seq_dir, "mav0", cam, "data")
    if not os.path.isdir(base):
        base = os.path.join(seq_dir, cam, "data")
    csv = os.path.join(os.path.dirname(base), "data.csv")
    names, ts = [], []
    if os.path.exists(csv):
        with open(csv) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                parts = line.strip().split(",")
                if len(parts) >= 2:
                    ts.append(float(parts[0]) * 1e-9)
                    names.append(os.path.join(base, parts[1].strip()))
    else:
        for n in sorted(os.listdir(base)):
            if n.endswith(".png"):
                ts.append(float(os.path.splitext(n)[0]) * 1e-9)
                names.append(os.path.join(base, n))
    return names, np.asarray(ts)


def load_euroc_imu(seq_dir: str):
    """EuRoC imu0/data.csv -> (timestamps_s [M], gyro [M,3], acc [M,3])."""
    csv = os.path.join(seq_dir, "mav0", "imu0", "data.csv")
    if not os.path.exists(csv):
        csv = os.path.join(seq_dir, "imu0", "data.csv")
    rows = np.loadtxt(csv, delimiter=",", comments="#")
    return rows[:, 0] * 1e-9, rows[:, 1:4], rows[:, 4:7]


def load_tum_rgbd(seq_dir: str):
    """TUM RGB-D: rgb.txt + depth.txt with timestamp filename pairs.

    Returns (rgb_paths, rgb_ts, depth_paths, depth_ts).
    """
    def read_list(name):
        ts, paths = [], []
        with open(os.path.join(seq_dir, name)) as f:
            for line in f:
                if line.startswith("#"):
                    continue
                parts = line.split()
                if len(parts) >= 2:
                    ts.append(float(parts[0]))
                    paths.append(os.path.join(seq_dir, parts[1]))
        return paths, np.asarray(ts)

    rgb_p, rgb_t = read_list("rgb.txt")
    d_p, d_t = read_list("depth.txt")
    return rgb_p, rgb_t, d_p, d_t


def load_kitti_stereo(seq_dir: str):
    """KITTI odometry: image_0/ image_1/ + times.txt."""
    times = np.loadtxt(os.path.join(seq_dir, "times.txt"))
    left = sorted(os.listdir(os.path.join(seq_dir, "image_0")))
    lp = [os.path.join(seq_dir, "image_0", n) for n in left]
    rp = [os.path.join(seq_dir, "image_1", n) for n in left]
    return lp, rp, times


def associate_rgbd(rgb_ts, depth_ts, max_dt=0.02):
    """Associate RGB and depth timestamps (reference: evaluation/associate.py)."""
    from .evaluate_ate import associate
    return associate(rgb_ts, depth_ts, max_dt)


def imu_between(imu_ts, t0, t1):
    """Index slice of IMU samples in (t0, t1]."""
    i0 = np.searchsorted(imu_ts, t0, side="right")
    i1 = np.searchsorted(imu_ts, t1, side="right")
    return i0, i1


def read_gray(path: str) -> np.ndarray:
    """[H, W] float32 grey levels of a PNG (``cv2.imread`` with
    ``IMREAD_GRAYSCALE``). A missing file raises FileNotFoundError; a file
    that is not a PNG the decoder reads raises ValueError naming it."""
    from . import png
    return png.imread_gray(path).astype(np.float32)


def read_depth(path: str, factor: float = 5000.0) -> np.ndarray:
    """[H, W] float32 depth of a PNG: its stored (16-bit) values, as
    ``cv2.imread`` with ``IMREAD_UNCHANGED`` gives them, over ``factor``."""
    from . import png
    return png.imread_unchanged(path).astype(np.float32) / factor


def prefetch_gray(paths, depth: int = 4, resize_to=None):
    """Yield grayscale frames for `paths` with disk reads running on a
    background thread (bounded queue), so image decode overlaps tracking.
    The reference's mains read synchronously between frames
    (mono_euroc.cc:139); on a paced pipeline the decode would otherwise
    sit on the critical path. resize_to: optional (W, H) working resolution
    (Settings.resize_to — the reference's Camera.newWidth resize)."""
    import queue
    import threading
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    STOP = object()
    stop = threading.Event()   # consumer closed early: let the worker exit

    def _put(item) -> bool:
        while not stop.is_set():
            try:
                q.put(item, timeout=0.2)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        try:
            from . import config
            for p in paths:
                if not _put(config.resize_image(read_gray(p), resize_to)):
                    return
        except BaseException as e:          # surface errors at the consumer
            _put(e)
            return
        _put(STOP)

    th = threading.Thread(target=worker, daemon=True)
    th.start()
    try:
        while True:
            item = q.get()
            if item is STOP:
                break
            if isinstance(item, BaseException):
                raise item
            yield item
    finally:
        stop.set()   # unblock + terminate the worker on early close
