"""Settings: ORB-SLAM3's settings files read into typed fields with the
reference's key names.

Counterpart of ``utils/config.py`` of the JAX package (reference:
src/Settings.cc readCamera1 / readImageInfo / readIMU / readORB and the
legacy parser in Tracking). The files are the OpenCV-YAML that
cv::FileStorage writes, and this module reads them itself
(``parse_opencv_yaml``), with neither PyYAML nor OpenCV:

- the ``%YAML:1.0`` and ``---`` lines, and ``#`` comments;
- flat ``Key.name: value`` lines: integers, floats (``1e-5`` too),
  quoted or bare strings, ``true`` / ``false`` and an empty value (None);
- ``!!opencv-matrix`` nodes, whose indented ``rows``, ``cols``, ``dt`` and
  ``data: [...]`` lines follow, the list free to span lines;
- flat lists ``[a, b, ...]``, also across lines.

A line it cannot read raises ``ValueError`` naming the line; none is
skipped. Numbers are read as numbers wherever they parse as one (YAML 1.1
reads ``1e-5`` as a string, which the JAX package then turns into a
float): the fields of ``Settings`` come out the same.

``resize_image`` is a bilinear resize with ``cv2.resize``'s
``INTER_LINEAR`` pixel-centre rule, in numpy. The legacy rectification of
``LEFT.*`` / ``RIGHT.*`` blocks is numpy too: ``stereo_rectify_maps``
builds ``cv2.initUndistortRectifyMap``'s maps in float64 (stored float32)
and ``rectify`` is ``cv2.remap``'s bilinear sampling; the stereo entry
points and ROS nodes apply them.
"""
from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Optional

import numpy as np

from ..models import cameras


@dataclass
class Settings:
    camera: cameras.CameraParams = None
    camera2: Optional[cameras.CameraParams] = None
    fps: float = 30.0
    rgb: bool = True
    # stereo
    baseline: float = 0.0       # metres
    th_depth: float = 35.0
    # depth
    depth_map_factor: float = 1.0
    # ORB
    n_features: int = 1200
    scale_factor: float = 1.2
    n_levels: int = 8
    ini_th_fast: float = 20.0
    min_th_fast: float = 7.0
    # IMU
    imu_noise_gyro: float = 1.7e-4
    imu_noise_acc: float = 2.0e-3
    imu_walk_gyro: float = 1.9e-5
    imu_walk_acc: float = 3.0e-3
    imu_frequency: float = 200.0
    T_bc: Optional[np.ndarray] = None    # 4x4 camera in body
    T_c1c2: Optional[np.ndarray] = None  # 4x4 camera 2 in camera 1
    insert_kfs_when_lost: bool = True
    # the working resolution (W, H) when Camera.newWidth / newHeight ask
    # for another than the sensor's (reference: Settings.cc:436 and the
    # cv::resize of System::Track*, System.cc:285-300)
    resize_to: Optional[tuple] = None
    orig_width: Optional[int] = None     # the sensor's width before it
    # system
    load_atlas: Optional[str] = None
    save_atlas: Optional[str] = None
    loop_closing: bool = True
    raw: dict = field(default_factory=dict)


# ---- the OpenCV-YAML reader ----------------------------------------------

_KEY = re.compile(r"^([A-Za-z_][\w.\-]*)\s*:(?:\s+(.*))?$")
_INT = re.compile(r"^[-+]?\d+$")
_FLOAT = re.compile(r"^[-+]?(\d+\.?\d*|\.\d+)([eE][-+]?\d+)?$")


def _strip_comment(line: str) -> str:
    """The line without a '#' comment outside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _scalar(tok: str, where: str):
    tok = tok.strip()
    if tok == "" or tok in ("~", "null", "Null", "NULL"):
        return None
    if tok[0] in "\"'":
        if len(tok) < 2 or tok[-1] != tok[0]:
            raise ValueError(f"{where}: unterminated string {tok!r}")
        return tok[1:-1]
    if tok.lower() in ("true", "false"):
        return tok.lower() == "true"
    if _INT.match(tok):
        return int(tok)
    if _FLOAT.match(tok):
        return float(tok)
    if tok[0] in "[]{}!&*|>@`,":
        raise ValueError(f"{where}: cannot read the value {tok!r}")
    return tok


def _list(text: str, where: str) -> list:
    """The items of '[a, b, ...]' (a trailing comma allowed)."""
    inner = text.strip()
    if not (inner.startswith("[") and inner.endswith("]")):
        raise ValueError(f"{where}: cannot read the list {text!r}")
    items = [t.strip() for t in inner[1:-1].split(",")]
    if items and items[-1] == "":
        items.pop()
    if any(t == "" for t in items):
        raise ValueError(f"{where}: an empty item in the list {text!r}")
    return [_scalar(t, where) for t in items]


class _Lines:
    """The file's lines, comments stripped, with their 1-based numbers."""

    def __init__(self, text: str, name: str):
        self.rows = [(i + 1, _strip_comment(l).rstrip())
                     for i, l in enumerate(text.splitlines())]
        self.name = name
        self.pos = 0

    def where(self, n: int) -> str:
        return f"{self.name}, line {n}"

    def next(self):
        while self.pos < len(self.rows):
            n, line = self.rows[self.pos]
            self.pos += 1
            if line.strip():
                return n, line
        return None

    def peek_indented(self) -> bool:
        """True when the next non-blank line is indented."""
        for n, line in self.rows[self.pos:]:
            if line.strip():
                return line[0] in " \t"
        return False

    def value(self, n: int, rest: str):
        """A scalar, or a list that may continue on the following lines."""
        if not rest.lstrip().startswith("["):
            return _scalar(rest, self.where(n))
        text = rest
        while "]" not in text:
            nxt = self.next()
            if nxt is None:
                raise ValueError(f"{self.where(n)}: the list is not closed")
            text += " " + nxt[1].strip()
        if not text.rstrip().endswith("]"):
            raise ValueError(f"{self.where(n)}: text after the list's ']'")
        return _list(text, self.where(n))


def parse_opencv_yaml(text: str, name: str = "<settings>") -> dict:
    """{key: value} of an OpenCV-YAML settings text; a matrix node becomes
    {"rows", "cols", "dt", "data"}."""
    lines = _Lines(text, name)
    out = {}
    while True:
        nxt = lines.next()
        if nxt is None:
            return out
        n, line = nxt
        st = line.strip()
        if n == lines.rows[0][0] and st.startswith("%YAML"):
            continue
        if st == "---":
            continue
        if line[0] in " \t":
            raise ValueError(f"{lines.where(n)}: an indented line outside "
                             f"a node: {line!r}")
        m = _KEY.match(line)
        if m is None:
            raise ValueError(f"{lines.where(n)}: cannot read {line!r}")
        key, rest = m.group(1), (m.group(2) or "").strip()
        if key in out:
            raise ValueError(f"{lines.where(n)}: {key} given twice")
        if rest in ("", "!!opencv-matrix") and lines.peek_indented():
            node = {}
            while lines.peek_indented():
                n2, sub = lines.next()
                m2 = _KEY.match(sub.strip())
                if m2 is None:
                    raise ValueError(f"{lines.where(n2)}: cannot read "
                                     f"{sub!r}")
                node[m2.group(1)] = lines.value(n2, m2.group(2) or "")
            out[key] = node
        elif rest.startswith("!!"):
            raise ValueError(f"{lines.where(n)}: the node {rest!r} has no "
                             f"entries")
        else:
            out[key] = lines.value(n, rest)


def _load_yaml(path: str) -> dict:
    with open(path) as f:
        return parse_opencv_yaml(f.read(), str(path))


# ---- settings -------------------------------------------------------------

def _get(d: dict, *keys, default=None):
    for k in keys:
        if k in d and d[k] is not None:
            return d[k]
    return default


def _read_camera(d: dict, prefix: str = "Camera"
                 ) -> Optional[cameras.CameraParams]:
    """Camera 1, from the v1.0 ('Camera1.fx') or the legacy ('Camera.fx')
    keys."""
    def g(name, default=None):
        return _get(d, f"{prefix}1.{name}", f"{prefix}.{name}",
                    default=default)

    fx = g("fx")
    if fx is None:
        return None
    fy, cx, cy = g("fy"), g("cx"), g("cy")
    w = _get(d, "Camera.width", "Camera.newWidth", default=752)
    h = _get(d, "Camera.height", "Camera.newHeight", default=480)
    cam_type = _get(d, "Camera.type", "File.type", default="PinHole")
    k1 = g("k1", 0.0) or 0.0
    k2 = g("k2", 0.0) or 0.0
    if str(cam_type).lower() in ("kannalabrandt8", "fisheye"):
        return cameras.fisheye_kb8(fx, fy, cx, cy, w, h, k1=k1, k2=k2,
                                   k3=g("k3", 0.0) or 0.0,
                                   k4=g("k4", 0.0) or 0.0)
    return cameras.pinhole(fx, fy, cx, cy, w, h, k1=k1, k2=k2,
                           p1=g("p1", 0.0) or 0.0, p2=g("p2", 0.0) or 0.0,
                           k3=g("k3", 0.0) or 0.0)


def _read_camera2(d: dict) -> Optional[cameras.CameraParams]:
    """Camera 2 of a two-camera rig (v1.0 'Camera2.*')."""
    def g(name, default=None):
        return _get(d, f"Camera2.{name}", default=default)

    fx = g("fx")
    if fx is None:
        return None
    w = _get(d, "Camera.width", default=752)
    h = _get(d, "Camera.height", default=480)
    cam_type = _get(d, "Camera.type", default="PinHole")
    if str(cam_type).lower() in ("kannalabrandt8", "fisheye"):
        return cameras.fisheye_kb8(
            fx, g("fy"), g("cx"), g("cy"), w, h, k1=g("k1", 0.0) or 0.0,
            k2=g("k2", 0.0) or 0.0, k3=g("k3", 0.0) or 0.0,
            k4=g("k4", 0.0) or 0.0)
    return cameras.pinhole(fx, g("fy"), g("cx"), g("cy"), w, h,
                           k1=g("k1", 0.0) or 0.0, k2=g("k2", 0.0) or 0.0,
                           p1=g("p1", 0.0) or 0.0, p2=g("p2", 0.0) or 0.0,
                           k3=g("k3", 0.0) or 0.0)


def _read_se3(v) -> Optional[np.ndarray]:
    """A rigid transform given as a matrix node or a flat list, 4x4 or 3x4
    (EuRoC's Tbc, TUM_512's Stereo.T_c1_c2); always returned 4x4."""
    if v is None:
        return None
    data = v["data"] if isinstance(v, dict) else v
    a = np.asarray(data, np.float32).reshape(-1, 4)
    if a.shape[0] == 3:
        a = np.vstack([a, np.array([[0, 0, 0, 1]], np.float32)])
    return a


def load_settings(path: str) -> Settings:
    """(reference: the Settings constructor, Settings.cc:68)"""
    d = _load_yaml(path)
    s = Settings(raw=d)
    s.camera = _read_camera(d)
    s.camera2 = _read_camera2(d)
    s.T_c1c2 = _read_se3(_get(d, "Stereo.T_c1_c2", "Tlr"))
    s.fps = float(_get(d, "Camera.fps", default=30.0))
    s.rgb = bool(_get(d, "Camera.RGB", default=1))
    bf = _get(d, "Camera.bf")
    if bf is not None and s.camera is not None:
        s.baseline = float(bf) / s.camera.fx
    st_b = _get(d, "Stereo.b")
    if st_b is not None:
        s.baseline = float(st_b)
    if s.baseline == 0.0 and s.T_c1c2 is not None:
        # a v1.0 rig gives the extrinsic only: b = |t| (Settings.cc
        # readCamera2)
        s.baseline = float(np.linalg.norm(s.T_c1c2[:3, 3]))
    s.th_depth = float(_get(d, "ThDepth", "Stereo.ThDepth", "Camera.ThDepth",
                            default=35.0))
    dmf = _get(d, "DepthMapFactor", "RGBD.DepthMapFactor")
    if dmf:
        s.depth_map_factor = float(dmf)
    s.n_features = int(_get(d, "ORBextractor.nFeatures", default=1200))
    s.scale_factor = float(_get(d, "ORBextractor.scaleFactor", default=1.2))
    s.n_levels = int(_get(d, "ORBextractor.nLevels", default=8))
    s.ini_th_fast = float(_get(d, "ORBextractor.iniThFAST", default=20))
    s.min_th_fast = float(_get(d, "ORBextractor.minThFAST", default=7))
    s.imu_noise_gyro = float(_get(d, "IMU.NoiseGyro", default=1.7e-4))
    s.imu_noise_acc = float(_get(d, "IMU.NoiseAcc", default=2.0e-3))
    s.imu_walk_gyro = float(_get(d, "IMU.GyroWalk", default=1.9e-5))
    s.imu_walk_acc = float(_get(d, "IMU.AccWalk", default=3.0e-3))
    s.imu_frequency = float(_get(d, "IMU.Frequency", default=200.0))
    s.T_bc = _read_se3(_get(d, "IMU.T_b_c1", "Tbc"))
    s.insert_kfs_when_lost = bool(_get(d, "IMU.InsertKFsWhenLost",
                                       default=1))
    s.load_atlas = _get(d, "System.LoadAtlasFromFile")
    s.save_atlas = _get(d, "System.SaveAtlasToFile")
    s.loop_closing = bool(_get(d, "loopClosing", default=1))
    # Camera.newWidth / newHeight: scale the intrinsics and resize the
    # inputs (Settings.cc:436-470; not where legacy rectification blocks
    # drive the geometry, as in the reference's bNeedToRectify)
    nw, nh = _get(d, "Camera.newWidth"), _get(d, "Camera.newHeight")
    if ((nw is not None or nh is not None) and s.camera is not None
            and "Camera.width" in d and "LEFT.K" not in d):
        nw = int(nw if nw is not None else s.camera.width)
        nh = int(nh if nh is not None else s.camera.height)
        if (nw, nh) != (s.camera.width, s.camera.height):
            s.resize_to = (nw, nh)
            s.orig_width = s.camera.width
            s.camera = scale_camera(s.camera, nw, nh)
            if s.camera2 is not None:
                s.camera2 = scale_camera(s.camera2, nw, nh)
    return s


def scale_camera(cam: cameras.CameraParams, new_w: int,
                 new_h: int) -> cameras.CameraParams:
    """Intrinsics of a resized image (distortion acts on normalised
    coordinates and does not change)."""
    sx = new_w / cam.width
    sy = new_h / cam.height
    return cam._replace(fx=cam.fx * sx, fy=cam.fy * sy, cx=cam.cx * sx,
                        cy=cam.cy * sy, width=int(new_w), height=int(new_h))


def _taps(n_in: int, n_out: int):
    """cv2's INTER_LINEAR source taps and weights along one axis: output
    pixel d samples at (d + 0.5) * n_in / n_out - 0.5, clamped to the
    first and last pixel."""
    f = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    i0 = np.floor(f).astype(np.int64)
    w = (f - i0).astype(np.float32)
    low, high = i0 < 0, i0 >= n_in - 1
    i0[low], w[low] = 0, 0.0
    i0[high], w[high] = n_in - 1, 0.0
    return i0, np.minimum(i0 + 1, n_in - 1), w


def resize_image(img: np.ndarray, resize_to) -> np.ndarray:
    """One frame resized to Settings.resize_to (W, H); no-op when None.
    Bilinear, like the reference's cv::resize (INTER_LINEAR): float images
    stay float32, 8-bit images round to the nearest grey level."""
    if resize_to is None:
        return img
    a = np.asarray(img)
    W, H = int(resize_to[0]), int(resize_to[1])
    x0, x1, wx = _taps(a.shape[1], W)
    y0, y1, wy = _taps(a.shape[0], H)
    f = a.astype(np.float32)
    tail = (1,) * (a.ndim - 2)
    wx = wx.reshape(1, W, *tail)
    rows = lambda r: f[r][:, x0] * (1 - wx) + f[r][:, x1] * wx
    wy = wy.reshape(H, 1, *tail)
    out = rows(y0) * (1 - wy) + rows(y1) * wy
    if a.dtype == np.uint8:
        return np.clip(np.floor(out + 0.5), 0, 255).astype(np.uint8)
    return out.astype(np.float32)


def _mat(d: dict, name: str):
    v = d.get(name)
    if v is None:
        return None
    data = v["data"] if isinstance(v, dict) else v
    a = np.asarray(data, np.float64)
    if isinstance(v, dict) and "rows" in v:
        a = a.reshape(int(v["rows"]), int(v["cols"]))
    return a


def undistort_rectify_map(K, D, R, P, size):
    """The inverse map of ``cv2.initUndistortRectifyMap(K, D, R, P, size,
    CV_32FC1)`` for the radial-tangential model, D = (k1, k2, p1, p2[, k3]):
    for each rectified pixel (u, v), the raw image's (x, y) to sample.
    Computed in float64, returned as two [h, w] float32 maps."""
    w, h = int(size[0]), int(size[1])
    K, R, P = (np.asarray(a, np.float64) for a in (K, R, P))
    k = np.zeros(5)
    D = np.asarray(D, np.float64).reshape(-1)
    k[:min(len(D), 5)] = D[:5]
    if len(D) > 5 and np.any(D[5:]):
        raise ValueError("only the radial-tangential model (k1, k2, p1, "
                         "p2[, k3]) is supported")
    k1, k2, p1, p2, k3 = k
    iR = np.linalg.inv(P[:3, :3] @ R)
    u, v = np.meshgrid(np.arange(w, dtype=np.float64),
                       np.arange(h, dtype=np.float64))
    X = iR[0, 0] * u + iR[0, 1] * v + iR[0, 2]
    Y = iR[1, 0] * u + iR[1, 1] * v + iR[1, 2]
    Z = iR[2, 0] * u + iR[2, 1] * v + iR[2, 2]
    x, y = X / Z, Y / Z
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    xd = x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)
    yd = y * kr + p1 * (r2 + 2 * y2) + p2 * xy2
    mx = K[0, 0] * xd + K[0, 2]
    my = K[1, 1] * yd + K[1, 2]
    return mx.astype(np.float32), my.astype(np.float32)


def stereo_rectify_maps(s: Settings):
    """Precomputed stereo rectification from the legacy LEFT.* / RIGHT.*
    blocks (reference: Settings' precomputed rectification maps,
    Settings.h:157, applied in System::TrackStereo, System.cc:285-292).

    Returns (remap_l, remap_r, cam_rect, baseline_m): each remap a pair of
    [h, w] float32 maps (``undistort_rectify_map``), cam_rect the rectified
    pinhole camera; None if the settings have no rectification blocks."""
    d = s.raw
    K_l, K_r = _mat(d, "LEFT.K"), _mat(d, "RIGHT.K")
    if K_l is None or K_r is None:
        return None
    D_l = _mat(d, "LEFT.D").reshape(-1)
    D_r = _mat(d, "RIGHT.D").reshape(-1)
    R_l = _mat(d, "LEFT.R").reshape(3, 3)
    R_r = _mat(d, "RIGHT.R").reshape(3, 3)
    P_l = _mat(d, "LEFT.P").reshape(3, 4)
    P_r = _mat(d, "RIGHT.P").reshape(3, 4)
    w = int(_get(d, "LEFT.width", "Camera.width"))
    h = int(_get(d, "LEFT.height", "Camera.height"))
    m_l = undistort_rectify_map(K_l, D_l, R_l, P_l[:3, :3], (w, h))
    m_r = undistort_rectify_map(K_r, D_r, R_r, P_r[:3, :3], (w, h))
    cam_rect = cameras.pinhole(P_l[0, 0], P_l[1, 1], P_l[0, 2], P_l[1, 2],
                               w, h)
    baseline = float(-P_r[0, 3] / P_r[0, 0])
    return m_l, m_r, cam_rect, baseline


def _lerp(a: np.ndarray, b: np.ndarray, w: np.ndarray) -> np.ndarray:
    """float32 a + w (b - a), the product and sum rounded once (a fused
    multiply-add: the float32 product is exact in float64)."""
    d = (b - a).astype(np.float64)
    return (w.astype(np.float64) * d + a).astype(np.float32)


def rectify(img: np.ndarray, maps) -> np.ndarray:
    """``cv2.remap(img, maps[0], maps[1], INTER_LINEAR)`` with its constant
    0 border, in numpy, by OpenCV 5's rule: the taps are read as float32,
    interpolated along x with the fraction a = x - floor(x), then along y
    with b, each step a fused multiply-add (f0 = p00 + a (p01 - p00),
    f1 = p10 + a (p11 - p10), f0 + b (f1 - f0)); a uint8 image rounds the
    result half to even. A tap outside the image reads 0."""
    mx, my = (np.asarray(m, np.float32) for m in maps)
    src = np.asarray(img)
    H, W = src.shape[:2]
    x0f, y0f = np.floor(mx), np.floor(my)
    ax, ay = mx - x0f, my - y0f
    # the taps read a copy with a border of 2 zeros: a corner clipped to
    # [-2, W] x [-2, H] reads the same taps inside and zeros outside
    pad = np.zeros((H + 4, W + 4) + src.shape[2:], np.float32)
    pad[2:H + 2, 2:W + 2] = src
    flat = pad.reshape((H + 4) * (W + 4), *src.shape[2:])
    x0 = np.clip(x0f, -2, W).astype(np.int64) + 2
    y0 = np.clip(y0f, -2, H).astype(np.int64) + 2
    i00 = y0 * (W + 4) + x0
    tap = lambda i: np.take(flat, i, axis=0)
    lift = (Ellipsis,) + (None,) * (src.ndim - 2)
    f0 = _lerp(tap(i00), tap(i00 + 1), ax[lift])
    f1 = _lerp(tap(i00 + W + 4), tap(i00 + W + 5), ax[lift])
    out = _lerp(f0, f1, ay[lift])
    if src.dtype == np.uint8:
        return np.clip(np.rint(out), 0, 255).astype(np.uint8)
    return out
