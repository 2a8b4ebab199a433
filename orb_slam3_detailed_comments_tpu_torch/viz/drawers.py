"""Headless visualisation: frame overlays and map renders as numpy images.

Counterpart of ``viz/drawers.py`` of the JAX package (reference:
src/FrameDrawer.cc, src/MapDrawer.cc, src/Viewer.cc), drawn with numpy
instead of OpenCV:

- ``fill_circle`` is ``cv2.circle(img, c, r, color, -1)`` (LINE_8): the
  same midpoint walk filling the same horizontal spans, clipped to the
  image;
- ``line`` is ``cv2.line(img, p, q, color, 1)`` (LINE_8): the same
  Bresenham walk from the left end; pixels outside the image are dropped
  (cv2 clips the segment first, which can move the pixels of a line that
  leaves the image; lines inside it are pixel for pixel cv2's);
- ``put_text`` writes with a 5x7 bitmap font of its own (cv2's Hershey
  glyphs are not copied), its baseline at ``org`` like ``cv2.putText``.

``save_png`` writes with the port's PNG writer (``utils/png``).
"""
from __future__ import annotations

import numpy as np

from ..utils import png


def gray_to_bgr(img: np.ndarray) -> np.ndarray:
    """[H, W] grey (any type, clipped to 0-255) -> [H, W, 3] uint8."""
    g = np.clip(img, 0, 255).astype(np.uint8)
    return np.repeat(g[..., None], 3, axis=2)


def _hline(img, y: int, x0: int, x1: int, color) -> None:
    H, W = img.shape[:2]
    if 0 <= y < H:
        x0, x1 = max(x0, 0), min(x1, W - 1)
        if x0 <= x1:
            img[y, x0:x1 + 1] = color


def fill_circle(img: np.ndarray, center, radius: int, color) -> None:
    """A filled circle, in place (OpenCV's Circle() with fill)."""
    cx, cy = int(center[0]), int(center[1])
    err, dx, dy, plus, minus = 0, int(radius), 0, 1, (int(radius) << 1) - 1
    while dx >= dy:
        _hline(img, cy - dy, cx - dx, cx + dx, color)
        _hline(img, cy + dy, cx - dx, cx + dx, color)
        _hline(img, cy - dx, cx - dy, cx + dy, color)
        _hline(img, cy + dx, cx - dy, cx + dy, color)
        dy += 1
        err += plus
        plus += 2
        mask = (err <= 0) - 1
        err -= minus & mask
        dx += mask
        minus -= mask & 2


def line(img: np.ndarray, p, q, color) -> None:
    """A one-pixel 8-connected line from p to q (x, y), in place."""
    x0, y0, x1, y1 = int(p[0]), int(p[1]), int(q[0]), int(q[1])
    if x1 < x0:                                   # walk from the left end
        x0, y0, x1, y1 = x1, y1, x0, y0
    dx, dy = x1 - x0, y1 - y0
    sy = -1 if dy < 0 else 1
    dy = abs(dy)
    steep = dy > dx
    if steep:
        dx, dy = dy, dx
    err, plus, minus = dx - 2 * dy, 2 * dx, -2 * dy
    x, y = x0, y0
    H, W = img.shape[:2]
    for _ in range(dx + 1):
        if 0 <= x < W and 0 <= y < H:
            img[y, x] = color
        diag = err < 0
        err += minus + (plus if diag else 0)
        # the major axis always steps; the minor one on a diagonal step
        if steep:
            y += sy
            x += 1 if diag else 0
        else:
            x += 1
            y += sy if diag else 0


# 5x7 glyphs, one 5-bit row each (bit 4 the left column)
_FONT = {
    " ": (0, 0, 0, 0, 0, 0, 0),
    "0": (14, 17, 19, 21, 25, 17, 14), "1": (4, 12, 4, 4, 4, 4, 14),
    "2": (14, 17, 1, 2, 4, 8, 31), "3": (31, 2, 4, 2, 1, 17, 14),
    "4": (2, 6, 10, 18, 31, 2, 2), "5": (31, 16, 30, 1, 1, 17, 14),
    "6": (6, 8, 16, 30, 17, 17, 14), "7": (31, 1, 2, 4, 8, 8, 8),
    "8": (14, 17, 17, 14, 17, 17, 14), "9": (14, 17, 17, 15, 1, 2, 12),
    "A": (14, 17, 17, 31, 17, 17, 17), "B": (30, 17, 17, 30, 17, 17, 30),
    "C": (14, 17, 16, 16, 16, 17, 14), "D": (28, 18, 17, 17, 17, 18, 28),
    "E": (31, 16, 16, 30, 16, 16, 31), "F": (31, 16, 16, 30, 16, 16, 16),
    "G": (14, 17, 16, 23, 17, 17, 15), "H": (17, 17, 17, 31, 17, 17, 17),
    "I": (14, 4, 4, 4, 4, 4, 14), "J": (7, 2, 2, 2, 2, 18, 12),
    "K": (17, 18, 20, 24, 20, 18, 17), "L": (16, 16, 16, 16, 16, 16, 31),
    "M": (17, 27, 21, 21, 17, 17, 17), "N": (17, 17, 25, 21, 19, 17, 17),
    "O": (14, 17, 17, 17, 17, 17, 14), "P": (30, 17, 17, 30, 16, 16, 16),
    "Q": (14, 17, 17, 17, 21, 18, 13), "R": (30, 17, 17, 30, 20, 18, 17),
    "S": (15, 16, 16, 14, 1, 1, 30), "T": (31, 4, 4, 4, 4, 4, 4),
    "U": (17, 17, 17, 17, 17, 17, 14), "V": (17, 17, 17, 17, 17, 10, 4),
    "W": (17, 17, 17, 21, 21, 21, 10), "X": (17, 17, 10, 4, 10, 17, 17),
    "Y": (17, 17, 17, 10, 4, 4, 4), "Z": (31, 1, 2, 4, 8, 16, 31),
    "=": (0, 0, 31, 0, 31, 0, 0), ".": (0, 0, 0, 0, 0, 12, 12),
    ":": (0, 12, 12, 0, 12, 12, 0), "-": (0, 0, 0, 31, 0, 0, 0),
    "_": (0, 0, 0, 0, 0, 0, 31), "/": (1, 1, 2, 4, 8, 16, 16),
    "%": (24, 25, 2, 4, 8, 19, 3), "(": (2, 4, 8, 8, 8, 4, 2),
    ")": (8, 4, 2, 2, 2, 4, 8), ",": (0, 0, 0, 0, 12, 4, 8),
    "+": (0, 4, 4, 31, 4, 4, 0), "?": (14, 17, 1, 2, 4, 0, 4),
}
_GLYPH_W, _GLYPH_H, _ADVANCE = 5, 7, 6


def text_box(text: str, org) -> tuple:
    """(x0, y0, x1, y1), inclusive, of the pixels ``put_text`` may set."""
    x, y = int(org[0]), int(org[1])
    return (x, y - _GLYPH_H + 1, x + _ADVANCE * len(text) - 2, y)


def put_text(img: np.ndarray, text: str, org, color) -> None:
    """Write text in place, the baseline's left end at org (x, y); a
    character without a glyph is drawn as '?'."""
    x0, y0 = int(org[0]), int(org[1]) - _GLYPH_H + 1
    H, W = img.shape[:2]
    bits = 1 << np.arange(_GLYPH_W - 1, -1, -1)
    for i, ch in enumerate(text.upper()):
        rows = np.asarray(_FONT.get(ch, _FONT["?"]))
        on = (rows[:, None] & bits[None, :]) != 0            # [7, 5]
        ys, xs = np.nonzero(on)
        ys, xs = ys + y0, xs + x0 + _ADVANCE * i
        keep = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
        img[ys[keep], xs[keep]] = color


def draw_frame(img: np.ndarray, xy: np.ndarray, valid: np.ndarray,
               matched: np.ndarray | None = None,
               state_text: str = "") -> np.ndarray:
    """Keypoint overlay (reference: FrameDrawer::DrawFrame).

    img [H, W] grey; xy [N, 2]; valid [N]; matched [N] bool for keypoints
    associated to map points (drawn green, radius 2; the others orange,
    radius 1)."""
    img = np.asarray(img)
    vis = gray_to_bgr(img)
    xy = np.asarray(xy)
    for i in np.where(np.asarray(valid))[0]:
        u, v = int(xy[i, 0]), int(xy[i, 1])
        if not (0 <= u < img.shape[1] and 0 <= v < img.shape[0]):
            continue
        if matched is not None and matched[i]:
            fill_circle(vis, (u, v), 2, (0, 255, 0))
        else:
            fill_circle(vis, (u, v), 1, (255, 160, 0))
    if state_text:
        put_text(vis, state_text, (10, img.shape[0] - 12), (255, 255, 255))
    return vis


def draw_map_topdown(mapstore, size: int = 640, margin: float = 1.2,
                     axes=(0, 2)) -> np.ndarray:
    """Top-down orthographic render of map points, keyframe positions and
    the keyframe path (reference: MapDrawer::DrawMapPoints /
    DrawKeyFrames). axes: which world axes to plot (default x-z)."""
    vis = np.zeros((size, size, 3), np.uint8)
    pts = mapstore.pt_xyz[mapstore.pt_valid][:, axes]
    kfs = mapstore.kf_ids()
    centers = -np.einsum("kij,ki->kj",
                         np.transpose(mapstore.kf_R[kfs], (0, 2, 1)),
                         mapstore.kf_t[kfs])[:, axes]
    allp = np.concatenate([pts, centers], 0) if len(pts) else centers
    if len(allp) == 0:
        return vis
    lo = allp.min(0)
    hi = allp.max(0)
    span = max((hi - lo).max(), 1e-6) * margin
    mid = (hi + lo) / 2

    def to_px(p):
        q = (p - mid) / span + 0.5
        return (q * (size - 1)).astype(int)

    for p in to_px(pts):
        if 0 <= p[0] < size and 0 <= p[1] < size:
            vis[size - 1 - p[1], p[0]] = (140, 140, 140)
    cpx = to_px(centers)
    for a, b in zip(cpx[:-1], cpx[1:]):
        line(vis, (a[0], size - 1 - a[1]), (b[0], size - 1 - b[1]),
             (0, 128, 255))
    for p in cpx:
        fill_circle(vis, (p[0], size - 1 - p[1]), 2, (0, 255, 0))
    return vis


def save_png(path: str, img: np.ndarray):
    """Write a [H, W] grey or [H, W, 3] BGR uint8 image as PNG."""
    png.write_png(path, np.asarray(img))
