"""Contrast-limited adaptive histogram equalisation of uint8 images, in
numpy: ``cv2.createCLAHE(3.0, (8, 8)).apply(img)``, the TUM-VI mains' and
the inertial ROS nodes' CLAHE (e.g. ros_stereo_inertial.cc:70), rule for
rule as OpenCV computes it (clip limit c = 3.0, tiles t = 8 x 8):

- The image is cut into t tiles; when its sides do not divide, the
  histograms are taken over the image extended by BORDER_REFLECT_101 at
  the bottom and right (by ``8 - side % 8``).
- Each tile's 256-bin histogram is clipped at
  ``max(int(c * tile_area / 256), 1)``; the excess is spread
  over all bins (``excess // 256`` each) and its remainder one at a time
  from bin 0 in steps of ``max(256 // remainder, 1)``.
- The tile's table is ``saturate_cast<uchar>(cdf * (255 / tile_area))``,
  float32, rounded half to even.
- Each pixel blends the tables of its four nearest tile centres with
  float32 weights, ``(l00 (1 - a) + l01 a) (1 - b) + (l10 (1 - a) + l11 a)
  b``, and rounds half to even.
"""
from __future__ import annotations

import numpy as np

CLIP_LIMIT = 3.0
TILES = (8, 8)          # (x, y)


def _reflect101(n: int, size: int) -> np.ndarray:
    """Indices 0..n-1 folded into 0..size-1 by BORDER_REFLECT_101."""
    i = np.arange(n)
    if size == 1:
        return np.zeros(n, np.int64)
    period = 2 * size - 2
    i = np.mod(i, period)
    return np.where(i < size, i, period - i)


def clahe(img: np.ndarray) -> np.ndarray:
    """[H, W] uint8 -> [H, W] uint8 equalised."""
    src = np.asarray(img)
    if src.dtype != np.uint8 or src.ndim != 2:
        raise TypeError(f"clahe takes a [H, W] uint8 image, not "
                        f"{src.dtype} {src.shape}")
    H, W = src.shape
    tx, ty = TILES
    ext = src
    if W % tx or H % ty:
        rows = _reflect101(H + (ty - H % ty if H % ty else 0), H)
        cols = _reflect101(W + (tx - W % tx if W % tx else 0), W)
        ext = src[rows][:, cols]
    th, tw = ext.shape[0] // ty, ext.shape[1] // tx
    area = th * tw
    lut_scale = np.float32(255.0) / np.float32(area)
    limit = max(int(CLIP_LIMIT * area / 256), 1)
    # [ty, tx, 256] histograms
    blocks = ext.reshape(ty, th, tx, tw).transpose(0, 2, 1, 3).reshape(
        ty * tx, area)
    hist = np.zeros((ty * tx, 256), np.int64)
    np.add.at(hist, (np.repeat(np.arange(ty * tx), area),
                     blocks.ravel().astype(np.int64)), 1)
    excess = np.maximum(hist - limit, 0).sum(axis=1)
    hist = np.minimum(hist, limit)
    hist += (excess // 256)[:, None]
    residual = excess % 256
    for t in np.nonzero(residual)[0]:
        r = int(residual[t])
        hist[t, np.arange(0, 256, max(256 // r, 1))[:r]] += 1
    cdf = np.cumsum(hist, axis=1)
    lut = np.rint(cdf.astype(np.float32) * lut_scale)
    lut = np.clip(lut, 0, 255).astype(np.float32).reshape(ty, tx, 256)

    def axis(n, tile, count):
        f = np.arange(n, dtype=np.float32) * (np.float32(1.0)
                                              / np.float32(tile))
        f = f - np.float32(0.5)
        i1 = np.floor(f).astype(np.int64)
        a = (f - i1.astype(np.float32)).astype(np.float32)
        return (np.maximum(i1, 0), np.minimum(i1 + 1, count - 1), a,
                np.float32(1.0) - a)

    x1, x2, xa, xa1 = axis(W, tw, tx)
    y1, y2, ya, ya1 = axis(H, th, ty)
    v = src.astype(np.int64)
    Y1, Y2 = y1[:, None], y2[:, None]
    l11, l12 = lut[Y1, x1[None, :], v], lut[Y1, x2[None, :], v]
    l21, l22 = lut[Y2, x1[None, :], v], lut[Y2, x2[None, :], v]
    res = ((l11 * xa1 + l12 * xa) * ya1[:, None]
           + (l21 * xa1 + l22 * xa) * ya[:, None])
    return np.clip(np.rint(res), 0, 255).astype(np.uint8)
