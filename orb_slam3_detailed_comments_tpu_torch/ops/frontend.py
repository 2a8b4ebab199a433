"""Fused dense ORB front end: the CUDA kernel and its plain version.

Counterpart of ``ops/pallas_frontend.py`` of the JAX package. A level image
[H, W] becomes four maps of the same shape:

* ``score``: FAST-9/16 corner score over the ring ``fast._CIRCLE``, then 3x3
  non-maximum suppression (a pixel keeps its score if it is >= its eight
  neighbours, else 0);
* ``blur``: separable 7-tap sigma=2 Gaussian, horizontal then vertical, taps
  added in index order; the horizontal pass rounds each product and each
  sum, the vertical pass adds each tap as a fused multiply-add; rounded
  half to even;
* ``m10``, ``m01``: intensity-centroid moments of the circular patch of
  radius 15 (rows dv in [-15, 15] with half-widths ``_U_MAX[|dv|]``).

Borders replicate the edge pixel on all four sides (the ``"xla"`` front end
of ``ops/extractor.py`` wraps around instead; the two agree wherever a
keypoint can live, ``margin`` >= 16 pixels inside the content). As in the
JAX kernel, the NMS neighbour in a column outside the image is the score of
the nearest column inside, and in a row outside the image it is the score
computed from the replicated rows. ``score`` and ``blur`` equal the JAX
kernel's bit for bit; the moments agree to f32 summation order in the
interior and differ from it in the outermost 15 columns, where the JAX
kernel clamps the column coordinate in its weight.

``dense_frontend_levels`` takes all levels of a frame: CPU tensors take the
plain version level by level; CUDA tensors go to ``csrc/frontend.cu`` in one
launch (one flat grid of 64x64 tiles over all levels) for every
``MAX_LEVELS`` of them, or raise.
``dense_frontend`` is its one-level case.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

from .. import native
from . import fast
from .brief import HALF_PATCH
from .pyramid import _gauss_kernel1d, _pad_edge

# per-row circular half-widths of the orientation patch (reference:
# ORBextractor's umax table)
_U_MAX = np.floor(np.sqrt(np.maximum(
    HALF_PATCH * HALF_PATCH - np.arange(HALF_PATCH + 1) ** 2, 0)) + 1e-4
    ).astype(np.int32)
_TAPS = _gauss_kernel1d(7, 2.0)

MAX_LEVELS = 16          # levels in the kernel's by-value table, a launch

# host buffer handed to the C entry (kept alive for the process)
_TAPS_C = (ctypes.c_float * 7)(*[float(x) for x in _TAPS])


def _score_plain(img: torch.Tensor) -> torch.Tensor:
    H, W = img.shape
    B = H + 2                       # rows -1 .. H: the tile and its NMS ring
    xp = _pad_edge(img, 4, 4, 3, 3)
    center = xp[3:3 + B, 3:3 + W]
    D = torch.stack([xp[3 + int(dy):3 + int(dy) + B,
                        3 + int(dx):3 + int(dx) + W] - center
                     for dy, dx in fast._CIRCLE])
    s = torch.maximum(fast._arc_max_min9(D), fast._arc_max_min9(-D))
    sp = _pad_edge(s, 0, 0, 1, 1)                            # [H + 2, W + 2]
    mx = F.max_pool2d(sp[None, None], 3, stride=1)[0, 0]     # [H, W]
    si = s[1:1 + H]
    return torch.where(si >= mx, si, torch.zeros_like(si))


def _blur_plain(img: torch.Tensor) -> torch.Tensor:
    H, W = img.shape
    k = [float(x) for x in _TAPS]
    xp = _pad_edge(img, 3, 3, 3, 3)
    h = k[0] * xp[:, 0:W]
    for i in range(1, 7):
        h = h + k[i] * xp[:, i:i + W]
    # the vertical pass as fused multiply-adds, out = fma(k[i], h, out):
    # the product of two float32 values is exact in float64, and the sum
    # is rounded once to float32 (the rounding of the JAX kernel on the
    # CPU, and of __fmaf_rn on the card)
    out = k[0] * h[0:H]
    for i in range(1, 7):
        out = (k[i] * h[i:i + H].double() + out.double()).float()
    return torch.round(out)


def _moments_plain(img: torch.Tensor):
    H, W = img.shape
    R = HALF_PATCH
    # the window is symmetric, so a constant cancels: centring only keeps
    # the f32 sums small
    xp = _pad_edge(img - img.mean(), R, R, R, R)             # [H+2R, W+2R]
    rs = xp[:, R:R + W].clone()        # row sums over |u| <= w, all rows
    ts = torch.zeros_like(rs)          # sum of u * f over |u| <= w
    by_width, w_done = {}, 0
    for w in sorted({int(x) for x in _U_MAX}):
        for u in range(w_done + 1, w + 1):
            right, left = xp[:, R + u:R + u + W], xp[:, R - u:R - u + W]
            rs = rs + (right + left)
            ts = ts + float(u) * (right - left)
        w_done = w
        by_width[w] = (rs, ts)
    m10 = torch.zeros((H, W), dtype=img.dtype, device=img.device)
    m01 = torch.zeros_like(m10)
    for dv in range(-R, R + 1):
        rs, ts = by_width[int(_U_MAX[abs(dv)])]
        m10 = m10 + ts[R + dv:R + dv + H]
        if dv != 0:
            m01 = m01 + float(dv) * rs[R + dv:R + dv + H]
    return m10, m01


def dense_frontend_plain(img: torch.Tensor):
    """[H, W] float32 -> (score, blur, m10, m01), each [H, W] float32, from
    torch ops with edge padding."""
    m10, m01 = _moments_plain(img)
    return _score_plain(img), _blur_plain(img), m10, m01


@functools.lru_cache(maxsize=16)
def _layout(shapes):
    """Of a frame's level shapes: each level's size and offset in the flat
    output buffer, the buffer's length, and the heights and widths as the C
    entry takes them."""
    sizes = [h * w for h, w in shapes]
    offsets = [sum(sizes[:k]) for k in range(len(sizes))]
    return (sizes, offsets, sum(sizes), *map(native.int_array, zip(*shapes)))


@functools.cache
def _check_kernel_umax() -> None:
    """The kernel has the half-width table as compile-time constants: hold
    them against ``_U_MAX``, once (a failure is not cached)."""
    got = (ctypes.c_int * 16)()
    native.check(native.lib().slam_frontend_umax(ctypes.addressof(got)),
                 "frontend_umax")
    want = [int(x) for x in _U_MAX]
    if list(got) != want:
        raise RuntimeError(f"csrc/frontend.cu has half-widths {list(got)}, "
                           f"ops/frontend.py {want}")


def dense_frontend_levels(levels):
    """The four dense maps of every level image of a frame.

    levels: [H, W] float32 tensors on one device. Returns one (score, blur,
    m10, m01) tuple per level: the plain version on the CPU, one kernel
    launch for every ``MAX_LEVELS`` levels on the card."""
    levels = list(levels)
    if not levels:
        return []
    dev = levels[0].device
    if any(l.device != dev for l in levels):
        raise ValueError("dense_frontend_levels: levels on different devices")
    if len(levels) > MAX_LEVELS and dev.type == "cuda":
        return [maps for g in range(0, len(levels), MAX_LEVELS)
                for maps in dense_frontend_levels(levels[g:g + MAX_LEVELS])]
    if dev.type == "cpu":
        return [dense_frontend_plain(l) for l in levels]
    if dev.type != "cuda":
        raise ValueError(f"dense_frontend_levels: unsupported device {dev}")
    for k, l in enumerate(levels):
        native.require(l, f"levels[{k}]", torch.float32, 2, dev)
        if l.numel() == 0:
            raise ValueError("dense_frontend_levels: empty image")
    _check_kernel_umax()
    shapes = tuple((l.shape[0], l.shape[1]) for l in levels)
    sizes, offsets, total, heights, widths = _layout(shapes)
    # one allocation: map m of level k is out[m, offset_k : offset_k + H * W]
    out = torch.empty((4, total), dtype=torch.float32, device=dev)
    maps = [chunk.view(4, h, w).unbind(0)
            for chunk, (h, w) in zip(out.split(sizes, dim=1), shapes)]
    pointers = ctypes.c_void_p * len(levels)
    base = out.data_ptr()
    rc = native.lib().slam_dense_frontend_levels(
        len(levels), pointers(*[l.data_ptr() for l in levels]), heights,
        widths, *(pointers(*[base + 4 * (m * total + o) for o in offsets])
                  for m in range(4)),
        ctypes.addressof(_TAPS_C), native.stream_ptr(levels[0]))
    native.check(rc, "dense_frontend")
    native.launches.bump("dense_frontend")
    return maps


def dense_frontend(img: torch.Tensor):
    """The four dense maps of one level: the one-level case of
    ``dense_frontend_levels``."""
    return dense_frontend_levels([img])[0]
