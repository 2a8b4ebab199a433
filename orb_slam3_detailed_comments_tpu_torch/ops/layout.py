"""A frame's pyramid layout and the constant tables that read it.

For one (``OrbConfig``, frame size, device): each level's shape, content
size and keypoint budget, the per-keypoint tables of the extractor
(keypoints level-major) and the candidate-slot tables of
``fast.select_levels``. Built with numpy and uploaded once (a per-frame
upload from host memory would be a host sync).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import pyramid


def level_budgets(cfg) -> list:
    """Per-level feature budgets, geometric in 1/scale like the reference
    (ORBextractor ctor: nDesiredFeaturesPerScale)."""
    f = 1.0 / cfg.scale
    total = cfg.n_features
    n0 = total * (1 - f) / (1 - f ** cfg.n_levels)
    budgets = []
    acc = 0
    for lv in range(cfg.n_levels - 1):
        b = int(round(n0 * f ** lv))
        budgets.append(b)
        acc += b
    budgets.append(max(total - acc, 8))
    return budgets


def content_dims(cfg, h: int, w: int) -> list:
    """Each level's (content h, content w): the resized image before the
    pyramid pads it to the level shape."""
    return [(int(round(h / cfg.scale ** lv)), int(round(w / cfg.scale ** lv)))
            for lv in range(cfg.n_levels)]


class FrameLayout(NamedTuple):
    cfg: object           # the extractor.OrbConfig it was built for
    shapes: tuple         # each level's (h, w)
    contents: tuple       # each level's (content h, content w)
    budgets: tuple        # n_l keypoints a level; N = sum
    # per keypoint [N], level-major
    level: torch.Tensor   # int32 pyramid level
    scale: torch.Tensor   # float32: the level's scale factor
    ch: torch.Tensor      # int32: the level's content height
    cw: torch.Tensor      # int32: ... and width
    row_off: torch.Tensor  # int32: the level's first row in the atlas
    # select_levels: candidate (l, p) is level l's p-th (cell-major, then
    # rank) of M slots; slots past the level's C_l * k candidates are padding
    src: torch.Tensor     # [L, M] int64: the slot's row of the flat top-k
    pad: torch.Tensor     # [L, M] bool
    rank: torch.Tensor    # [L, M] float32: rank * 1024, the key's band
    y0: torch.Tensor      # [L * M] int64: the slot's cell origin (0 on pad)
    x0: torch.Tensor      # [L * M] int64
    cut: torch.Tensor     # [N] int64: slots l * M + j, j < n_l
    base: torch.Tensor    # [N] int64: l * M of each of them
    # a batch of frames (``extractor.extract_batch``): each keypoint's level
    # in the frame's level maps laid end to end, n_px pixels a frame
    map_off: torch.Tensor  # [N] int64: the level's first pixel
    lh: torch.Tensor      # [N] int64: the level's height
    lw: torch.Tensor      # [N] int64: ... and width
    n_px: int


@functools.lru_cache(maxsize=8)
def frame_layout(cfg, h: int, w: int, device: torch.device) -> FrameLayout:
    """The layout of an [h, w] frame under cfg, its tables on device."""
    shapes = pyramid.level_shapes(h, w, cfg.n_levels, cfg.scale)
    contents = content_dims(cfg, h, w)
    budgets = level_budgets(cfg)
    cell, k = cfg.cell, cfg.k_per_cell
    grid = [(-(-lh // cell), -(-lw // cell)) for lh, lw in shapes]
    n_cand = [ncy * ncx * k for ncy, ncx in grid]
    M = max(max(c, n) for c, n in zip(n_cand, budgets))
    p = np.arange(M)
    src, pad, rank, y0, x0 = [], [], [], [], []
    row0 = 0
    for (ncy, ncx), c in zip(grid, n_cand):
        real = p < c
        cid = np.where(real, p // k, 0)
        src.append(np.where(real, row0 * k + p, 0))
        pad.append(~real)
        rank.append((p % k).astype(np.float32) * np.float32(1024.0))
        y0.append(np.where(real, (cid // ncx) * cell, 0))
        x0.append(np.where(real, (cid % ncx) * cell, 0))
        row0 += ncy * ncx
    per = lambda a, dt: np.repeat(np.asarray(a, dt), budgets)
    dims = np.array(contents, np.int32)
    up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    return FrameLayout(
        cfg, tuple(shapes), tuple(contents), tuple(budgets),
        level=up(per(np.arange(cfg.n_levels), np.int32)),
        scale=up(per(pyramid.scale_factors(cfg.n_levels, cfg.scale),
                     np.float32)),
        ch=up(per(dims[:, 0], np.int32)), cw=up(per(dims[:, 1], np.int32)),
        row_off=up(per(np.cumsum([0] + [s[0] for s in shapes[:-1]]),
                       np.int32)),
        src=up(np.stack(src)), pad=up(np.stack(pad)), rank=up(np.stack(rank)),
        y0=up(np.concatenate(y0)), x0=up(np.concatenate(x0)),
        cut=up(np.concatenate([l * M + np.arange(n)
                               for l, n in enumerate(budgets)])),
        base=up(np.concatenate([np.full(n, l * M)
                                for l, n in enumerate(budgets)])),
        map_off=up(per(np.cumsum([0] + [h * w for h, w in shapes[:-1]]),
                       np.int64)),
        lh=up(per([h for h, _ in shapes], np.int64)),
        lw=up(per([w for _, w in shapes], np.int64)),
        n_px=sum(h * w for h, w in shapes))
