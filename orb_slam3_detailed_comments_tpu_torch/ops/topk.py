"""Per-cell top-k for keypoint selection: the CUDA kernel and its plain
version.

Counterpart of ``ops/pallas_topk.py`` of the JAX package. The contract is
``lax.top_k``'s: values in descending order, and the FIRST index wins a
tie. ``torch.topk`` does not promise which index wins a tie, so the plain
version is a stable descending sort followed by a slice (``stable_top``,
which every other top-k of the port uses too).

``cell_topk_levels`` takes the NMS'd score maps of every pyramid level of a
frame and cuts each into cell x cell cells, row-major, level after level.
The value at (y, x) is the score inside ``border_mask`` and 0 elsewhere,
which is the zero pad and border mask of ``fast.select_from_nms_score``.
CPU tensors take the plain version (``level_cells``, then
``cell_topk_plain``). CUDA tensors follow the JAX package's shape rule
(``ops/fast.py:118-125``: its kernel for a cell whose area is a multiple of
128, ``lax.top_k`` for any other): a cell of area 128 m (16, 32, 48, 80,
...) launches ``csrc/topk.cu``, once for every ``MAX_LEVELS`` levels,
reading each map where it lies; any other cell takes the plain version.
That is a rule on the shape, not a fallback: a launch that fails raises,
and so does a k outside [1, area] on a kernel shape. ``cell_topk`` on a
[C, A] matrix is its one-level case under the same rule on A: for A =
cell * cell the matrix is a [cell C, cell] image with no mask, for any
other A an image [C, A] of 1 x A cells.
"""
from __future__ import annotations

import ctypes
import math

import torch
import torch.nn.functional as F

from .. import native

CELL = 32          # the default cell side (OrbConfig.cell)
MAX_LEVELS = 16    # levels in the kernel's by-value table, a launch


def stable_top(x: torch.Tensor, k: int, dim: int = -1):
    """(values, indices) of the k largest along dim, first index winning
    ties (``lax.top_k``'s order; ``torch.topk`` leaves ties unspecified)."""
    v, i = torch.sort(x, dim=dim, descending=True, stable=True)
    return v.narrow(dim, 0, k), i.narrow(dim, 0, k)


def cell_topk_plain(cells: torch.Tensor, k: int):
    """cells [C, A] float32 -> (values [C, k] float32, indices [C, k] int32)."""
    vals, idx = stable_top(cells, k, dim=1)
    return vals.contiguous(), idx.to(torch.int32).contiguous()


def border_mask(shape, content_hw, margin: int, device="cpu") -> torch.Tensor:
    """True inside [margin, content - margin) on both axes."""
    h, w = shape
    ch, cw = content_hw
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= margin) & (ys < ch - margin) & (xs >= margin) & (xs < cw - margin)


def level_cells(score: torch.Tensor, content_hw, margin: int,
                cell: int = CELL) -> torch.Tensor:
    """[ncy * ncx, cell * cell] cells of one score map, row-major: the map
    masked to ``border_mask`` and zero-padded to whole cells."""
    h, w = score.shape
    inside = border_mask((h, w), content_hw, margin, score.device)
    s = F.pad(torch.where(inside, score, torch.zeros_like(score)),
              (0, (-w) % cell, 0, (-h) % cell), value=0.0)
    H, W = s.shape
    return s.reshape(H // cell, cell, W // cell, cell).permute(
        0, 2, 1, 3).reshape(-1, cell * cell)


def cell_topk_levels_plain(score_maps, contents, margin: int, k: int,
                           cell: int = CELL):
    """Every level's cells stacked, then ``cell_topk_plain``."""
    cells = torch.cat([level_cells(s, c, margin, cell)
                       for s, c in zip(score_maps, contents)])
    return cell_topk_plain(cells, k)


def on_kernel(area: int, k: int) -> bool:
    """The card's shape rule (see the module's docstring): True for a cell
    of ``area`` entries that goes to the kernel, False for one that takes
    the plain version."""
    if area % 128:
        return False
    if not 0 < k <= area:
        raise ValueError(f"cell_topk: k = {k} outside [1, {area}]")
    return True


def cell_topk_levels(score_maps, contents, margin: int, k: int,
                     cell: int = CELL):
    """Top-k of every cell of every level: (values [C_total, k] float32,
    in-cell indices cell * dy + dx [C_total, k] int32), descending, first
    index winning ties. score_maps: [h, w] float32 maps on one device (any
    number: the kernel takes ``MAX_LEVELS`` a launch); contents: each
    level's (content h, content w)."""
    maps = list(score_maps)
    contents = tuple((int(a), int(b)) for a, b in contents)
    if not maps or len(maps) != len(contents):
        raise ValueError("cell_topk_levels: one content shape for each of "
                         "one or more score maps")
    dev = maps[0].device
    if any(m.device != dev for m in maps):
        raise ValueError("cell_topk_levels: maps on different devices")
    if dev.type == "cpu" or (dev.type == "cuda"
                             and not on_kernel(cell * cell, k)):
        return cell_topk_levels_plain(maps, contents, margin, k, cell)
    if dev.type != "cuda":
        raise ValueError(f"cell_topk_levels: unsupported device {dev}")
    return _launch(maps, contents, margin, k, cell, cell)


def _launch(maps, contents, margin, k, cell_h, cell_w):
    """csrc/topk.cu over cells of cell_h x cell_w, MAX_LEVELS maps a
    launch."""
    dev = maps[0].device
    for i, m in enumerate(maps):
        native.require(m, f"score_maps[{i}]", torch.float32, 2, dev)
        if m.numel() == 0:
            raise ValueError("cell_topk_levels: empty score map")
    shapes = [tuple(m.shape) for m in maps]
    n_cells = [-(-h // cell_h) * -(-w // cell_w) for h, w in shapes]
    vals = torch.empty((sum(n_cells), k), dtype=torch.float32, device=dev)
    idx = torch.empty((sum(n_cells), k), dtype=torch.int32, device=dev)
    for g in range(0, len(maps), MAX_LEVELS):
        sl = slice(g, g + MAX_LEVELS)
        row0 = sum(n_cells[:g])
        h, w = map(native.int_array, zip(*shapes[sl]))
        ch, cw = map(native.int_array, zip(*contents[sl]))
        pointers = ctypes.c_void_p * len(maps[sl])
        rc = native.lib().slam_cell_topk_levels(
            len(maps[sl]), pointers(*[m.data_ptr() for m in maps[sl]]), h, w,
            ch, cw, int(margin), int(cell_h), int(cell_w),
            vals[row0:].data_ptr(), idx[row0:].data_ptr(), k,
            native.stream_ptr(maps[0]))
        native.check(rc, "cell_topk")
        native.launches.bump("cell_topk")
    return vals, idx


def cell_topk(cells: torch.Tensor, k: int):
    """Top-k of each row of a [C, A] matrix, descending, first index wins
    ties. On the card a row length A of 128 m is the one-level case of the
    kernel (a square A as the [cell C, cell] image, any other as 1 x A
    cells); any other A takes the plain version, as in
    ``cell_topk_levels``."""
    if cells.device.type == "cpu":
        return cell_topk_plain(cells, k)
    if cells.device.type != "cuda":
        raise ValueError(f"cell_topk: unsupported device {cells.device}")
    native.require(cells, "cells", torch.float32, 2, cells.device)
    C, A = cells.shape
    if not on_kernel(A, k):
        return cell_topk_plain(cells, k)
    cell = math.isqrt(A)
    if cell * cell == A:
        return _launch([cells.view(cell * C, cell)], [(cell * C, cell)], 0,
                       k, cell, cell)
    return _launch([cells], [(C, A)], 0, k, 1, A)
