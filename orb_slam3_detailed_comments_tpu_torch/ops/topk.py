"""Per-cell top-k for keypoint selection: the CUDA kernel and its plain
version.

Counterpart of ``ops/pallas_topk.py`` of the JAX package. The contract is
``lax.top_k``'s: values in descending order, and the FIRST index wins a
tie. ``torch.topk`` does not promise which index wins a tie, so the plain
version is a stable descending sort followed by a slice (``stable_top``,
which every other top-k of the port uses too).

``cell_topk_levels`` takes the NMS'd score maps of every pyramid level of a
frame and cuts each into 32x32 cells, row-major, level after level. The
value at (y, x) is the score inside ``border_mask`` and 0 elsewhere, which
is the zero pad and border mask of ``fast.select_from_nms_score``. CPU
tensors take the plain version (``level_cells``, then ``cell_topk_plain``);
CUDA tensors launch ``csrc/topk.cu`` once for all levels, reading each map
where it lies, or raise. ``cell_topk`` on a [C, 1024] matrix is its
one-level case: the matrix is a [32 C, 32] image with no mask.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from .. import native

CELL = 32          # the kernel's cell side: one lane per column
MAX_LEVELS = 16    # capacity of the kernel's by-value level table


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


def cell_topk_levels(score_maps, contents, margin: int, k: int,
                     cell: int = CELL):
    """Top-k of every cell of every level: (values [C_total, k] float32,
    in-cell indices cell * dy + dx [C_total, k] int32), descending, first
    index winning ties. score_maps: up to ``MAX_LEVELS`` [h, w] float32
    maps on one device; contents: each level's (content h, content w)."""
    maps = list(score_maps)
    contents = tuple((int(a), int(b)) for a, b in contents)
    if not maps or len(maps) != len(contents):
        raise ValueError("cell_topk_levels: one content shape for each of "
                         "one or more score maps")
    if len(maps) > MAX_LEVELS:
        raise ValueError(f"cell_topk_levels: {len(maps)} levels, the "
                         f"kernel's table holds {MAX_LEVELS}")
    dev = maps[0].device
    if any(m.device != dev for m in maps):
        raise ValueError("cell_topk_levels: maps on different devices")
    if dev.type == "cpu":
        return cell_topk_levels_plain(maps, contents, margin, k, cell)
    if dev.type != "cuda":
        raise ValueError(f"cell_topk_levels: unsupported device {dev}")
    if cell != CELL or not 0 < k <= CELL * CELL:
        raise ValueError(f"cell_topk_levels: the kernel takes {CELL}x{CELL} "
                         f"cells and 0 < k <= {CELL * CELL} (cell={cell}, "
                         f"k={k})")
    for i, m in enumerate(maps):
        native.require(m, f"score_maps[{i}]", torch.float32, 2, dev)
        if m.numel() == 0:
            raise ValueError("cell_topk_levels: empty score map")
    shapes = [tuple(m.shape) for m in maps]
    rows = sum(-(-h // CELL) * -(-w // CELL) for h, w in shapes)
    h, w = map(native.int_array, zip(*shapes))
    ch, cw = map(native.int_array, zip(*contents))
    vals = torch.empty((rows, k), dtype=torch.float32, device=dev)
    idx = torch.empty((rows, k), dtype=torch.int32, device=dev)
    pointers = ctypes.c_void_p * len(maps)
    rc = native.lib().slam_cell_topk_levels(
        len(maps), pointers(*[m.data_ptr() for m in maps]), h, w, ch, cw,
        int(margin), vals.data_ptr(), idx.data_ptr(), k,
        native.stream_ptr(maps[0]))
    native.check(rc, "cell_topk")
    native.launches["cell_topk"] += 1
    return vals, idx


def cell_topk(cells: torch.Tensor, k: int):
    """Top-k of each row of a [C, A] matrix, descending, first index wins
    ties. On the card A must be 1024: the one-level case of
    ``cell_topk_levels`` on the matrix viewed as a [32 C, 32] image."""
    if cells.device.type == "cpu":
        return cell_topk_plain(cells, k)
    if cells.device.type != "cuda":
        raise ValueError(f"cell_topk: unsupported device {cells.device}")
    native.require(cells, "cells", torch.float32, 2, cells.device)
    C, A = cells.shape
    if A != CELL * CELL:
        raise ValueError(f"cell_topk: row length {A}, the kernel takes "
                         f"{CELL * CELL}")
    return cell_topk_levels([cells.view(CELL * C, CELL)],
                            [(CELL * C, CELL)], 0, k)
