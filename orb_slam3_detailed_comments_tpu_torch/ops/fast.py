"""FAST-9/16 corner detection + spatially-uniform keypoint selection.

Counterpart of ``ops/fast.py`` of the JAX package (reference:
ORBextractor::ComputeKeyPointsOctTree, src/ORBextractor.cc:711-1061). The
corner score of every pixel is computed at once, 3x3 NMS is a max-pool
comparison, and spatial balancing is per-cell top-k (``ops/topk.py``)
followed by a global rank-major selection.

``select_levels`` selects every level of a frame at once: one
``topk.cell_topk_levels`` call and one sort. ``select_grid_topk``,
``select_from_nms_score`` and ``detect_level`` are the JAX package's
per-level functions, against which the tests hold it.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from . import topk

# Bresenham circle of radius 3, circularly ordered (dy, dx).
_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)

ARC_LEN = 9


def _arc_max_min9(D: torch.Tensor) -> torch.Tensor:
    """D [16, H, W] -> max over arc starts of the min over 9 circularly
    consecutive planes (windows by doubling 2 -> 4 -> 8 -> 9). Min/max are
    exact in any order, so this stacked form equals the JAX version's
    unrolled one bit for bit."""
    w2 = torch.minimum(D, D.roll(-1, 0))
    w4 = torch.minimum(w2, w2.roll(-2, 0))
    w8 = torch.minimum(w4, w4.roll(-4, 0))
    w9 = torch.minimum(w8, D.roll(-8, 0))
    return w9.amax(0)


def fast_score(img: torch.Tensor) -> torch.Tensor:
    """Per-pixel FAST-9/16 corner score, [H, W] -> [H, W] float32 (the max
    threshold at which the pixel is still a corner; non-corners <= 0).
    Shifts wrap around the image like the JAX version's jnp.roll."""
    D = torch.stack([torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1)) - img
                     for dy, dx in _CIRCLE])
    return torch.maximum(_arc_max_min9(D), _arc_max_min9(-D))


def nms3x3(score: torch.Tensor) -> torch.Tensor:
    """Keep local maxima of a 3x3 neighbourhood (suppressed pixels -> 0)."""
    mx = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= mx, score, torch.zeros_like(score))


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set for one pyramid level."""

    yx: torch.Tensor      # [N, 2] int32 (row, col) in level coords
    score: torch.Tensor   # [N] float32
    valid: torch.Tensor   # [N] bool


def select_grid_topk(score: torch.Tensor, n_target: int, cell: int = 32,
                     k_per_cell: int = 4, min_th: float = 7.0) -> Keypoints:
    """Spatially-uniform top-N selection: per-cell top-k, then global
    selection in cell-rank-major order (all cells' best first), ties within
    a rank broken by score, then by candidate order."""
    h, w = score.shape
    dev = score.device
    ncy, ncx = -(-h // cell), -(-w // cell)
    cells = topk.level_cells(score, (h, w), 0, cell).contiguous()
    top_s, top_i = topk.cell_topk(cells, k_per_cell)       # [C, k]
    top_i = top_i.long()
    cid = torch.arange(ncy * ncx, device=dev)
    iy = (cid // ncx)[:, None] * cell + top_i // cell
    ix = (cid % ncx)[:, None] * cell + top_i % cell

    cand_score = top_s.reshape(-1)
    cand_y = iy.reshape(-1)
    cand_x = ix.reshape(-1)
    rank = torch.arange(k_per_cell, device=dev).expand(
        top_s.shape).reshape(-1)
    ok = cand_score >= min_th
    # rank-major key: lower rank first, then higher score (score <= 255)
    key = torch.where(ok, rank.to(torch.float32) * 1024.0 - cand_score,
                      torch.full_like(cand_score, float("inf")))
    if key.shape[0] < n_target:   # tiny top level: fewer candidates
        pad = n_target - key.shape[0]
        key = F.pad(key, (0, pad), value=float("inf"))
        ok = F.pad(ok, (0, pad), value=False)
        cand_score = F.pad(cand_score, (0, pad))
        cand_y = F.pad(cand_y, (0, pad))
        cand_x = F.pad(cand_x, (0, pad))
    _, order = topk.stable_top(-key, n_target)
    return Keypoints(
        yx=torch.stack([cand_y[order], cand_x[order]], dim=-1).to(torch.int32),
        score=cand_score[order],
        valid=ok[order],
    )


def detect_level(level_img: torch.Tensor, content_hw, n_target: int,
                 cell: int = 32, k_per_cell: int = 4,
                 min_th: float = 7.0, margin: int = 16) -> Keypoints:
    """FAST + NMS + uniform selection for one pyramid level."""
    sc = nms3x3(fast_score(level_img))
    return select_from_nms_score(sc, content_hw, n_target, cell=cell,
                                 k_per_cell=k_per_cell, min_th=min_th,
                                 margin=margin)


def select_from_nms_score(score_nms: torch.Tensor, content_hw, n_target: int,
                          cell: int = 32, k_per_cell: int = 4,
                          min_th: float = 7.0, margin: int = 16) -> Keypoints:
    """Border mask + uniform selection on an NMS'd score map."""
    inside = topk.border_mask(score_nms.shape, content_hw, margin,
                              score_nms.device)
    sc = torch.where(inside, score_nms, torch.zeros_like(score_nms))
    return select_grid_topk(sc, n_target, cell=cell, k_per_cell=k_per_cell,
                            min_th=min_th)


def select_levels(score_maps, lay) -> Keypoints:
    """``select_from_nms_score`` for every level of a frame at once.

    score_maps: each level's NMS'd score map, of ``lay.shapes``; lay: the
    frame's ``layout.FrameLayout`` (its cfg gives cell, k_per_cell, min_th
    and margin). Returns one Keypoints of sum(lay.budgets) rows, level l's
    in the rows [sum(budgets[:l]), sum(budgets[:l + 1])), each level
    exactly what ``select_from_nms_score`` gives it. Every level's
    candidates sit in one row of an [L, M] key, padded with +inf keys
    (score 0, yx 0, invalid) to M = max_l max(C_l * k, n_l); one stable
    sort orders every row, and the padding sorts after every real
    candidate, as the per-level version's padding of a short level does.
    The one-frame case of ``select_levels_batch``."""
    kps = select_levels_batch(score_maps, lay, 1)
    return Keypoints(kps.yx[0], kps.score[0], kps.valid[0])


def select_levels_batch(score_maps, lay, n_frames: int) -> Keypoints:
    """``select_levels`` for a batch of frames of one layout at once:
    score_maps holds the frames' level maps frame after frame (n_frames x
    L maps), and every frame's cells ride one ``cell_topk_levels`` call;
    the [B, L, M] key is sorted row by row, so each frame gets exactly what
    ``select_levels`` gives it. Returns Keypoints with a leading axis of
    n_frames."""
    cfg = lay.cfg
    cell, k = cfg.cell, cfg.k_per_cell
    B = n_frames
    if tuple(tuple(s.shape) for s in score_maps) != lay.shapes * B:
        raise ValueError("select_levels: score maps not of the layout's "
                         "level shapes")
    top_s, top_i = topk.cell_topk_levels(score_maps, lay.contents * B,
                                         cfg.margin, k, cell)
    top_s, top_i = top_s.reshape(B, -1), top_i.reshape(B, -1)
    cand = torch.where(lay.pad, 0.0, top_s[:, lay.src])     # [B, L, M]
    ok = (cand >= cfg.min_th) & ~lay.pad
    # rank-major key: lower rank first, then higher score (score <= 255)
    key = torch.where(ok, lay.rank - cand, float("inf"))
    order = torch.sort(-key, dim=2, descending=True, stable=True)[1]
    sel = order.reshape(B, -1)[:, lay.cut] + lay.base       # [B, N] slots
    ti = torch.gather(top_i, 1, lay.src.reshape(-1)[sel]).long()
    on = ~lay.pad.reshape(-1)[sel]
    yx = torch.stack([(lay.y0[sel] + ti // cell) * on,
                      (lay.x0[sel] + ti % cell) * on], dim=-1)
    return Keypoints(yx=yx.to(torch.int32),
                     score=torch.gather(cand.reshape(B, -1), 1, sel),
                     valid=torch.gather(ok.reshape(B, -1), 1, sel))
