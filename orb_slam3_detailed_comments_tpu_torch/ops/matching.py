"""Descriptor matching: batched Hamming searches.

Counterpart of ``ops/matching.py`` of the JAX package (reference:
ORBmatcher, src/ORBmatcher.cc). Dense [Q, K] searches with every gate
(search window, pyramid level, already-matched) applied as a mask. The
unmasked nearest-neighbour search and the projection search go through
the best-2 searches of ``ops/hamming.py`` at every shape: their plain
versions on the CPU, their kernels on the card.

Thresholds follow the reference (ORBmatcher.cc:35-37).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from . import hamming
from .brief import floor_mod
from .topk import stable_top

TH_HIGH = 100
TH_LOW = 50
HISTO_LENGTH = 30
BIG = hamming.BIG

hamming_matrix = hamming.hamming_matrix
_masked_best2 = hamming.masked_best2


class MatchResult(NamedTuple):
    idx: torch.Tensor    # [Q] int32 index into the K set (undefined if invalid)
    dist: torch.Tensor   # [Q] int32 Hamming distance
    valid: torch.Tensor  # [Q] bool


def rotation_consistency_mask(dangle: torch.Tensor, valid: torch.Tensor,
                              n_bins: int = HISTO_LENGTH,
                              keep_top: int = 3) -> torch.Tensor:
    """Keep matches whose angle delta falls in the top-`keep_top` histogram
    bins (reference: ORBmatcher::ComputeThreeMaxima, ORBmatcher.cc:2335)."""
    two_pi = 2.0 * math.pi
    frac = floor_mod(dangle, two_pi) / two_pi
    bins = torch.clamp((frac * n_bins).to(torch.int32), 0, n_bins - 1).long()
    hist = torch.zeros(n_bins, dtype=torch.int32, device=dangle.device)
    hist = hist.index_add(0, bins, valid.to(torch.int32))
    top_vals, top_idx = stable_top(hist, keep_top)
    # reference drops bins below 10% of the max bin
    floor = torch.clamp((0.1 * top_vals[0]).to(torch.int32), min=1)
    ok_bin = top_vals >= floor
    keep = torch.zeros(n_bins, dtype=torch.bool, device=dangle.device)
    keep[top_idx] = ok_bin
    return valid & keep[bins]


def match_nn(da: torch.Tensor, va: torch.Tensor, db: torch.Tensor,
             vb: torch.Tensor, max_dist: int = TH_LOW, ratio: float = 0.9,
             mutual: bool = True,
             extra_mask: torch.Tensor | None = None) -> MatchResult:
    """Nearest-neighbour descriptor matching with ratio test.

    da [Q, 8], db [K, 8] int32; va/vb validity masks; extra_mask [Q, K]
    bool restricts admissible pairs (search windows, level gates...). The
    unmasked case runs ``hamming.hamming_best2``."""
    Q = da.shape[0]
    arange_q = torch.arange(Q, dtype=torch.int32, device=da.device)
    if extra_mask is None:
        d1, i1, d2 = hamming.hamming_best2(da, db, vb)
        ok = (va & (d1 <= max_dist)
              & (d1.to(torch.float32) <= ratio * d2.to(torch.float32)))
        if mutual:
            _, j1, _ = hamming.hamming_best2(db, da, va)
            ok = ok & (j1[i1.long()] == arange_q)
        return MatchResult(idx=i1, dist=d1, valid=ok)
    dist = hamming_matrix(da, db)
    mask = va[:, None] & vb[None, :] & extra_mask
    d1, i1, d2 = _masked_best2(dist, mask)
    ok = (d1 <= max_dist) & (d1.to(torch.float32)
                             <= ratio * d2.to(torch.float32))
    if mutual:
        dT = torch.where(mask, dist, torch.full_like(dist, BIG)).T
        j1 = torch.argmin(dT, dim=1).to(torch.int32)
        ok = ok & (j1[i1.long()] == arange_q)
    return MatchResult(idx=i1, dist=d1, valid=ok)


def window_mask(xy_q: torch.Tensor, xy_k: torch.Tensor, radius) -> torch.Tensor:
    """[Q, K] bool: |x| and |y| displacement within radius (scalar or [Q])."""
    d = torch.abs(xy_q[:, None, :] - xy_k[None, :, :])
    r = torch.as_tensor(radius, dtype=xy_q.dtype, device=xy_q.device)
    if r.dim() == 1:
        r = r[:, None]
    return (d[..., 0] <= r) & (d[..., 1] <= r)


def search_for_initialization(f1, f2, window: float = 100.0,
                              ratio: float = 0.9,
                              max_dist: int = TH_LOW) -> MatchResult:
    """Monocular-init matching between two frames (reference:
    ORBmatcher::SearchForInitialization, ORBmatcher.cc:734): level-0
    keypoints, windowed, ratio test + rotation-consistency histogram."""
    wmask = window_mask(f1.xy, f2.xy, window)
    lmask = (f1.level[:, None] == 0) & (f2.level[None, :] == 0)
    res = match_nn(f1.desc, f1.valid, f2.desc, f2.valid,
                   max_dist=max_dist, ratio=ratio, mutual=True,
                   extra_mask=wmask & lmask)
    dang = f1.angle - f2.angle[res.idx.long()]
    keep = rotation_consistency_mask(dang, res.valid)
    return MatchResult(res.idx, res.dist, keep)


def search_by_projection(proj_xy: torch.Tensor, proj_valid: torch.Tensor,
                         proj_desc: torch.Tensor, proj_level: torch.Tensor,
                         feat, radius, level_lo=-1, level_hi=1,
                         max_dist: int = TH_HIGH, ratio: float = 0.8,
                         taken: torch.Tensor | None = None) -> MatchResult:
    """Match projected map points against a frame's keypoints (reference:
    ORBmatcher::SearchByProjection, ORBmatcher.cc:45,1950).

    proj_*: per-candidate projected pixel, predicted level, descriptor.
    feat: FrameFeatures of the frame. radius: scalar or [P] px at level 0.
    taken: [N] bool keypoints to skip. The gates and the best-2 scan are
    fused in ``hamming.hamming_best2_windowed``."""
    kp_ok = feat.valid if taken is None else (feat.valid & ~taken)
    Q = proj_xy.shape[0]
    dev = proj_xy.device

    def per_query(x, dtype):
        # a Python number is filled on the device: uploading it would be a
        # host sync
        if torch.is_tensor(x):
            return x.to(dev, dtype).expand(Q).contiguous()
        return torch.full((Q,), x, dtype=dtype, device=dev)

    d1, i1, d2 = hamming.hamming_best2_windowed(
        proj_desc.contiguous(), proj_xy.contiguous(),
        proj_level.to(torch.int32).contiguous(),
        per_query(radius, torch.float32),
        per_query(level_lo, torch.int32), per_query(level_hi, torch.int32),
        proj_valid.contiguous(), feat.desc.contiguous(),
        feat.xy.contiguous(), feat.level.contiguous(), kp_ok.contiguous())
    ok = (d1 <= max_dist) & (d1.to(torch.float32)
                             <= ratio * d2.to(torch.float32))
    return MatchResult(idx=i1, dist=d1, valid=ok)
