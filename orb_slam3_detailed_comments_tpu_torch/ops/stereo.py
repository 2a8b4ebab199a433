"""Rectified stereo matching (row-banded Hamming search + SAD subpixel) and
the epipolar SAD refinement of non-rectified (fisheye) stereo matches.

Counterpart of ``ops/stereo.py`` of the JAX package (reference:
Frame::ComputeStereoMatches, src/Frame.cc:1102). The row band, disparity
range and level gates are one dense [L, R] mask over all feature pairs,
the Hamming argmin is batched, and every SAD window is an integer-corner
window from ``patches.gather_patches`` (its one-image case, on the image
itself: the corners are clipped so that a window lies inside it) with the
fractional offset applied by shifts of one. A rectified frame makes 2
gathers (12x12 left, 12x22 right), a fisheye frame's refinement 12 of
12x12.

The outlier cut keeps the JAX code's behaviour bit for bit: its median is
``jnp.median`` over the SAD minima with NaN where a match is not ok, and a
median with any NaN is NaN, so on a frame where any feature is not ok (a
padded one, one without a match) the cut never fires (``nan_median``).
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from . import hamming, patches
from .matching import BIG, TH_HIGH, TH_LOW

SAD_W = 5          # half window (11x11), reference Frame.cc:1230
SLIDE_L = 5        # sliding range +-5, reference Frame.cc:1233


class StereoMatches(NamedTuple):
    u_right: torch.Tensor    # [L] refined right u coordinate (level-0 px)
    disparity: torch.Tensor  # [L]
    depth: torch.Tensor      # [L]
    valid: torch.Tensor      # [L]


@functools.lru_cache(maxsize=None)
def _level_scales(device: torch.device, n_levels: int, scale: float):
    return torch.from_numpy(
        (scale ** np.arange(n_levels)).astype(np.float32)).to(device)


def nan_median(x: torch.Tensor) -> torch.Tensor:
    """``jnp.median`` of a 1-D tensor: NaN if any entry is NaN, else the
    mean of the two middle values, (lo + hi) * 0.5, for an even length."""
    s = torch.sort(x).values
    n = x.shape[0]
    med = (s[(n - 1) // 2] + s[n // 2]) * 0.5
    return torch.where(torch.isnan(x).any(), torch.full_like(med, np.nan),
                       med)


def bilinear_windows(img: torch.Tensor, uc: torch.Tensor, vc: torch.Tensor,
                     half_h: int, half_w: int) -> torch.Tensor:
    """[N, 2 half_h + 1, 2 half_w + 1] bilinear patches of img [H, W]
    centred at (uc, vc), from ONE [2 half_h + 2, 2 half_w + 2]
    integer-corner gather each (``stereo.py:76-90`` and ``:115-134`` of the
    JAX package; corners clipped to [0, H - (P + 1)] x [0, W - (w + 1)])."""
    P, w = 2 * half_h + 1, 2 * half_w + 1
    H, W = img.shape
    y0 = torch.clamp(torch.floor(vc).to(torch.int32) - half_h, 0, H - (P + 1))
    x0 = torch.clamp(torch.floor(uc).to(torch.int32) - half_w, 0, W - (w + 1))
    fy = torch.clamp(vc - half_h - y0, 0.0, 1.0)[:, None, None]
    fx = torch.clamp(uc - half_w - x0, 0.0, 1.0)[:, None, None]
    rc = torch.stack([y0, x0], dim=-1).contiguous()
    Wp = patches.gather_patches(img, rc, P + 1, w + 1)
    return ((1 - fy) * (1 - fx) * Wp[:, :P, :w]
            + (1 - fy) * fx * Wp[:, :P, 1:]
            + fy * (1 - fx) * Wp[:, 1:, :w]
            + fy * fx * Wp[:, 1:, 1:])


def _centred(p: torch.Tensor) -> torch.Tensor:
    return p - p[:, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]


def _sad(pl: torch.Tensor, pr: torch.Tensor) -> torch.Tensor:
    """[N] sums of absolute differences of two windows [N, h, w], summed
    in float64 and rounded once to float32: the sum no longer depends on
    the device's reduction order, so that the card and the CPU fit the
    same parabola (its vertex is sensitive where the SAD surface is
    flat)."""
    return torch.sum(torch.abs(pl - pr), dim=(1, 2),
                     dtype=torch.float64).to(torch.float32)


def _parabola(sads: torch.Tensor, k: torch.Tensor, at: torch.Tensor):
    """Vertex offset in [-1, 1] of the parabola through the SADs at at - 1,
    at, at + 1 (at = k clipped to the interior), and whether k is interior."""
    km = torch.clamp(at, 1, 2 * SLIDE_L - 1)
    s_m = sads.gather(0, at[None])[0]
    s_l = sads.gather(0, (km - 1)[None])[0]
    s_r = sads.gather(0, (km + 1)[None])[0]
    denom = torch.clamp(s_l + s_r - 2.0 * s_m, min=1e-6)
    frac = torch.clamp(0.5 * (s_l - s_r) / denom, -1.0, 1.0)
    interior = (k >= 1) & (k <= 2 * SLIDE_L - 1)
    return frac, interior


def stereo_match(xy_l, level_l, desc_l, valid_l, xy_r, level_r, desc_r,
                 valid_r, left_img0: torch.Tensor, right_img0: torch.Tensor,
                 bf: float, min_z: float, n_levels: int = 8,
                 scale: float = 1.2) -> StereoMatches:
    """All coordinates in level-0 pixels; bf = baseline * fx. The SAD
    windows are read from the level-0 images (the reference slides on each
    keypoint's own level; level 0 with scaled windows is equivalent up to
    resampling)."""
    sf = _level_scales(xy_l.device, n_levels, scale)
    max_d = bf / min_z

    # gates: row band, disparity range, level compatibility
    row_band = 2.0 * sf[level_l.long()]
    dv = torch.abs(xy_l[:, None, 1] - xy_r[None, :, 1])
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    mask = ((dv <= row_band[:, None]) & (disp >= 0.0) & (disp <= max_d)
            & (torch.abs(level_l[:, None] - level_r[None, :]) <= 1)
            & valid_l[:, None] & valid_r[None, :])

    dist = torch.where(mask, hamming.hamming_matrix(desc_l, desc_r),
                       torch.full_like(mask, BIG, dtype=torch.int32))
    best_r = torch.argmin(dist, dim=1)                    # first minimum
    best_d = dist.gather(1, best_r[:, None])[:, 0]
    coarse_ok = best_d < (TH_HIGH + TH_LOW) // 2

    # SAD sub-pixel refinement around the coarse match: the 11 slide
    # positions are column slices of one wide right window
    u_l, v_l = xy_l[:, 0], xy_l[:, 1]
    u_r0 = xy_r[best_r, 0]
    P = 2 * SAD_W + 1
    pl = _centred(bilinear_windows(left_img0, u_l, v_l, SAD_W, SAD_W))
    wide = bilinear_windows(right_img0, u_r0, v_l, SAD_W, SAD_W + SLIDE_L)
    sads = torch.stack([_sad(pl, _centred(wide[:, :, k:k + P]))
                        for k in range(2 * SLIDE_L + 1)])  # [2S+1, L]
    k = torch.argmin(sads, dim=0)
    s_m = sads.gather(0, k[None])[0]
    delta, interior = _parabola(sads, k, k)
    offsets = torch.arange(-SLIDE_L, SLIDE_L + 1, dtype=torch.float32,
                           device=xy_l.device)
    u_r = u_r0 + offsets[k] + torch.where(interior, delta,
                                          torch.zeros_like(delta))

    disparity = u_l - u_r
    ok = coarse_ok & (disparity > 1e-3) & (disparity <= max_d)
    # outlier cut at ~2x the median SAD (the reference uses 1.5 * 1.4 *
    # median); NaN median -> no cut, as in the JAX code
    med = nan_median(torch.where(ok, s_m, torch.full_like(s_m, np.nan)))
    ok = ok & torch.where(torch.isnan(med), ok, s_m <= 2.1 * med)
    # bf divided as a tensor (a Python number over a tensor is a multiply
    # by the reciprocal, one rounding off XLA's quotient)
    depth = torch.where(ok, torch.full_like(disparity, bf)
                        / torch.clamp(disparity, min=1e-6),
                        torch.zeros_like(disparity))
    return StereoMatches(u_right=u_r, disparity=disparity, depth=depth,
                         valid=ok)


def epipolar_sad_refine(img_l: torch.Tensor, img_r: torch.Tensor,
                        xy_l: torch.Tensor, xy_r: torch.Tensor,
                        e_dir: torch.Tensor, valid: torch.Tensor):
    """Sub-pixel refinement of right-image match positions along their
    epipolar tangent (the non-rectified analogue of stereo_match's SAD
    slide; the reference's KB8 stereo keeps integer keypoints).

    xy_l / xy_r [N, 2]: matched keypoint pixels. e_dir [N, 2]: unit
    epipolar tangent at the right keypoint. Returns (delta [N] signed px
    along e_dir, ok [N]): add delta * e_dir to xy_r where ok."""
    H, W = img_r.shape
    pl = _centred(bilinear_windows(img_l, xy_l[:, 0], xy_l[:, 1], SAD_W,
                                   SAD_W))
    sads = []
    for k in range(-SLIDE_L, SLIDE_L + 1):
        uk = xy_r[:, 0] + k * e_dir[:, 0]
        vk = xy_r[:, 1] + k * e_dir[:, 1]
        pr = _centred(bilinear_windows(img_r, uk, vk, SAD_W, SAD_W))
        sads.append(_sad(pl, pr))
    sads = torch.stack(sads)                              # [2S+1, N]
    k = torch.argmin(sads, dim=0)
    # the JAX code reads the centre SAD at the clipped index here
    frac, interior = _parabola(sads, k, torch.clamp(k, 1, 2 * SLIDE_L - 1))
    delta = ((k.to(torch.float32) - SLIDE_L)
             + torch.where(interior, frac, torch.zeros_like(frac)))
    # reject slides that wander: the refined position must stay in the
    # image and the SAD surface must have a real interior minimum
    u_new = xy_r[:, 0] + delta * e_dir[:, 0]
    v_new = xy_r[:, 1] + delta * e_dir[:, 1]
    ok = (valid & interior & (u_new >= SAD_W) & (u_new < W - SAD_W)
          & (v_new >= SAD_W) & (v_new < H - SAD_W))
    return torch.where(ok, delta, torch.zeros_like(delta)), ok
