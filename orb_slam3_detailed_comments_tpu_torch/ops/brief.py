"""Keypoint orientation (intensity centroid) + rotated-BRIEF descriptors.

Counterpart of ``ops/brief.py`` of the JAX package (reference: IC_Angle and
computeOrbDescriptor, src/ORBextractor.cc:91,150). The 256 sampling pairs
are drawn from the same seeded Gaussian as the JAX package, so the pattern
is the same bit for bit; orientation is discretised into 30 bins of
pre-rotated patterns (Rublee et al. 2011, sec. 4.2).

Descriptors are [N, 8] int32 tensors carrying the 256 bits (torch's
uint32 lacks most ops); bit j of word w is pattern pair 32 * w + j.
"""
from __future__ import annotations

import functools
import math

import numpy as np
import torch

from . import patches as patches_mod

HALF_PATCH = 15      # orientation patch radius (reference ORBextractor.cc:76)
PATTERN_RADIUS = 13  # BRIEF sample clip radius
N_BITS = 256
N_ANGLE_BINS = 30
PATCH_R = 18         # ceil(13 * sqrt(2)): rotated box corner stays inside
PATCH_W = 2 * PATCH_R + 1
RAW_R = PATCH_R + 3


def _make_pattern(seed: int = 31) -> np.ndarray:
    """[256, 4] float32: (x1, y1, x2, y2) sample offsets."""
    rng = np.random.default_rng(seed)
    sigma = (2 * PATTERN_RADIUS + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(N_BITS, 4)).astype(np.float32)
    return np.clip(pts, -PATTERN_RADIUS, PATTERN_RADIUS)


PATTERN = _make_pattern()

# circular-mask moment weights of the orientation patch
_ys, _xs = np.mgrid[-HALF_PATCH:HALF_PATCH + 1, -HALF_PATCH:HALF_PATCH + 1]
_CIRC_MASK = (_ys * _ys + _xs * _xs <= HALF_PATCH * HALF_PATCH).astype(np.float32)
_WX = (_xs * _CIRC_MASK).astype(np.float32)
_WY = (_ys * _CIRC_MASK).astype(np.float32)


def _bin_pair_index() -> tuple:
    """(idx1, idx2) [B, 256] int64: flat patch offsets of the two samples of
    each pair, rotated by each bin's centre angle with nearest-pixel
    rounding."""
    idx = np.zeros((2, N_ANGLE_BINS, N_BITS), np.int64)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * (b + 0.5) / N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        for n, (px, py) in enumerate(((PATTERN[:, 0], PATTERN[:, 1]),
                                      (PATTERN[:, 2], PATTERN[:, 3]))):
            rx = np.round(px * c - py * s).astype(np.int64)
            ry = np.round(px * s + py * c).astype(np.int64)
            idx[n, b] = (ry + PATCH_R) * PATCH_W + (rx + PATCH_R)
    return idx[0], idx[1]


_IDX1, _IDX2 = _bin_pair_index()


def _make_bin_patterns() -> np.ndarray:
    """[B, PATCH_W*PATCH_W, 256] float32 signed sample matrices: -1 at
    sample 1 and +1 at sample 2 of each pair, so patch @ pattern = v2 - v1.
    ``describe_patches`` takes the same difference by gathering the two
    samples (``_bin_pair_index``), which is exact for any intensities."""
    pats = np.zeros((N_ANGLE_BINS, PATCH_W * PATCH_W, N_BITS), np.float32)
    cols = np.arange(N_BITS)
    for b in range(N_ANGLE_BINS):
        np.add.at(pats[b], (_IDX1[b], cols), -1.0)
        np.add.at(pats[b], (_IDX2[b], cols), 1.0)
    return pats


@functools.lru_cache(maxsize=8)
def _tables_on(device: torch.device):
    """(idx1, idx2, wx, wy) uploaded once per device (a per-frame upload
    from host memory would be a host sync)."""
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device)
                 for a in (_IDX1, _IDX2, _WX.reshape(-1), _WY.reshape(-1)))


def floor_mod(x: torch.Tensor, m: float) -> torch.Tensor:
    """x mod m for m > 0, written as jnp.mod computes it (fmod, then + m
    where the result is negative)."""
    r = torch.fmod(x, m)
    return torch.where(r < 0, r + m, r)


def angle_bin(angle: torch.Tensor) -> torch.Tensor:
    frac = floor_mod(angle, 2.0 * math.pi) / (2.0 * math.pi)
    return torch.clamp((frac * N_ANGLE_BINS).to(torch.int32),
                       0, N_ANGLE_BINS - 1)


def _pack_bool(b: torch.Tensor) -> torch.Tensor:
    """[N, 256] bool -> [N, 8] int32 words (bit j of word w = b[32 w + j])."""
    bits = b.reshape(-1, 8, 32).to(torch.int64)
    shifts = torch.arange(32, device=b.device, dtype=torch.int64)
    words = torch.sum(bits << shifts, dim=-1)                # 0 .. 2^32 - 1
    words = words - (words >= 2 ** 31).to(torch.int64) * 2 ** 32
    return words.to(torch.int32)


def describe_patches(patches: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotated-BRIEF from blurred patches [N, PATCH_W * PATCH_W] (integer
    intensities) and angles [N] -> [N, 8] int32 packed bits.

    bit = v1 < v2 for the pair rotated by the keypoint's angle bin. The JAX
    version takes v2 - v1 as one matmul per bin against
    ``_make_bin_patterns``; gathering the two samples gives the same exact
    integer difference in two gathers."""
    bins = angle_bin(angle).long()
    idx1, idx2, _, _ = _tables_on(patches.device)
    i1 = idx1[bins]                                            # [N, 256]
    i2 = idx2[bins]
    diff = torch.gather(patches, 1, i2) - torch.gather(patches, 1, i1)
    return _pack_bool(diff > 0)


def ic_angle_patches(patches: torch.Tensor) -> torch.Tensor:
    """Intensity-centroid angle from raw patches [N, 31 * 31]: atan2 of the
    circular-mask moments m01, m10 (two matrix-vector products)."""
    _, _, wx, wy = _tables_on(patches.device)
    return torch.atan2(patches @ wy, patches @ wx)


def angle_from_maps(m10: torch.Tensor, m01: torch.Tensor,
                    yx: torch.Tensor) -> torch.Tensor:
    """Per-keypoint angles gathered from dense moment maps; yx [N, 2] int32
    (row, col), clamped into the map."""
    h, w = m10.shape
    flat = (torch.clamp(yx[:, 0], 0, h - 1).long() * w
            + torch.clamp(yx[:, 1], 0, w - 1).long())
    return torch.atan2(m01.reshape(-1)[flat], m10.reshape(-1)[flat])


def patch_corners(yx: torch.Tensor, radius: int, content_hw,
                  row_off=0) -> torch.Tensor:
    """[N, 2] int32 top-left corners of the (2r+1)^2 patches centred on yx
    (row, col), slid inward at the content border so that a patch always
    covers real content; ``row_off`` shifts the rows (atlas coordinates).
    content_hw and row_off are ints, or [N] tensors that give each
    keypoint its own level's."""
    # an int extent becomes a CPU scalar tensor, which a CUDA op takes as
    # a scalar (no upload)
    ch, cw = map(torch.as_tensor, content_hw)
    w = 2 * radius + 1
    slide = lambda start, extent: torch.minimum(start.clamp_min(0),
                                                (extent - w).clamp_min(0))
    return torch.stack([slide(yx[:, 0] - radius, ch) + row_off,
                        slide(yx[:, 1] - radius, cw)], dim=-1).to(torch.int32)


def extract_patches(img: torch.Tensor, yx: torch.Tensor, content_hw,
                    radius: int = PATCH_R) -> torch.Tensor:
    """[N, (2r+1)^2] patches of one level image centred on yx (row, col).
    The gather is ``patches.gather_patches`` with the level image as its
    atlas (same corner rule as the JAX version's ``dynamic_slice``)."""
    rc = patch_corners(yx, radius, content_hw)
    return patches_mod.gather_patches(img.contiguous(), rc,
                                      2 * radius + 1).reshape(yx.shape[0], -1)
