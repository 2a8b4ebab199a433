"""Image pyramid + Gaussian blur for the ORB frontend.

Counterpart of ``ops/pyramid.py`` of the JAX package (reference:
ORBextractor::ComputePyramid, src/ORBextractor.cc:1687). Level shapes are
derived from the base resolution; all levels are float32 in [0, 255].
"""
from __future__ import annotations

import functools

import numpy as np
import torch

DEFAULT_N_LEVELS = 8
DEFAULT_SCALE = 1.2


def level_shapes(h: int, w: int, n_levels: int = DEFAULT_N_LEVELS,
                 scale: float = DEFAULT_SCALE, multiple: int = 8):
    """Per-level (h, w), rounded up to `multiple`."""
    shapes = []
    for lv in range(n_levels):
        s = scale ** lv
        lh = int(round(h / s))
        lw = int(round(w / s))
        lh = ((lh + multiple - 1) // multiple) * multiple
        lw = ((lw + multiple - 1) // multiple) * multiple
        shapes.append((lh, lw))
    return shapes


def scale_factors(n_levels: int = DEFAULT_N_LEVELS,
                  scale: float = DEFAULT_SCALE):
    return np.array([scale ** lv for lv in range(n_levels)], dtype=np.float32)


def _resize_matrix(n_out: int, n_in: int) -> np.ndarray:
    """[n_out, n_in] bilinear interpolation matrix (half-pixel convention)."""
    m = np.zeros((n_out, n_in), np.float32)
    p = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
    p = np.clip(p, 0.0, n_in - 1)
    lo = np.floor(p).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = (p - lo).astype(np.float32)
    m[np.arange(n_out), lo] += 1.0 - f
    m[np.arange(n_out), hi] += f
    return m


@functools.lru_cache(maxsize=64)
def _resize_matrix_on(n_out: int, n_in: int, device: torch.device):
    """``_resize_matrix`` uploaded once per device: a per-frame upload from
    host memory would be a host sync."""
    return torch.from_numpy(_resize_matrix(n_out, n_in)).to(device)


def resize_bilinear_mm(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """Bilinear resize as two interpolation-matrix products (float32; keep
    TF32 off on the card, see chip_smoke.py)."""
    ch, cw = img.shape
    rh = _resize_matrix_on(nh, ch, img.device)
    rw = _resize_matrix_on(nw, cw, img.device)
    return (rh @ img) @ rw.T


def _pad_edge(img: torch.Tensor, ph_before: int, ph_after: int,
              pw_before: int, pw_after: int) -> torch.Tensor:
    """Edge-replicating pad of a 2-D tensor (numpy's mode="edge")."""
    h, w = img.shape
    rows = torch.clamp(torch.arange(-ph_before, h + ph_after,
                                    device=img.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-pw_before, w + pw_after,
                                    device=img.device), 0, w - 1)
    return img[rows][:, cols]


def build_pyramid(img: torch.Tensor, n_levels: int = DEFAULT_N_LEVELS,
                  scale: float = DEFAULT_SCALE) -> list:
    """img [H, W] float32 -> list of [h_l, w_l] float32 levels, each resized
    from the previous (cascaded, like the reference), padded to the level
    shape by edge replication."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    levels = []
    cur = img
    ch, cw = h, w
    for lv in range(n_levels):
        if lv > 0:
            nh = int(round(h / scale ** lv))
            nw = int(round(w / scale ** lv))
            cur = resize_bilinear_mm(cur, nh, nw)
            ch, cw = nh, nw
        levels.append(_pad_edge(cur, 0, shapes[lv][0] - ch,
                                0, shapes[lv][1] - cw))
    return levels


def _gauss_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def gaussian_blur(img: torch.Tensor, ksize: int = 7,
                  sigma: float = 2.0) -> torch.Tensor:
    """Separable Gaussian blur with edge replication, [H, W] -> [H, W].
    Shift-and-add in the JAX version's order, so the sums round alike."""
    k = _gauss_kernel1d(ksize, sigma)
    r = ksize // 2
    H, W = img.shape
    x = _pad_edge(img, r, r, r, r)
    out = torch.zeros((H, W + 2 * r), dtype=img.dtype, device=img.device)
    for i, wt in enumerate(k):
        out = out + float(wt) * x[i:i + H, :]
    out2 = torch.zeros((H, W), dtype=img.dtype, device=img.device)
    for i, wt in enumerate(k):
        out2 = out2 + float(wt) * out[:, i:i + W]
    return out2
