"""Image pyramid + Gaussian blur for the ORB frontend.

Counterpart of ``ops/pyramid.py`` of the JAX package (reference:
ORBextractor::ComputePyramid, src/ORBextractor.cc:1687). Level shapes are
derived from the base resolution; all levels are float32 in [0, 255].
``build_pyramid`` takes one image [H, W] or a batch [B, H, W]: every step
is an elementwise product or a gather, so each frame of a batch gets its
own pyramid bit for bit.
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
def _taps_on(n_out: int, n_in: int, device: torch.device):
    """(lo, hi, w_lo, w_hi): the two taps of each row of ``_resize_matrix``
    and their weights (w_hi = 0 where both taps are one pixel: the row
    then holds 1.0 there), uploaded once per device."""
    m = _resize_matrix(n_out, n_in)
    p = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0,
                n_in - 1)
    lo = np.floor(p).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    rows = np.arange(n_out)
    w_lo = m[rows, lo]
    w_hi = np.where(hi != lo, m[rows, hi], 0.0).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (lo, hi, w_lo, w_hi))


def _two_tap(a: torch.Tensor, b: torch.Tensor, w_lo: torch.Tensor,
             w_hi: torch.Tensor) -> torch.Tensor:
    """w_lo * a + w_hi * b in one fixed rounding order, that of torch's CPU
    BLAS for the interpolation products: the first product rounded to
    float32, the second added to it with one rounding, as a fused
    multiply-add does. The fused step runs as separate float64 operations
    (the float32 product is exact in float64), so the card and the CPU
    round it alike. XLA-CPU's dots (the JAX package's matrix form) pick
    this order or another by their shape; ``resize_bilinear`` says
    which."""
    first = torch.mul(a, w_lo).double()
    second = torch.mul(b.double(), w_hi.double())
    return torch.add(first, second).to(torch.float32)


def resize_bilinear(img: torch.Tensor, nh: int, nw: int) -> torch.Tensor:
    """Bilinear resize with a fixed order of operations: rows first, then
    columns, each output value the two taps of ``_resize_matrix``'s row
    (``_two_tap``). It equals torch's matrix form ``(rh @ img) @ rw.T`` on
    the CPU to the bit but where the float64 sum rounds onto a float32
    tie; on the card the matrix form's library rounds otherwise. The JAX
    package's matrix form on XLA-CPU rounds each pass one of three ways,
    chosen by the dot's shape: at 752x480, 480x752 -> 400x627 takes two
    separately rounded products vertically (11.8 % of the outputs part
    from the fused form here) and the fused form horizontally but on
    0.002 %; 400x627 -> 333x522 the fused form vertically and two
    roundings horizontally; at 376x240, 240x376 -> 200x313 the fused form
    in both passes. So JAX's resized levels part from these by 1-3
    float32 ulps (<= 4.6e-5) at some pixels of every level past the base
    (``tests/test_torch_extractor.py::
    test_resize_parts_from_xla_cpu_only_by_the_two_tap_rounding``)."""
    ch, cw = img.shape[-2:]
    lo, hi, wl, wh = _taps_on(nh, ch, img.device)
    rows = _two_tap(img[..., lo, :], img[..., hi, :], wl[:, None],
                    wh[:, None])
    lo, hi, wl, wh = _taps_on(nw, cw, img.device)
    return _two_tap(rows[..., lo], rows[..., hi], wl[None, :], wh[None, :])


def _pad_edge(img: torch.Tensor, ph_before: int, ph_after: int,
              pw_before: int, pw_after: int) -> torch.Tensor:
    """Edge-replicating pad of the last two axes (numpy's mode="edge")."""
    h, w = img.shape[-2:]
    rows = torch.clamp(torch.arange(-ph_before, h + ph_after,
                                    device=img.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-pw_before, w + pw_after,
                                    device=img.device), 0, w - 1)
    return img[..., rows, :][..., cols]


def build_pyramid(img: torch.Tensor, n_levels: int = DEFAULT_N_LEVELS,
                  scale: float = DEFAULT_SCALE) -> list:
    """img [H, W] float32 -> list of [h_l, w_l] float32 levels, each resized
    from the previous (cascaded, like the reference), padded to the level
    shape by edge replication; img [B, H, W] -> levels [B, h_l, w_l]."""
    h, w = img.shape[-2:]
    shapes = level_shapes(h, w, n_levels, scale)
    levels = []
    cur = img
    ch, cw = h, w
    for lv in range(n_levels):
        if lv > 0:
            nh = int(round(h / scale ** lv))
            nw = int(round(w / scale ** lv))
            cur = resize_bilinear(cur, nh, nw)
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
