"""Plain ORB extraction: the front end that the benchmark holds the port's
extraction against.

A frozen copy of the plain PyTorch functions of the port at commit
d23e9c2 that define its fused front end (``ops/pyramid.py``'s two-tap
resize and edge padding, ``ops/frontend.py``'s ``_score_plain``,
``_blur_plain`` and ``_moments_plain``, ``ops/fast.py``'s and
``ops/topk.py``'s per-level selection, ``ops/brief.py``'s pattern,
corners and rotated BRIEF, ``ops/layout.py``'s budgets), one level at a
time, with no kernel, batching or table of the port. ``extract`` takes
an image [H, W] float32 in [0, 255] on any device.

``lower``, when given, rounds every map the front end computes (each
pyramid level, the blur and the moment maps) through that dtype: the
control of the comparison, the same front end in a lower precision.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, circularly ordered (dy, dx)
CIRCLE = np.array([(-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2),
                   (3, 1), (3, 0), (3, -1), (2, -2), (1, -3), (0, -3),
                   (-1, -3), (-2, -2), (-3, -1)], dtype=np.int32)
HALF_PATCH = 15          # orientation patch radius
PATTERN_RADIUS = 13
N_BITS = 256
N_ANGLE_BINS = 30
PATCH_R = 18
PATCH_W = 2 * PATCH_R + 1
U_MAX = np.floor(np.sqrt(np.maximum(
    HALF_PATCH * HALF_PATCH - np.arange(HALF_PATCH + 1) ** 2, 0)) + 1e-4
    ).astype(np.int32)


def _gauss_taps(ksize: int = 7, sigma: float = 2.0) -> list:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return [float(v) for v in (k / k.sum()).astype(np.float32)]


TAPS = _gauss_taps()


def _make_pattern(seed: int = 31) -> np.ndarray:
    rng = np.random.default_rng(seed)
    sigma = (2 * PATTERN_RADIUS + 1) / 5.0
    pts = rng.normal(0.0, sigma, size=(N_BITS, 4)).astype(np.float32)
    return np.clip(pts, -PATTERN_RADIUS, PATTERN_RADIUS)


def _bin_pairs() -> tuple:
    """(idx1, idx2) [bins, 256]: flat window offsets of each pair's two
    samples, rotated by each angle bin's centre, rounded to pixels."""
    pat = _make_pattern()
    idx = np.zeros((2, N_ANGLE_BINS, N_BITS), np.int64)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * (b + 0.5) / N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        for n, (px, py) in enumerate(((pat[:, 0], pat[:, 1]),
                                      (pat[:, 2], pat[:, 3]))):
            rx = np.round(px * c - py * s).astype(np.int64)
            ry = np.round(px * s + py * c).astype(np.int64)
            idx[n, b] = (ry + PATCH_R) * PATCH_W + (rx + PATCH_R)
    return idx[0], idx[1]


IDX1, IDX2 = _bin_pairs()


def level_shapes(h, w, n_levels, scale, multiple=8):
    out = []
    for lv in range(n_levels):
        lh, lw = int(round(h / scale ** lv)), int(round(w / scale ** lv))
        out.append((-(-lh // multiple) * multiple, -(-lw // multiple) * multiple))
    return out


def level_budgets(n_features: int, n_levels: int, scale: float) -> list:
    f = 1.0 / scale
    n0 = n_features * (1 - f) / (1 - f ** n_levels)
    out, acc = [], 0
    for lv in range(n_levels - 1):
        b = int(round(n0 * f ** lv))
        out.append(b)
        acc += b
    out.append(max(n_features - acc, 8))
    return out


def pad_edge(img, top, bottom, left, right):
    h, w = img.shape[-2:]
    rows = torch.clamp(torch.arange(-top, h + bottom, device=img.device), 0, h - 1)
    cols = torch.clamp(torch.arange(-left, w + right, device=img.device), 0, w - 1)
    return img[..., rows, :][..., cols]


def _taps(n_out: int, n_in: int, device):
    p = np.clip((np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5, 0.0, n_in - 1)
    lo = np.floor(p).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = (p - lo).astype(np.float32)
    m = np.zeros((n_out, n_in), np.float32)
    rows = np.arange(n_out)
    m[rows, lo] += 1.0 - f
    m[rows, hi] += f
    w_lo = m[rows, lo]
    w_hi = np.where(hi != lo, m[rows, hi], 0.0).astype(np.float32)
    return tuple(torch.from_numpy(a).to(device) for a in (lo, hi, w_lo, w_hi))


def _two_tap(a, b, w_lo, w_hi):
    """w_lo a + w_hi b: the first product rounded to float32, the second
    added with one rounding."""
    return torch.add(torch.mul(a, w_lo).double(),
                     torch.mul(b.double(), w_hi.double())).to(torch.float32)


def resize(img, nh: int, nw: int):
    ch, cw = img.shape[-2:]
    lo, hi, wl, wh = _taps(nh, ch, img.device)
    rows = _two_tap(img[..., lo, :], img[..., hi, :], wl[:, None], wh[:, None])
    lo, hi, wl, wh = _taps(nw, cw, img.device)
    return _two_tap(rows[..., lo], rows[..., hi], wl[None, :], wh[None, :])


def _round(x, lower):
    return x if lower is None else x.to(lower).to(torch.float32)


def pyramid(img, n_levels: int, scale: float, lower=None) -> list:
    """Cascaded levels padded by edge replication to the level shapes."""
    h, w = img.shape
    shapes = level_shapes(h, w, n_levels, scale)
    out, cur, ch, cw = [], _round(img, lower), h, w
    for lv in range(n_levels):
        if lv > 0:
            ch, cw = int(round(h / scale ** lv)), int(round(w / scale ** lv))
            cur = _round(resize(cur, ch, cw), lower)
        out.append(pad_edge(cur, 0, shapes[lv][0] - ch, 0, shapes[lv][1] - cw))
    return out


def _arc_max_min9(D):
    w2 = torch.minimum(D, D.roll(-1, 0))
    w4 = torch.minimum(w2, w2.roll(-2, 0))
    w8 = torch.minimum(w4, w4.roll(-4, 0))
    return torch.minimum(w8, D.roll(-8, 0)).amax(0)


def fast_nms(img):
    """FAST-9/16 score with edge replication, then 3x3 NMS (a pixel keeps
    its score if >= its eight neighbours)."""
    H, W = img.shape
    B = H + 2
    xp = pad_edge(img, 4, 4, 3, 3)
    center = xp[3:3 + B, 3:3 + W]
    D = torch.stack([xp[3 + int(dy):3 + int(dy) + B, 3 + int(dx):3 + int(dx) + W]
                     - center for dy, dx in CIRCLE])
    s = torch.maximum(_arc_max_min9(D), _arc_max_min9(-D))
    sp = pad_edge(s, 0, 0, 1, 1)
    mx = F.max_pool2d(sp[None, None], 3, stride=1)[0, 0]
    si = s[1:1 + H]
    return torch.where(si >= mx, si, torch.zeros_like(si))


def blur(img):
    """7-tap sigma-2 Gaussian, rows then columns (the column pass as fused
    multiply-adds), rounded half to even."""
    H, W = img.shape
    xp = pad_edge(img, 3, 3, 3, 3)
    h = TAPS[0] * xp[:, 0:W]
    for i in range(1, 7):
        h = h + TAPS[i] * xp[:, i:i + W]
    out = TAPS[0] * h[0:H]
    for i in range(1, 7):
        out = (TAPS[i] * h[i:i + H].double() + out.double()).float()
    return torch.round(out)


def moments(img):
    """Intensity-centroid moments (m10, m01) of the radius-15 circular
    patch around every pixel."""
    H, W = img.shape
    R = HALF_PATCH
    xp = pad_edge(img - img.mean(), R, R, R, R)
    rs = xp[:, R:R + W].clone()
    ts = torch.zeros_like(rs)
    by_width, done = {}, 0
    for w in sorted({int(x) for x in U_MAX}):
        for u in range(done + 1, w + 1):
            right, left = xp[:, R + u:R + u + W], xp[:, R - u:R - u + W]
            rs = rs + (right + left)
            ts = ts + float(u) * (right - left)
        done = w
        by_width[w] = (rs, ts)
    m10 = torch.zeros((H, W), dtype=img.dtype, device=img.device)
    m01 = torch.zeros_like(m10)
    for dv in range(-R, R + 1):
        rs, ts = by_width[int(U_MAX[abs(dv)])]
        m10 = m10 + ts[R + dv:R + dv + H]
        if dv != 0:
            m01 = m01 + float(dv) * rs[R + dv:R + dv + H]
    return m10, m01


def select(score, content, n_target: int, cell: int, k: int, min_th: float,
           margin: int):
    """Per-cell top-k inside the border, then the n_target best in
    cell-rank-major order (rank, then higher score, then candidate order):
    (yx [n, 2] int64, score [n], valid [n])."""
    h, w = score.shape
    ch, cw = content
    ys = torch.arange(h, device=score.device)[:, None]
    xs = torch.arange(w, device=score.device)[None, :]
    inside = (ys >= margin) & (ys < ch - margin) & (xs >= margin) & (xs < cw - margin)
    s = F.pad(torch.where(inside, score, torch.zeros_like(score)),
              (0, (-w) % cell, 0, (-h) % cell), value=0.0)
    Hc, Wc = s.shape
    ncx = Wc // cell
    cells = s.reshape(Hc // cell, cell, ncx, cell).permute(0, 2, 1, 3).reshape(
        -1, cell * cell)
    top_s, top_i = torch.sort(cells, dim=1, descending=True, stable=True)
    top_s, top_i = top_s[:, :k], top_i[:, :k]
    cid = torch.arange(cells.shape[0], device=score.device)
    iy = (cid // ncx)[:, None] * cell + top_i // cell
    ix = (cid % ncx)[:, None] * cell + top_i % cell
    cs, cy, cx = top_s.reshape(-1), iy.reshape(-1), ix.reshape(-1)
    rank = torch.arange(k, device=score.device).expand(top_s.shape).reshape(-1)
    ok = cs >= min_th
    key = torch.where(ok, rank.to(torch.float32) * 1024.0 - cs,
                      torch.full_like(cs, float("inf")))
    if key.shape[0] < n_target:
        pad = n_target - key.shape[0]
        key = F.pad(key, (0, pad), value=float("inf"))
        ok, cs = F.pad(ok, (0, pad), value=False), F.pad(cs, (0, pad))
        cy, cx = F.pad(cy, (0, pad)), F.pad(cx, (0, pad))
    order = torch.sort(-key, descending=True, stable=True)[1][:n_target]
    return torch.stack([cy[order], cx[order]], -1), cs[order], ok[order]


def describe(blur_map, yx, content, angle):
    """Rotated BRIEF of each keypoint from its 37x37 blurred window (slid
    inside the content), the pattern rotated by the angle's bin:
    [n, 8] int32 words, bit j of word w = pair 32 w + j."""
    ch, cw = content
    H, W = blur_map.shape
    r0 = torch.clamp(torch.minimum((yx[:, 0] - PATCH_R).clamp_min(0),
                                   torch.tensor(max(ch - PATCH_W, 0))), 0, H - PATCH_W)
    c0 = torch.clamp(torch.minimum((yx[:, 1] - PATCH_R).clamp_min(0),
                                   torch.tensor(max(cw - PATCH_W, 0))), 0, W - PATCH_W)
    ar = torch.arange(PATCH_W, device=yx.device)
    win = blur_map[(r0[:, None, None] + ar[None, :, None]),
                   (c0[:, None, None] + ar[None, None, :])].reshape(yx.shape[0], -1)
    r = torch.fmod(angle, 2.0 * math.pi)
    frac = torch.where(r < 0, r + 2.0 * math.pi, r) / (2.0 * math.pi)
    bins = torch.clamp((frac * N_ANGLE_BINS).to(torch.int32), 0,
                       N_ANGLE_BINS - 1).long()
    i1 = torch.from_numpy(IDX1).to(yx.device)[bins]
    i2 = torch.from_numpy(IDX2).to(yx.device)[bins]
    bits = (torch.gather(win, 1, i2) - torch.gather(win, 1, i1)) > 0
    words = torch.sum(bits.reshape(-1, 8, 32).to(torch.int64)
                      << torch.arange(32, device=yx.device), dim=-1)
    return (words - (words >= 2 ** 31).to(torch.int64) * 2 ** 32).to(torch.int32)


def extract(img, n_features: int, n_levels: int = 8, scale: float = 1.2,
            min_th: float = 7.0, cell: int = 32, k: int = 8, margin: int = 16,
            lower=None) -> dict:
    """ORB features of img [H, W] float32: level-major, each level its
    budget of slots; xy [N, 2] in level-0 pixels (column, row), level [N],
    angle [N], desc [N, 8] int32, valid [N]."""
    h, w = img.shape
    levels = pyramid(img, n_levels, scale, lower)
    budgets = level_budgets(n_features, n_levels, scale)
    sf = np.array([scale ** lv for lv in range(n_levels)], np.float32)
    out = {k_: [] for k_ in ("xy", "level", "angle", "desc", "valid")}
    for lv, (lev, n) in enumerate(zip(levels, budgets)):
        content = (int(round(h / scale ** lv)), int(round(w / scale ** lv)))
        score = fast_nms(lev)
        bl = _round(blur(lev), lower)
        m10, m01 = (_round(m, lower) for m in moments(lev))
        yx, _, ok = select(score, content, n, cell, k, min_th, margin)
        yy = torch.clamp(yx[:, 0], 0, lev.shape[0] - 1)
        xx = torch.clamp(yx[:, 1], 0, lev.shape[1] - 1)
        ang = torch.atan2(m01[yy, xx], m10[yy, xx])
        out["desc"].append(describe(bl, yx, content, ang))
        out["angle"].append(ang)
        yxf = yx.to(torch.float32)
        s = torch.tensor(sf[lv], device=img.device)
        out["xy"].append(torch.stack([yxf[:, 1] * s, yxf[:, 0] * s], -1))
        out["level"].append(torch.full((n,), lv, dtype=torch.int32,
                                       device=img.device))
        out["valid"].append(ok)
    return {k_: torch.cat(v) for k_, v in out.items()}
