"""Plain rectified stereo matching: for each left keypoint the right one in
its row band with the least Hamming distance, refined by an 11x11 SAD
slide and a parabola, then the outlier cut at about twice the median
SAD (ORB-SLAM3's Frame::ComputeStereoMatches).

A frozen copy of the port's ``ops/stereo.py::stereo_match`` at commit
d23e9c2, with its Hamming matrix and window gathers written out in plain
PyTorch (no kernel of the port).
"""
from __future__ import annotations

import numpy as np
import torch

TH_HIGH = 100
TH_LOW = 50
BIG = 1 << 20
SAD_W = 5
SLIDE_L = 5


def ideal_pixels(cam: dict, xy):
    """Keypoints [N, 2] moved to the ideal pinhole of the same intrinsics:
    radial-tangential distortion inverted by 8 fixed-point steps, the
    bearing normalised and put back on z = 1 (the port's
    ``cameras.undistort_points``, rounding for rounding)."""
    k1, k2, p1, p2 = (float(cam.get(k, 0.0)) for k in ("k1", "k2", "p1", "p2"))
    xd = torch.stack([(xy[:, 0] - cam["cx"]) / cam["fx"],
                      (xy[:, 1] - cam["cy"]) / cam["fy"]], -1)
    xn = xd
    for _ in range(8):
        x, y = xn[:, 0], xn[:, 1]
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * 0.0))
        dx = 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        xn = (xd - torch.stack([dx, dy], -1)) / radial[:, None]
    b = torch.cat([xn, torch.ones_like(xn[:, :1])], -1)
    b = b / torch.linalg.norm(b, dim=-1, keepdim=True)
    z = b[:, 2]
    z = torch.where(torch.abs(z) < 1e-6, torch.full_like(z, 1e-6), z)
    r = b / z[:, None]
    return torch.stack([cam["fx"] * r[:, 0] + cam["cx"],
                        cam["fy"] * r[:, 1] + cam["cy"]], -1)


def hamming_matrix(da, db):
    """[Q, 8] x [K, 8] int32 words -> [Q, K] int32 distances."""
    x = (da[:, None, :] ^ db[None, :, :]).to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    x = (x * 0x01010101 & 0xFFFFFFFF) >> 24
    return x.sum(-1).to(torch.int32)


def windows(img, uc, vc, half_h: int, half_w: int):
    """[N, 2 half_h + 1, 2 half_w + 1] bilinear windows centred at (uc,
    vc), read from one integer-corner window clipped inside the image."""
    P, w = 2 * half_h + 1, 2 * half_w + 1
    H, W = img.shape
    y0 = torch.clamp(torch.floor(vc).to(torch.int64) - half_h, 0, H - (P + 1))
    x0 = torch.clamp(torch.floor(uc).to(torch.int64) - half_w, 0, W - (w + 1))
    fy = torch.clamp(vc - half_h - y0, 0.0, 1.0)[:, None, None]
    fx = torch.clamp(uc - half_w - x0, 0.0, 1.0)[:, None, None]
    rows = y0[:, None, None] + torch.arange(P + 1, device=img.device)[None, :, None]
    cols = x0[:, None, None] + torch.arange(w + 1, device=img.device)[None, None, :]
    Wp = img[rows, cols]
    return ((1 - fy) * (1 - fx) * Wp[:, :P, :w] + (1 - fy) * fx * Wp[:, :P, 1:]
            + fy * (1 - fx) * Wp[:, 1:, :w] + fy * fx * Wp[:, 1:, 1:])


def _centred(p):
    return p - p[:, SAD_W:SAD_W + 1, SAD_W:SAD_W + 1]


def _sad(a, b):
    return torch.sum(torch.abs(a - b), dim=(1, 2),
                     dtype=torch.float64).to(torch.float32)


def stereo_match(left: dict, right: dict, img_l, img_r, bf: float,
                 min_z: float, n_levels: int = 8, scale: float = 1.2):
    """left / right: ``orb.extract`` results (left["xy"] on the ideal
    pinhole, ``ideal_pixels``); returns (depth [N], valid [N]) of the left
    keypoints, depth 0 where no match."""
    xy_l, level_l, desc_l, valid_l = (left[k] for k in ("xy", "level", "desc", "valid"))
    xy_r, level_r, desc_r, valid_r = (right[k] for k in ("xy", "level", "desc", "valid"))
    dev = xy_l.device
    sf = torch.from_numpy((scale ** np.arange(n_levels)).astype(np.float32)).to(dev)
    max_d = bf / min_z
    row_band = 2.0 * sf[level_l.long()]
    dv = torch.abs(xy_l[:, None, 1] - xy_r[None, :, 1])
    disp = xy_l[:, None, 0] - xy_r[None, :, 0]
    mask = ((dv <= row_band[:, None]) & (disp >= 0.0) & (disp <= max_d)
            & (torch.abs(level_l[:, None] - level_r[None, :]) <= 1)
            & valid_l[:, None] & valid_r[None, :])
    dist = torch.where(mask, hamming_matrix(desc_l, desc_r),
                       torch.full_like(mask, BIG, dtype=torch.int32))
    best_r = torch.argmin(dist, dim=1)
    best_d = dist.gather(1, best_r[:, None])[:, 0]
    coarse_ok = best_d < (TH_HIGH + TH_LOW) // 2
    u_l, v_l = xy_l[:, 0], xy_l[:, 1]
    u_r0 = xy_r[best_r, 0]
    P = 2 * SAD_W + 1
    pl = _centred(windows(img_l, u_l, v_l, SAD_W, SAD_W))
    wide = windows(img_r, u_r0, v_l, SAD_W, SAD_W + SLIDE_L)
    sads = torch.stack([_sad(pl, _centred(wide[:, :, k:k + P]))
                        for k in range(2 * SLIDE_L + 1)])
    k = torch.argmin(sads, dim=0)
    s_m = sads.gather(0, k[None])[0]
    km = torch.clamp(k, 1, 2 * SLIDE_L - 1)
    s_l = sads.gather(0, (km - 1)[None])[0]
    s_r = sads.gather(0, (km + 1)[None])[0]
    denom = torch.clamp(s_l + s_r - 2.0 * s_m, min=1e-6)
    delta = torch.clamp(0.5 * (s_l - s_r) / denom, -1.0, 1.0)
    interior = (k >= 1) & (k <= 2 * SLIDE_L - 1)
    offsets = torch.arange(-SLIDE_L, SLIDE_L + 1, dtype=torch.float32, device=dev)
    u_r = u_r0 + offsets[k] + torch.where(interior, delta, torch.zeros_like(delta))
    disparity = u_l - u_r
    ok = coarse_ok & (disparity > 1e-3) & (disparity <= max_d)
    # the cut at 2.1 x the median SAD applies only where every keypoint
    # matched (a median over a NaN is NaN, and then no cut)
    sm = torch.where(ok, s_m, torch.full_like(s_m, float("nan")))
    srt = torch.sort(sm).values
    n = sm.shape[0]
    med = (srt[(n - 1) // 2] + srt[n // 2]) * 0.5
    if not bool(torch.isnan(sm).any()):
        ok = ok & (s_m <= 2.1 * med)
    depth = torch.where(ok, torch.full_like(disparity, bf)
                        / torch.clamp(disparity, min=1e-6),
                        torch.zeros_like(disparity))
    return depth, ok
