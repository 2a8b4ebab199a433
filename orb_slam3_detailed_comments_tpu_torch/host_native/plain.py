"""Numpy twins of the host library's entries, with the same signatures.

The tests hold each C++ entry to its twin; no other code calls them. They
follow the C++ rule for rule: observations are walked keyframe-major, then
feature, over live keyframes only; the representative descriptor is the
observation with the least upper-middle Hamming distance to the others
(``sorted(d)[n // 2]``), the first one in that order winning a tie.
"""
from __future__ import annotations

import numpy as np


def _popcount_words(x: np.ndarray) -> np.ndarray:
    """Set bits of uint32 words, summed over the last axis."""
    return np.unpackbits(x.view(np.uint8), axis=-1).sum(-1)


def update_point_stats(kf_valid, kf_feat_point, kf_feat_desc, kf_feat_level,
                       kf_R, kf_t, pt_xyz, pt_ref_kf, pids, scale_factors,
                       pt_desc, pt_normal, pt_min_dist, pt_max_dist) -> int:
    P = pt_xyz.shape[0]
    sf = np.asarray(scale_factors, np.float32)
    L = len(sf)
    pids = np.asarray(pids, np.int64)
    want = np.zeros(P, bool)
    want[pids[(pids >= 0) & (pids < P)]] = True
    fp = kf_feat_point
    hit = (fp >= 0) & (fp < P) & kf_valid[:, None]
    hit[hit] = want[fp[hit]]
    kk, ff = np.nonzero(hit)                   # keyframe-major, then feature
    obs: dict = {}
    for k, f in zip(kk, ff):
        obs.setdefault(int(fp[k, f]), []).append((int(k), int(f)))
    desc_u = kf_feat_desc.view(np.uint32)
    out_desc = pt_desc.view(np.uint32)
    updated = 0
    for p in np.unique(pids[(pids >= 0) & (pids < P)]):
        o = obs.get(int(p))
        if not o:
            continue
        updated += 1
        ks = np.array([k for k, _ in o])
        fs = np.array([f for _, f in o])
        descs = desc_u[ks, fs]                                  # [n, 8]
        n = len(o)
        if n == 1:
            out_desc[p] = descs[0]
        else:
            d = _popcount_words(descs[:, None, :] ^ descs[None, :, :])
            med = np.sort(d, axis=1)[:, n // 2]
            out_desc[p] = descs[int(np.argmin(med))]
        # viewing normal: the mean of the unit vectors centre -> point
        R, t = kf_R[ks], kf_t[ks]
        centers = -np.einsum("kij,ki->kj", R, t).astype(np.float32)
        v = (pt_xyz[p] - centers).astype(np.float32)
        nrm = np.sqrt((v * v).sum(-1))
        ok = nrm > 1e-9
        acc = (v[ok] / nrm[ok, None]).astype(np.float64).sum(0)
        nn = float(np.sqrt((acc * acc).sum()))
        if nn > 1e-9:
            acc = acc / nn
        pt_normal[p] = acc.astype(np.float32)
        # scale range from the reference keyframe's observation
        where = np.nonzero(ks == pt_ref_kf[p])[0]
        i = int(where[0]) if len(where) else 0
        if not len(where):
            pt_ref_kf[p] = ks[0]
        lvl = int(np.clip(kf_feat_level[ks[i], fs[i]], 0, L - 1))
        mx = np.float32(nrm[i]) * sf[lvl]
        pt_max_dist[p] = mx
        pt_min_dist[p] = mx / sf[L - 1]
    return updated


def replace_point(kf_valid, kf_feat_point, old_id: int, new_id: int) -> int:
    relinked = 0
    for k in np.nonzero(kf_valid)[0]:
        row = kf_feat_point[k]
        at = np.nonzero(row == old_id)[0]
        if not len(at):
            continue
        if (row == new_id).any():
            row[at[-1]] = -1
        else:
            row[at[-1]] = new_id
            relinked += 1
    return relinked


def build_incidence_bits(kf_valid, kf_feat_point, P: int) -> np.ndarray:
    K, _ = kf_feat_point.shape
    bits = np.zeros((K, (P + 63) // 64), np.uint64)
    fp = kf_feat_point
    k, f = np.nonzero((fp >= 0) & (fp < P) & kf_valid[:, None])
    p = fp[k, f].astype(np.int64)
    np.bitwise_or.at(bits, (k, p >> 6),
                     np.uint64(1) << (p & 63).astype(np.uint64))
    return bits


def covis_counts(bits, kf_valid, ks) -> np.ndarray:
    ks = np.asarray(ks, np.int64)
    q = bits[ks][:, None, :] & bits[None, :, :]               # [M, K, Pw]
    out = _popcount_words(q.view(np.uint32)).astype(np.int32)
    out[:, ~kf_valid] = 0
    return out


def observers_of(bits, kf_valid, pt_ids, P: int) -> np.ndarray:
    pt_bits = np.zeros(bits.shape[1], np.uint64)
    ids = np.asarray(pt_ids, np.int64)
    np.bitwise_or.at(pt_bits, ids >> 6,
                     np.uint64(1) << (ids & 63).astype(np.uint64))
    return ((bits & pt_bits[None, :]) != 0).any(axis=1) & kf_valid


def observation_counts(kf_valid, kf_feat_point, P: int) -> np.ndarray:
    flat = kf_feat_point[kf_valid].ravel()
    flat = flat[(flat >= 0) & (flat < P)]
    return np.bincount(flat, minlength=P).astype(np.int32)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def png_unfilter(raw: np.ndarray, height: int, stride: int,
                 bpp: int) -> np.ndarray:
    """A row at a time: Up is one vector add; Sub, Average and Paeth run
    one pixel column (bpp bytes) at a time, left to right."""
    raw = np.asarray(raw, np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError(f"the image data holds {raw.size} bytes, not "
                         f"{height} rows of {stride + 1}")
    bpp = max(1, int(bpp))
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.int32)
    for y in range(height):
        ftype, src = int(rows[y, 0]), rows[y, 1:].astype(np.int32)
        cur = np.zeros(stride, np.int32)
        if ftype == 0:
            cur = src
        elif ftype == 2:
            cur = (src + prior) & 255
        elif ftype in (1, 3, 4):
            for x0 in range(0, stride, bpp):
                sl = slice(x0, min(x0 + bpp, stride))
                w = sl.stop - sl.start
                a = cur[x0 - bpp:x0 - bpp + w] if x0 >= bpp else 0
                b = prior[sl]
                if ftype == 1:
                    pred = a
                elif ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = prior[x0 - bpp:x0 - bpp + w] if x0 >= bpp else 0
                    pred = _paeth(np.broadcast_to(a, (w,)), b,
                                  np.broadcast_to(c, (w,)))
                cur[sl] = (src[sl] + pred) & 255
        else:
            raise ValueError(f"row {y} has filter type {ftype}, not 0-4")
        out[y] = cur
        prior = cur
    return out
