"""Absolute trajectory error: Horn alignment (+ optional scale) and RMS ATE.

Counterpart of ``utils/evaluate_ate.py`` of the JAX package (host numpy on
both sides). Reimplements the evaluation used by the reference's eval scripts
(reference: evaluation/evaluate_ate_scale.py + evaluation/associate.py):
timestamp association, similarity alignment of estimate to ground truth,
RMSE of aligned translational differences.
"""
from __future__ import annotations

import numpy as np


def associate(ts_a: np.ndarray, ts_b: np.ndarray, max_dt: float = 0.02):
    """Greedy nearest-timestamp association. Returns index pairs [M, 2]."""
    pairs = []
    used = set()
    for i, t in enumerate(ts_a):
        k = np.searchsorted(ts_b, t)
        best, bestd = -1, max_dt
        for c in (k - 1, k, k + 1):
            if 0 <= c < len(ts_b) and c not in used:
                d = abs(ts_b[c] - t)
                if d <= bestd:
                    best, bestd = c, d
        if best >= 0:
            pairs.append((i, best))
            used.add(best)
    return np.asarray(pairs, np.int64).reshape(-1, 2)


def align_horn(model: np.ndarray, data: np.ndarray, with_scale: bool = True):
    """Find s, R, t minimizing || data - (s R model + t) ||.

    model/data: [N, 3]. Returns (s, R [3,3], t [3], aligned_model [N, 3]).
    """
    mu_m = model.mean(0)
    mu_d = data.mean(0)
    M = model - mu_m
    D = data - mu_d
    W = D.T @ M
    U, S, Vt = np.linalg.svd(W)
    sgn = np.sign(np.linalg.det(U @ Vt))
    C = np.diag([1.0, 1.0, sgn])
    R = U @ C @ Vt
    if with_scale:
        s = (S * np.diag(C)).sum() / (M ** 2).sum()
    else:
        s = 1.0
    t = mu_d - s * R @ mu_m
    aligned = (s * (R @ model.T)).T + t
    return s, R, t, aligned


def ate_rmse(gt_ts, gt_xyz, est_ts, est_xyz, with_scale: bool = True,
             max_dt: float = 0.02):
    """RMS ATE after association + Horn alignment. Returns (rmse, n, scale)."""
    pairs = associate(np.asarray(est_ts), np.asarray(gt_ts), max_dt)
    if len(pairs) < 3:
        return float("inf"), 0, 1.0
    est = np.asarray(est_xyz)[pairs[:, 0]]
    gt = np.asarray(gt_xyz)[pairs[:, 1]]
    s, R, t, aligned = align_horn(est, gt, with_scale)
    err = np.linalg.norm(aligned - gt, axis=1)
    return float(np.sqrt((err ** 2).mean())), len(pairs), float(s)


def load_tum(path: str):
    """Load a trajectory: TUM whitespace format (t x y z qx qy qz qw) or
    the EuRoC/TUM-VI csv exports (state_groundtruth_estimate0/data.csv,
    mocap0/data.csv: ns-timestamp, px, py, pz, ...) that the reference
    passes straight to evaluate_ate_scale.py. Comment/header lines are
    skipped; nanosecond timestamps are converted to seconds."""
    with open(path) as f:
        first = f.readline()
    delim = "," if "," in first else None
    data = np.loadtxt(path, delimiter=delim, comments="#")
    ts = data[:, 0]
    if ts.size and abs(ts[0]) > 1e14:   # nanoseconds (EuRoC epoch stamps)
        ts = ts * 1e-9
    return ts, data[:, 1:4]
