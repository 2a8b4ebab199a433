"""Sim3 / SE3 estimation from 3D-3D correspondences: batched Horn RANSAC.

Counterpart of ``placerec/sim3_solver.py`` of the JAX package (reference:
src/Sim3Solver.cc): Horn's closed-form similarity from 3-point minimal
samples inside RANSAC, inliers by reprojection error in both images, every
hypothesis solved and scored at once; then a Gauss-Newton refinement on the
bidirectional reprojection error (reference: Optimizer::OptimizeSim3).

Where this differs from the JAX code: the minimal sets come from a
``torch.Generator`` (or are given, ``sample_idx``); Horn's 4x4
eigenproblems are solved in float64.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..lie import so3
from .pnp import jacobian, sample_sets


def horn_sim3(x1: torch.Tensor, x2: torch.Tensor, fix_scale: bool = False):
    """Closed-form similarity x2 = s R x1 + t from [..., M, 3] pairs
    (Horn's quaternion method, reference: Sim3Solver::ComputeSim3)."""
    c1 = torch.mean(x1, dim=-2, keepdim=True)
    c2 = torch.mean(x2, dim=-2, keepdim=True)
    a = x1 - c1
    b = x2 - c2
    M = torch.einsum("...mi,...mj->...ij", b, a)
    Sxx, Sxy, Sxz = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    Syx, Syy, Syz = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    Szx, Szy, Szz = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    N = torch.stack([
        torch.stack([Sxx + Syy + Szz, Syz - Szy, Szx - Sxz, Sxy - Syx], -1),
        torch.stack([Syz - Szy, Sxx - Syy - Szz, Sxy + Syx, Szx + Sxz], -1),
        torch.stack([Szx - Sxz, Sxy + Syx, -Sxx + Syy - Szz, Syz + Szy], -1),
        torch.stack([Sxy - Syx, Szx + Sxz, Syz + Szy, -Sxx - Syy + Szz], -1),
    ], dim=-2)
    _, v = torch.linalg.eigh(N.double())
    q = v[..., :, -1].to(x1.dtype)                   # largest: [w, x, y, z]
    R = so3.from_quat(torch.stack([q[..., 1], q[..., 2], q[..., 3],
                                   q[..., 0]], -1)).transpose(-1, -2)
    if fix_scale:
        s = torch.ones(R.shape[:-2], dtype=x1.dtype, device=x1.device)
    else:
        num = torch.sum(b * torch.einsum("...ij,...mj->...mi", R, a),
                        dim=(-1, -2))
        den = torch.sum(a * a, dim=(-1, -2))
        s = num / torch.clamp(den, min=1e-12)
    t = c2[..., 0, :] - s[..., None] * torch.einsum("...ij,...j->...i", R,
                                                    c1[..., 0, :])
    return R, t, s


class Sim3Result(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    inliers: torch.Tensor   # [N]
    n_inliers: torch.Tensor
    ok: torch.Tensor


def _safe_z(y: torch.Tensor) -> torch.Tensor:
    z = y[..., 2:3]
    return torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)


def solve_sim3_ransac(x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor,
                      xn1: torch.Tensor, xn2: torch.Tensor,
                      generator: Optional[torch.Generator] = None,
                      focal: float = 460.0, n_hyp: int = 128,
                      th_px2: float = 10.0, min_inliers: int = 20,
                      fix_scale: bool = False,
                      sample_idx: Optional[torch.Tensor] = None
                      ) -> Sim3Result:
    """x1 / x2 [N, 3]: matched 3D points in the two keyframes' camera
    frames; xn1 / xn2 [N, 2] their observed normalised coordinates. Returns
    the transform x1 = s R x2 + t, with inliers by reprojection in both
    images (reference: Sim3Solver::CheckInliers)."""
    idx = (sample_sets(valid, n_hyp, 3, generator) if sample_idx is None
           else sample_idx.to(valid.device).long())
    R, t, s = horn_sim3(x2[idx], x1[idx], fix_scale)

    def score(R, t, s):
        y1 = s[..., None, None] * torch.einsum("...ij,nj->...ni", R, x2) \
            + t[..., None, :]
        e1 = torch.sum((y1[..., :2] / _safe_z(y1) - xn1) ** 2, -1) \
            * focal * focal
        y2 = torch.einsum("...ji,...nj->...ni", R, x1 - t[..., None, :]) \
            / torch.clamp(s, min=1e-9)[..., None, None]
        e2 = torch.sum((y2[..., :2] / _safe_z(y2) - xn2) ** 2, -1) \
            * focal * focal
        return ((e1 < th_px2) & (e2 < th_px2) & valid & (y1[..., 2] > 0)
                & (y2[..., 2] > 0))

    inls = score(R, t, s)                                    # [H, N]
    best = torch.argmax(inls.sum(-1))
    inl = inls[best]
    # polish: Horn on all inliers (the others sit at the inlier centroid)
    w = inl.to(x1.dtype)
    nw = torch.clamp(w.sum(), min=1.0)
    c1 = torch.sum(x1 * w[:, None], 0) / nw
    c2 = torch.sum(x2 * w[:, None], 0) / nw
    x1w = torch.where(inl[:, None], x1, c1)
    x2w = torch.where(inl[:, None], x2, c2)
    Rb, tb, sb = horn_sim3(x2w, x1w, fix_scale)
    inl2 = score(Rb, tb, sb)
    use = inl2.sum() >= inl.sum()
    Rf = torch.where(use, Rb, R[best])
    tf = torch.where(use, tb, t[best])
    sf = torch.where(use, sb, s[best])
    inlf = torch.where(use, inl2, inl)
    n = inlf.sum()
    return Sim3Result(Rf, tf, sf, inlf, n, n >= min_inliers)


def refine_sim3_gn(R0, t0, s0, x1, x2, xn1, xn2, valid,
                   focal: float = 460.0, iters: int = 8,
                   fix_scale: bool = False, th_px2: float = 10.0,
                   min_inliers: int = 20) -> Sim3Result:
    """Gauss-Newton refinement of a Sim3 on the bidirectional reprojection
    error with Huber weights (reference: Optimizer::OptimizeSim3,
    src/Optimizer.cc:4195), relinearised each iteration; inputs follow
    ``solve_sim3_ransac``'s convention (x1 = s R x2 + t)."""
    dt = x1.dtype
    dev = x1.device

    def residuals(p, R, t, s):
        Rp = so3.exp(p[:3]) @ R
        tp = t + p[3:6]
        sp = s * torch.exp(p[6] * 0.0 if fix_scale else p[6])
        y1 = sp * (x2 @ Rp.T) + tp
        y2 = ((x1 - tp) @ Rp) / torch.clamp(sp, min=1e-9)
        r = torch.cat([(y1[:, :2] / _safe_z(y1) - xn1) * focal,
                       (y2[:, :2] / _safe_z(y2) - xn2) * focal], dim=-1)
        return r, (y1[:, 2] > 0) & (y2[:, 2] > 0)

    R, t, s = R0, t0, torch.as_tensor(s0, dtype=dt, device=dev)
    p0 = torch.zeros(7, dtype=dt, device=dev)
    eye = torch.eye(7, dtype=dt, device=dev)
    for _ in range(iters):
        r, front = residuals(p0, R, t, s)
        chi2 = (torch.sum(r[:, :2] ** 2, -1) + torch.sum(r[:, 2:] ** 2, -1)) / 2
        w = (valid & front).to(dt)
        w = w * torch.clamp(torch.sqrt(th_px2 / torch.clamp(chi2, min=1e-9)),
                            max=1.0)
        J = jacobian(lambda p: residuals(p, R, t, s)[0], p0)
        Jf = (J * w[:, None, None]).reshape(-1, 7)
        rf = (r * w[:, None]).reshape(-1)
        dp = -torch.linalg.solve(Jf.T @ Jf + 1e-6 * eye, Jf.T @ rf)
        dp = torch.where(torch.isfinite(dp), dp, torch.zeros_like(dp))
        R = so3.exp(dp[:3]) @ R
        t = t + dp[3:6]
        if not fix_scale:
            s = s * torch.exp(dp[6])
    r, front = residuals(p0, R, t, s)
    inl = ((torch.sum(r[:, :2] ** 2, -1) < th_px2)
           & (torch.sum(r[:, 2:] ** 2, -1) < th_px2) & valid & front)
    n = inl.sum()
    return Sim3Result(R, t, s, inl, n, n >= min_inliers)
