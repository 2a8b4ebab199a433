"""Batched-hypothesis PnP RANSAC for relocalisation.

Counterpart of ``placerec/pnp.py`` of the JAX package (reference:
MLPnPsolver, src/MLPnPsolver.cpp, used by Tracking::Relocalization at
Tracking.cc:4324). Works on normalised coordinates, so it is camera-model
agnostic. Each hypothesis solves the 6-point DLT for the 3x4 projection
matrix (all hypotheses as one batched eigenproblem); the best one is
polished by MLPnP's maximum-likelihood refinement, Gauss-Newton on the
tangent-space residuals of the observed bearing vectors.

Where this differs from the JAX code: the minimal sets come from a
``torch.Generator`` (or are given, ``sample_idx``), not ``jax.random``; the
DLT's 12x12 eigenproblems are solved in float64 (a float32 ``eigh`` is
too coarse on near-degenerate sets, as in ``models/twoview.py``); and the
DLT takes the null vector with the sign that gives its 3x3 block a
positive determinant. The JAX code keeps whichever sign ``eigh`` returns,
and for the other sign its reflection fix turns -R into a rotation that is
not R (its hypothesis is then off by up to pi; RANSAC discards it).
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.autograd.forward_ad as fwAD

from ..lie import so3


def _pnp_dlt(X: torch.Tensor, xn: torch.Tensor):
    """Minimal DLT: X [..., M, 3] world, xn [..., M, 2] normalised ->
    R [..., 3, 3], t [..., 3] (world -> camera), least squares over M >= 6."""
    ones = torch.ones_like(X[..., :1])
    Xh = torch.cat([X, ones], dim=-1)                        # [..., M, 4]
    u, v = xn[..., 0:1], xn[..., 1:2]
    z = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, z, -u * Xh], dim=-1)
    r2 = torch.cat([z, Xh, -v * Xh], dim=-1)
    A = torch.cat([r1, r2], dim=-2)                          # [..., 2M, 12]
    AtA = torch.einsum("...ki,...kj->...ij", A, A)
    _, vec = torch.linalg.eigh(AtA.double())
    p = vec[..., :, 0].reshape(*A.shape[:-2], 3, 4)
    # P and -P solve the DLT alike: take the one with det(P[:, :3]) > 0
    sign = torch.where(torch.linalg.det(p[..., :3]) < 0, -1.0, 1.0)
    p = (p * sign[..., None, None]).to(X.dtype)
    U, s, Vt = torch.linalg.svd(p[..., :3])
    det = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(det), torch.ones_like(det), det], -1)
    R = U @ (D[..., :, None] * Vt)
    scale = torch.mean(s, dim=-1) * torch.sign(det)
    scale = torch.where(torch.abs(scale) < 1e-12,
                        torch.full_like(scale, 1e-12), scale)
    return R, p[..., 3] / scale[..., None]


def jacobian(f, x: torch.Tensor) -> torch.Tensor:
    """Forward-mode Jacobian of f at the vector x [D]: f(x)'s shape + [D],
    one dual-number pass per direction (``torch.autograd.forward_ad``;
    ``torch.func``'s transforms decompose these ops in Python, ten times
    slower on the host)."""
    cols = []
    for k in range(x.shape[0]):
        e = torch.zeros_like(x)
        e[k] = 1.0
        with fwAD.dual_level():
            cols.append(fwAD.unpack_dual(f(fwAD.make_dual(x, e))).tangent)
    return torch.stack(cols, dim=-1)


def _tangent_basis(b: torch.Tensor):
    """Orthonormal (s, u) spanning the nullspace of each unit bearing b."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=b.dtype, device=b.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=b.dtype, device=b.device)
    a = torch.where(torch.abs(b[..., :1]) < 0.9, ex, ey)
    s = torch.linalg.cross(b, a.expand_as(b), dim=-1)
    s = s / torch.linalg.norm(s, dim=-1, keepdim=True)
    return s, torch.linalg.cross(b, s, dim=-1)


def _ml_refine(R0: torch.Tensor, t0: torch.Tensor, X: torch.Tensor,
               bear: torch.Tensor, w: torch.Tensor, n_iter: int = 6):
    """MLPnP maximum-likelihood polish: GN on the 2-dof tangent residuals
    [s_i; u_i]^T (R X_i + t) / |R X_i + t|, weighted by w."""
    s, u = _tangent_basis(bear)

    def residuals(xi, R, t):
        dR = so3.exp(xi[:3])
        p = X @ (dR @ R).T + (dR @ t + xi[3:])
        ph = p / torch.clamp(torch.linalg.norm(p, dim=-1, keepdim=True),
                             min=1e-12)
        return torch.stack([torch.sum(s * ph, -1), torch.sum(u * ph, -1)], -1)

    R, t = R0, t0
    zero = torch.zeros(6, dtype=X.dtype, device=X.device)
    eye = torch.eye(6, dtype=X.dtype, device=X.device)
    for _ in range(n_iter):
        r = residuals(zero, R, t)                                  # [N, 2]
        J = jacobian(lambda xi: residuals(xi, R, t), zero)         # [N, 2, 6]
        Jw = J * w[:, None, None]
        H = torch.einsum("nki,nkj->ij", Jw, J) + 1e-9 * eye
        g = torch.einsum("nki,nk->i", Jw, r)
        xi = -torch.linalg.solve(H, g)
        dR = so3.exp(xi[:3])
        R, t = dR @ R, dR @ t + xi[3:]
    return R, t


class PnPResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    inliers: torch.Tensor
    n_inliers: torch.Tensor
    ok: torch.Tensor


def sample_sets(valid: torch.Tensor, n_hyp: int, size: int,
                generator: Optional[torch.Generator]) -> torch.Tensor:
    """[n_hyp, size] minimal sets over the valid rows: the top ``size`` of
    a uniform draw per hypothesis, invalid rows at -1 (the JAX scheme)."""
    g = torch.rand((n_hyp, valid.shape[0]), generator=generator,
                   device=valid.device)
    g = torch.where(valid[None, :], g, torch.full_like(g, -1.0))
    return torch.topk(g, size, dim=-1).indices


def solve_pnp_ransac(X: torch.Tensor, xn: torch.Tensor, valid: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     focal: float = 460.0, n_hyp: int = 256,
                     th_px2: float = 5.991, min_inliers: int = 10,
                     sample_idx: Optional[torch.Tensor] = None) -> PnPResult:
    """X [N, 3] world points, xn [N, 2] observed normalised coordinates.
    sample_idx [n_hyp, 6] replaces the drawn minimal sets."""
    idx = (sample_sets(valid, n_hyp, 6, generator) if sample_idx is None
           else sample_idx.to(valid.device).long())
    R, t = _pnp_dlt(X[idx], xn[idx])                         # [H, 3, 3], [H, 3]

    def score(R, t):
        pc = torch.einsum("...ij,nj->...ni", R, X) + t[..., None, :]
        z = pc[..., 2:3]
        z = torch.where(torch.abs(z) < 1e-9, torch.full_like(z, 1e-9), z)
        e = torch.sum((pc[..., :2] / z - xn) ** 2, -1) * focal * focal
        return (e < th_px2) & valid & (pc[..., 2] > 0)

    inls = score(R, t)                                       # [H, N]
    best = torch.argmax(inls.sum(-1))
    inl = inls[best]
    bear = torch.cat([xn, torch.ones_like(xn[:, :1])], dim=-1)
    bear = bear / torch.linalg.norm(bear, dim=-1, keepdim=True)
    Rb, tb = _ml_refine(R[best], t[best], X, bear, inl.to(X.dtype))
    inl2 = score(Rb, tb)
    use = inl2.sum() >= inl.sum()
    Rf = torch.where(use, Rb, R[best])
    tf = torch.where(use, tb, t[best])
    inlf = torch.where(use, inl2, inl)
    n = inlf.sum()
    return PnPResult(Rf, tf, inlf, n, n >= min_inliers)
