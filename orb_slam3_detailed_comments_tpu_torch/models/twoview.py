"""Monocular map initialization: two-view reconstruction.

Counterpart of ``models/twoview.py`` of the JAX package (reference:
src/TwoViewReconstruction.cc): parallel RANSAC of a homography and an
essential matrix, model selection by score ratio, motion recovery (E -> 4
motions, H -> 8 Faugeras motions), cheirality / parallax voting,
triangulation. All hypotheses are solved at once: the minimal 8-point and
4-point systems are one batched [NH, 9, 9] eigenproblem each, and every
hypothesis is scored against every correspondence in one [NH, N] pass.
Everything runs in normalized camera coordinates, so the "F" model is
directly the essential matrix.

The minimal sets are an explicit input (``samples``) or are drawn from a
``torch.Generator`` (``sample_minimal_sets``): the JAX version draws them
from ``jax.random`` inside the program, a stream torch cannot reproduce.
The batched ``eigh`` / ``svd`` calls are library routines here as there.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..lie import SE3
from ..ops import triangulate as tri
from ..ops.topk import stable_top

CHI2_H = 5.991
CHI2_E = 3.841
SCORE_TH = 5.991


class TwoViewResult(NamedTuple):
    success: torch.Tensor     # bool scalar
    R21: torch.Tensor         # [3, 3] rotation frame1 -> frame2
    t21: torch.Tensor         # [3] unit-norm translation
    points3d: torch.Tensor    # [N, 3] in frame-1 coordinates
    is_good: torch.Tensor     # [N] triangulated + cheirality-clean
    used_homography: torch.Tensor  # bool scalar


def _smallest_eigvec9(A: torch.Tensor) -> torch.Tensor:
    """A [..., M, 9] -> unit null-ish vector [..., 9] via eigh of A^T A.

    The normal matrix and its decomposition are taken in float64: in
    normalized coordinates its spectrum spans more than float32 resolves,
    and the smallest eigenvector of the float32 matrix depends on the
    eigensolver at hand."""
    A64 = A.to(torch.float64)
    AtA = torch.einsum("...ki,...kj->...ij", A64, A64)
    _, v = torch.linalg.eigh(AtA)
    return v[..., :, 0].to(A.dtype)


def _epipolar_rows(x1, x2):
    """Rows of x2^T E x1 = 0 with x = (u, v, 1): [..., 9]."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    one = torch.ones_like(u1)
    return torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                        one], dim=-1)


def _homography_rows(x1, x2):
    """The two DLT rows per correspondence of x2 ~ H x1: ([..., 9], [..., 9])."""
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    zero = torch.zeros_like(u1)
    one = torch.ones_like(u1)
    r1 = torch.stack([zero, zero, zero, -u1, -v1, -one, v2 * u1, v2 * v1, v2],
                     dim=-1)
    r2 = torch.stack([u1, v1, one, zero, zero, zero, -u2 * u1, -u2 * v1, -u2],
                     dim=-1)
    return r1, r2


def _to_essential(E: torch.Tensor) -> torch.Tensor:
    """Enforce the essential-matrix singular values (s, s, 0)."""
    U, s, Vt = torch.linalg.svd(E)
    s_mean = (s[..., 0] + s[..., 1]) * 0.5
    s_new = torch.stack([s_mean, s_mean, torch.zeros_like(s_mean)], dim=-1)
    return U @ (s_new[..., :, None] * Vt)


def _essential_from_8pts(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """x1, x2 [..., 8, 2] normalized coords -> E [..., 3, 3] (rank 2)."""
    e = _smallest_eigvec9(_epipolar_rows(x1, x2))
    return _to_essential(e.reshape(*e.shape[:-1], 3, 3))


def _homography_from_4pts(x1: torch.Tensor, x2: torch.Tensor) -> torch.Tensor:
    """x1, x2 [..., 4, 2] -> H [..., 3, 3] with x2 ~ H x1."""
    r1, r2 = _homography_rows(x1, x2)
    h = _smallest_eigvec9(torch.cat([r1, r2], dim=-2))
    return h.reshape(*h.shape[:-1], 3, 3)


def _homog(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, torch.ones_like(x[..., :1])], dim=-1)


def _epipolar_chi2(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                   f2: float):
    """Squared point-to-epipolar-line distances, both directions.

    E [H, 3, 3]; x1 / x2 [N, 2]. f2 scales normalized-coordinate errors to
    px^2. Returns chi2_1, chi2_2, each [H, N]."""
    X1, X2 = _homog(x1), _homog(x2)
    l2 = torch.einsum("hij,nj->hni", E, X1)                  # line in image 2
    l1 = torch.einsum("hji,nj->hni", E, X2)                  # line in image 1
    num = torch.einsum("ni,hni->hn", X2, l2)
    d2 = num * num / torch.clamp(l2[..., 0] ** 2 + l2[..., 1] ** 2, min=1e-12)
    d1 = num * num / torch.clamp(l1[..., 0] ** 2 + l1[..., 1] ** 2, min=1e-12)
    return d1 * f2, d2 * f2


def _homography_chi2(H: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                     f2: float):
    # inv_ex: a singular hypothesis yields non-finite errors and no inliers
    Hinv = torch.linalg.inv_ex(H)[0]
    X1, X2 = _homog(x1), _homog(x2)

    def transfer(M, X, target):
        y = torch.einsum("hij,nj->hni", M, X)
        den = y[..., 2:3]
        y = y[..., :2] / torch.where(torch.abs(den) < 1e-12,
                                     torch.full_like(den, 1e-12), den)
        d = y - target[None]
        return torch.sum(d * d, dim=-1)

    return transfer(Hinv, X2, x1) * f2, transfer(H, X1, x2) * f2


def _safe_div(num: torch.Tensor, den: torch.Tensor) -> torch.Tensor:
    return num / torch.where(torch.abs(den) < 1e-9,
                             torch.full_like(den, 1e-9), den)


def _check_rt(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor,
              x2: torch.Tensor, inlier: torch.Tensor, f2: float,
              sigma2: float = 1.0):
    """Points passing cheirality + parallax + reprojection for each of the
    M candidates R [M, 3, 3], t [M, 3] (reference:
    TwoViewReconstruction::CheckRT). Returns good [M, N], n_good [M],
    X [M, N, 3], cos of the parallax [M, N]."""
    T1 = SE3.identity(device=R.device)
    T2 = SE3(R[:, None], t[:, None])
    X, ok = tri.triangulate(T1, x1, T2, x2)
    pc2 = T2.apply(X)
    z1, z2 = X[..., 2], pc2[..., 2]
    cosp = tri.parallax_cos(T1, T2, X)
    # reprojection error in both views (normalized -> approx px via f2)
    e1 = torch.sum((_safe_div(X[..., :2], z1[..., None]) - x1) ** 2, -1) * f2
    e2 = torch.sum((_safe_div(pc2[..., :2], z2[..., None]) - x2) ** 2, -1) * f2
    good = (inlier & ok & (z1 > 0) & (z2 > 0) & (cosp < 0.99998)
            & (e1 < 4.0 * sigma2) & (e2 < 4.0 * sigma2))
    return good, torch.sum(good, dim=-1), X, cosp


def _proper(M: torch.Tensor) -> torch.Tensor:
    return M * torch.sign(torch.linalg.det(M))


def _motions_from_E(E: torch.Tensor):
    """E [3, 3] -> 4 candidate (R [4, 3, 3], t [4, 3])."""
    U, _, Vt = torch.linalg.svd(E)
    U, Vt = _proper(U), _proper(Vt)
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    t = t / torch.clamp(torch.linalg.norm(t), min=1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _motions_from_H(H: torch.Tensor):
    """Faugeras-Lustman decomposition of a normalized homography -> 8
    motions (reference: TwoViewReconstruction::ReconstructH)."""
    U, s, Vt = torch.linalg.svd(H)
    d1, d2, d3 = s[0], s[1], s[2]
    detUV = torch.linalg.det(U) * torch.linalg.det(Vt)
    span = torch.clamp(d1 * d1 - d3 * d3, min=1e-12)
    x1 = torch.sqrt(torch.clamp((d1 * d1 - d2 * d2) / span, min=0.0))
    x3 = torch.sqrt(torch.clamp((d2 * d2 - d3 * d3) / span, min=0.0))
    zero, one = torch.zeros_like(d1), torch.ones_like(d1)

    def mat(rows):
        return torch.stack([torch.stack(r) for r in rows])

    Rs, ts = [], []
    # d' = +d2, then d' = -d2; four sign choices (e1, e3) each
    for neg in (False, True):
        for e1, e3 in ((1.0, 1.0), (1.0, -1.0), (-1.0, 1.0), (-1.0, -1.0)):
            if not neg:
                sin_t = (d1 - d3) * x1 * x3 / d2
                cos_t = (d1 * x3 * x3 + d3 * x1 * x1) / d2
                Rp = mat([[cos_t, zero, -e1 * e3 * sin_t],
                          [zero, one, zero],
                          [e1 * e3 * sin_t, zero, cos_t]])
                tp = torch.stack([e1 * x1, zero, -e3 * x3]) * (d1 - d3)
            else:
                sin_p = (d1 + d3) * x1 * x3 / d2
                cos_p = (d3 * x1 * x1 - d1 * x3 * x3) / d2
                Rp = mat([[cos_p, zero, e1 * e3 * sin_p],
                          [zero, -one, zero],
                          [e1 * e3 * sin_p, zero, -cos_p]])
                tp = torch.stack([e1 * x1, zero, e3 * x3]) * (d1 + d3)
            Rs.append(detUV * (U @ Rp @ Vt))
            ts.append(U @ tp)
    Rs = torch.stack(Rs)
    ts = torch.stack(ts)
    ts = ts / torch.clamp(torch.linalg.norm(ts, dim=-1, keepdim=True),
                          min=1e-12)
    return Rs, ts


def _essential_refit(x1, x2, w: torch.Tensor) -> torch.Tensor:
    """Least-squares E from all rows, weighted by the inlier mask w [N]."""
    A = _epipolar_rows(x1, x2) * w[:, None].to(x1.dtype)
    return _to_essential(_smallest_eigvec9(A).reshape(3, 3))


def _homography_refit(x1, x2, w: torch.Tensor) -> torch.Tensor:
    r1, r2 = _homography_rows(x1, x2)
    wf = w[:, None].to(x1.dtype)
    return _smallest_eigvec9(torch.cat([r1 * wf, r2 * wf], dim=-2)
                             ).reshape(3, 3)


def sample_minimal_sets(valid: torch.Tensor, n_hyp: int, k: int,
                        generator: torch.Generator | None = None
                        ) -> torch.Tensor:
    """[n_hyp, k] indices of k distinct valid matches per hypothesis: random
    keys with the invalid entries pushed to the bottom, then top-k. The
    generator must live on valid's device."""
    g = torch.rand((n_hyp, valid.shape[0]), generator=generator,
                   device=valid.device)
    g = torch.where(valid[None, :], g, torch.full_like(g, -1.0))
    return stable_top(g, k)[1]


def _model_scores(c1, c2, gate: float, valid):
    """Per-hypothesis inlier masks and scores (reference CheckFundamental /
    CheckHomography: gate per direction, score with 5.991 - chi2)."""
    v = valid[None]
    zero = torch.zeros_like(c1)
    score = torch.sum(torch.where((c1 < gate) & v, SCORE_TH - c1, zero)
                      + torch.where((c2 < gate) & v, SCORE_TH - c2, zero),
                      dim=-1)
    return (c1 < gate) & (c2 < gate) & v, score


def reconstruct(xn1: torch.Tensor, xn2: torch.Tensor, valid: torch.Tensor,
                generator: torch.Generator | None = None, samples=None,
                n_hyp: int = 256, focal: float = 460.0, sigma: float = 1.0,
                min_triangulated: int = 50) -> TwoViewResult:
    """Full two-view reconstruction from matched normalized coordinates.

    xn1 / xn2 [N, 2]: matched normalized (undistorted, K-free) coordinates;
    valid [N]: match mask. samples: optional (idx_e [n_hyp, 8],
    idx_h [n_hyp, 4]) minimal sets; drawn from ``generator`` when absent.
    Returns the pose of frame 2 wrt frame 1 and the triangulated points in
    frame-1 coordinates."""
    f2 = (focal / sigma) ** 2
    if samples is None:
        idx_e = sample_minimal_sets(valid, n_hyp, 8, generator)
        idx_h = sample_minimal_sets(valid, n_hyp, 4, generator)
    else:
        idx_e, idx_h = (s.long() for s in samples)

    # --- essential hypotheses ---
    E = _essential_from_8pts(xn1[idx_e], xn2[idx_e])          # [H, 3, 3]
    inl_e, score_e = _model_scores(*_epipolar_chi2(E, xn1, xn2, f2), CHI2_E,
                                   valid)
    best_e = torch.argmax(score_e)
    SE_score = score_e[best_e]
    # polish: re-estimate from all inliers (weighted least-squares rows)
    E_best = _essential_refit(xn1, xn2, inl_e[best_e])
    c1r, c2r = _epipolar_chi2(E_best[None], xn1, xn2, f2)
    inlier_e = (c1r[0] < CHI2_E) & (c2r[0] < CHI2_E) & valid

    # --- homography hypotheses ---
    Hm = _homography_from_4pts(xn1[idx_h], xn2[idx_h])
    inl_h, score_h = _model_scores(*_homography_chi2(Hm, xn1, xn2, f2),
                                   CHI2_H, valid)
    best_h = torch.argmax(score_h)
    SH_score = score_h[best_h]
    H_best = _homography_refit(xn1, xn2, inl_h[best_h])
    h1r, h2r = _homography_chi2(H_best[None], xn1, xn2, f2)
    inlier_h = (h1r[0] < CHI2_H) & (h2r[0] < CHI2_H) & valid

    # 0.45: the epipolar error is 1-D, so the E score is biased high against
    # the 2-D homography transfer error (see the JAX package's note)
    use_h = SH_score / torch.clamp(SH_score + SE_score, min=1e-9) > 0.45

    # --- motion recovery: score all 12 candidates (4 from E, 8 from H),
    # masked by which model won ---
    Re, te = _motions_from_E(E_best)
    Rh, th = _motions_from_H(H_best)
    Rs = torch.cat([Re, Rh], dim=0)                           # [12, 3, 3]
    ts = torch.cat([te, th], dim=0)
    model_mask = torch.cat([(~use_h).expand(4), use_h.expand(8)])
    inlier = torch.where(use_h, inlier_h, inlier_e)

    goods, ngoods, Xs, cosp = _check_rt(Rs, ts, xn1, xn2, inlier, f2,
                                        sigma ** 2)
    ngoods = torch.where(model_mask, ngoods, torch.full_like(ngoods, -1))
    best = torch.argmax(ngoods)
    n_best = ngoods[best]
    others = torch.arange(12, device=ngoods.device) != best
    n_second = torch.max(torch.where(others, ngoods,
                                     torch.full_like(ngoods, -1)))
    n_inl = torch.sum(inlier)

    # parallax check: the parallax of the min(50, n)-th best point must
    # exceed about one degree
    cos_good = torch.where(goods[best], cosp[best],
                           torch.full_like(cosp[best], -2.0))
    topk = torch.sort(cos_good, descending=True)[0]
    k50 = torch.clamp(torch.clamp(n_best - 1, min=0), max=50)
    parallax_ok = topk[k50] < math.cos(math.radians(1.0))

    success = ((n_best >= min_triangulated)
               & (n_best.float() > 0.75 * n_inl.float())
               & (n_second.float() < 0.75 * n_best.float())
               & parallax_ok)
    return TwoViewResult(success=success, R21=Rs[best], t21=ts[best],
                         points3d=Xs[best], is_good=goods[best],
                         used_homography=use_h)
