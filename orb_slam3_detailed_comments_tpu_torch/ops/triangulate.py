"""Two-view triangulation (batched DLT).

Counterpart of ``ops/triangulate.py`` of the JAX package (reference:
GeometricTools::Triangulate, src/GeometricTools.cc:60). Solves the 4x4
homogeneous DLT system of many correspondences at once; the null direction
of each normal matrix comes from its closed-form adjugate, not from a
batched eigendecomposition.
"""
from __future__ import annotations

import functools

import torch

from ..lie import SE3


def _proj_rows(T: SE3, xn: torch.Tensor):
    """Rows of the DLT system for normalized coords xn [..., 2].

    P = [R | t] (3x4). Rows: xn.x * P[2] - P[0], xn.y * P[2] - P[1]."""
    P = torch.cat([T.R, T.t[..., :, None]], dim=-1)          # [..., 3, 4]
    r0 = xn[..., 0:1] * P[..., 2, :] - P[..., 0, :]
    r1 = xn[..., 1:2] * P[..., 2, :] - P[..., 1, :]
    return r0, r1


def triangulate(T1: SE3, xn1: torch.Tensor, T2: SE3, xn2: torch.Tensor):
    """Triangulate N correspondences.

    T1, T2: world->camera transforms (batched or single); xn1, xn2 [N, 2]
    normalized image coordinates. Returns X_w [N, 3], ok [N] (non-vanishing
    homogeneous w)."""
    rows = (*_proj_rows(T1, xn1), *_proj_rows(T2, xn2))
    AtA = sum(r[..., :, None] * r[..., None, :] for r in rows)
    xh = _null4(AtA)
    wh = xh[..., 3]
    ok = torch.abs(wh) > 1e-8
    X = xh[..., :3] / torch.where(ok, wh, torch.ones_like(wh))[..., None]
    return X, ok


def _det3(m: torch.Tensor) -> torch.Tensor:
    return (m[..., 0, 0] * (m[..., 1, 1] * m[..., 2, 2]
                            - m[..., 1, 2] * m[..., 2, 1])
            - m[..., 0, 1] * (m[..., 1, 0] * m[..., 2, 2]
                              - m[..., 1, 2] * m[..., 2, 0])
            + m[..., 0, 2] * (m[..., 1, 0] * m[..., 2, 1]
                              - m[..., 1, 1] * m[..., 2, 0]))


@functools.lru_cache(maxsize=8)
def _minor_index(device: torch.device, dtype: torch.dtype):
    """Row and column indices [4, 4, 3, 3] of the 16 3x3 minors of a 4x4
    matrix, and the cofactor signs [4, 4], on the device once (indexing
    with Python lists would upload them, a host sync, at every call)."""
    keep = [[r for r in range(4) if r != i] for i in range(4)]
    rows = torch.tensor([[[[keep[i][a]] * 3 for a in range(3)]
                          for _ in range(4)] for i in range(4)])
    cols = torch.tensor([[[keep[j]] * 3 for j in range(4)]
                         for _ in range(4)])
    sign = torch.tensor([[(-1.0) ** (i + j) for j in range(4)]
                         for i in range(4)], dtype=dtype)
    return rows.to(device), cols.to(device), sign.to(device)


def _null4(M: torch.Tensor) -> torch.Tensor:
    """Null direction of batched symmetric PSD [.., 4, 4] matrices whose
    smallest eigenvalue is far below the next (the DLT normal matrix of a
    consistent match).

    adj(M) = sum_i (prod_{j != i} lambda_j) v_i v_i^T is dominated by the
    smallest-eigenvalue term, so a well-scaled column of the closed-form
    adjugate is the null direction; one more multiply by adj squares the
    eigengap."""
    rows, cols, sign = _minor_index(M.device, M.dtype)
    # cofactor (i, j) = sign * det of M without row i and column j; the
    # adjugate is the cofactors' transpose
    adj = (sign * _det3(M[..., rows, cols])).transpose(-1, -2)
    diag = torch.abs(torch.diagonal(adj, dim1=-2, dim2=-1))
    k = torch.argmax(diag, dim=-1)
    col = torch.gather(adj, -1, k[..., None, None].expand(
        *adj.shape[:-1], 1))[..., 0]
    nrm = torch.linalg.norm(col, dim=-1, keepdim=True)
    col = col / torch.clamp(nrm, min=1e-30)
    col2 = torch.einsum("...ij,...j->...i", adj, col)
    n2 = torch.linalg.norm(col2, dim=-1, keepdim=True)
    return torch.where(n2 > 1e-30, col2 / torch.clamp(n2, min=1e-30), col)


def depths(T: SE3, X_w: torch.Tensor) -> torch.Tensor:
    return T.apply(X_w)[..., 2]


def parallax_cos(T1: SE3, T2: SE3, X_w: torch.Tensor) -> torch.Tensor:
    """cos of the ray-parallax angle at each triangulated point."""
    r1 = X_w - T1.inverse().t
    r2 = X_w - T2.inverse().t
    num = torch.sum(r1 * r2, dim=-1)
    den = torch.linalg.norm(r1, dim=-1) * torch.linalg.norm(r2, dim=-1)
    return num / torch.clamp(den, min=1e-12)
