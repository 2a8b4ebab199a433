"""Motion-only pose optimization (tracking hot loop #2).

Counterpart of ``optim/pose_opt.py::pose_optimization`` of the JAX package
(reference: Optimizer::PoseOptimization, src/Optimizer.cc:55): 4 rounds x 10
Gauss-Newton iterations with a Huber kernel, re-classifying outliers at the
chi2(0.95) gate between rounds.

The JAX version leaves a round's GN loop once the applied step is below
tolerance (a ``while_loop``). Eager PyTorch would pay one host sync per
iteration to test that; here every iteration runs and a sticky done flag on
the device freezes the pose once a step converged, which gives exactly the
JAX result (after convergence the pose is frozen, not advanced) with no
host sync inside the optimizer.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..lie import SE3, se3
from ..models import cameras
from . import reproj


class PoseOptResult(NamedTuple):
    T_cw: SE3
    inlier: torch.Tensor     # [M] bool
    n_inliers: torch.Tensor  # scalar int32


def pose_optimization(T_cw0: SE3, X_w: torch.Tensor, uv: torch.Tensor,
                      inv_sigma2: torch.Tensor, valid: torch.Tensor,
                      cam: cameras.CameraParams, iters: int = 10,
                      rounds: int = 4) -> PoseOptResult:
    """X_w [M, 3] world points, uv [M, 2] observations, inv_sigma2 [M]
    per-level information weights, valid [M] observation mask."""
    delta2 = reproj.CHI2_MONO
    tol = 1e-8   # on ||dx||^2, i.e. ||dx|| ~ 1e-4
    dev = X_w.device
    eye6 = torch.eye(6, dtype=torch.float32, device=dev)
    T = T_cw0
    inlier = torch.ones(X_w.shape[0], dtype=torch.bool, device=dev)
    for _ in range(rounds):
        done = torch.zeros((), dtype=torch.bool, device=dev)
        for _ in range(iters):
            r, J, depth_ok = reproj.residual_pose(T, X_w, uv, cam)
            w_info = inv_sigma2 * (valid & inlier & depth_ok)
            chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
            w = w_info * reproj.huber_weight(chi2, delta2)
            H = torch.einsum("mki,m,mkj->ij", J, w, J)
            b = torch.einsum("mki,m,mk->i", J, w, r)
            H = H + 1e-5 * eye6 * torch.clamp(torch.trace(H) / 6.0, min=1.0)
            dx = torch.linalg.solve_ex(H, b)[0]
            T_new = se3.exp(dx).compose(T)
            T = SE3(torch.where(done, T.R, T_new.R),
                    torch.where(done, T.t, T_new.t))
            # the JAX loop stops once ||dx||^2 <= tol (or is NaN)
            done = done | ~(torch.sum(dx * dx) > tol)
        r, _, depth_ok = reproj.residual_pose(T, X_w, uv, cam)
        chi2 = torch.sum(r * r, dim=-1) * inv_sigma2
        inlier = (chi2 <= delta2) & depth_ok & valid
    return PoseOptResult(T.normalized(), inlier,
                         torch.sum(inlier.to(torch.int32)))
