"""Reprojection residuals + analytic Jacobians for Gauss-Newton.

Counterpart of ``optim/reproj.py`` of the JAX package (reference:
src/OptimizableTypes.cpp EdgeSE3ProjectXYZ[OnlyPose]). Pose perturbations are
left-multiplied twists delta = (rho, phi): T_cw <- exp(delta) ∘ T_cw, so
d(p_c)/d(delta) = [ I | -hat(p_c) ].
"""
from __future__ import annotations

import torch

from ..lie import SE3
from ..models import cameras

CHI2_MONO = 5.991    # chi2(0.95, 2 dof)  (reference: Optimizer.cc:291)


def _twist_jac(Jproj: torch.Tensor, pc: torch.Tensor) -> torch.Tensor:
    """J_cam = Jproj @ [I | -hat(pc)], element-wise: [.., 2, 6]."""
    x, y, z = pc[..., 0], pc[..., 1], pc[..., 2]
    rows = []
    for k in range(Jproj.shape[-2]):
        J0, J1, J2 = Jproj[..., k, 0], Jproj[..., k, 1], Jproj[..., k, 2]
        rows.append(torch.stack([J0, J1, J2, J2 * y - J1 * z,
                                 J0 * z - J2 * x, J1 * x - J0 * y], dim=-1))
    return torch.stack(rows, dim=-2)


def _point_jac(Jproj: torch.Tensor, R: torch.Tensor) -> torch.Tensor:
    """J_pt = Jproj @ R, element-wise: [.., 2, 3]. R is [3, 3] for one pose
    or [.., 3, 3] batched."""
    rows = []
    for k in range(Jproj.shape[-2]):
        J0, J1, J2 = Jproj[..., k, 0], Jproj[..., k, 1], Jproj[..., k, 2]
        rows.append(torch.stack([
            J0 * R[..., 0, j] + J1 * R[..., 1, j] + J2 * R[..., 2, j]
            for j in range(3)], dim=-1))
    return torch.stack(rows, dim=-2)


def residual_full(T_cw: SE3, X_w: torch.Tensor, uv: torch.Tensor,
                  cam: cameras.CameraParams):
    """r, J_cam [M, 2, 6], J_pt [M, 2, 3], depth_ok [M]: for BA."""
    pc = T_cw.apply(X_w)
    r = uv - cameras.project(cam, pc)
    Jproj = cameras.project_jac(cam, pc)
    return (r, _twist_jac(Jproj, pc), _point_jac(Jproj, T_cw.R),
            pc[..., 2] > 0.05)


def residual_pose(T_cw: SE3, X_w: torch.Tensor, uv: torch.Tensor,
                  cam: cameras.CameraParams):
    """r = uv - proj(T_cw X) and J = d proj / d twist.

    X_w [M, 3], uv [M, 2] -> r [M, 2], J [M, 2, 6], depth_ok [M]."""
    pc = T_cw.apply(X_w)
    r = uv - cameras.project(cam, pc)
    return r, _twist_jac(cameras.project_jac(cam, pc), pc), pc[..., 2] > 0.05


def huber_weight(chi2: torch.Tensor, delta2: float) -> torch.Tensor:
    """IRLS weight of the Huber kernel for squared error chi2 = e^T Ω e."""
    return torch.where(chi2 <= delta2, torch.ones_like(chi2),
                       torch.sqrt(delta2 / torch.clamp(chi2, min=1e-12)))
