"""Inertial-only initialisation: gravity direction, scale, biases and
velocities.

Counterpart of ``imu/inertial_init.py`` of the JAX package (reference:
Optimizer::InertialOptimization, src/Optimizer.cc:3688 and the
scale / gravity-only variant at 4067, used by LocalMapping::InitializeIMU,
LocalMapping.cc:1516). Keyframe poses from visual SLAM stay fixed; the
optimiser estimates

    theta = [rwg (2: gravity-direction tangent), log_s (1),
             bg (3), ba (3), v_1..K (3K)]

by Gauss-Newton on the stacked, whitened 9-dof preintegration residuals
between consecutive keyframes.

Where this differs from the JAX code: the whole solve runs in float64 (the
inputs are rounded up from float32, the outputs rounded once to float32).
Its branches turn on floats (the least-squares seed, the accept test of
each damped step, the caller's gates on the scale), and in float64 the card
and the CPU take the same ones; the JAX solve is float32. The Jacobian is
the forward-mode one of ``optim/jac.py``.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..lie import so3
from ..optim.jac import jacobian_fwd
from . import factors, preintegration as pre_mod
from .preintegration import Preintegrated


class InertialInitResult(NamedTuple):
    R_wg: torch.Tensor       # [3, 3]: g_w = R_wg @ (0, 0, -9.81)
    scale: torch.Tensor      # []
    bg: torch.Tensor         # [3]
    ba: torch.Tensor         # [3]
    velocities: torch.Tensor  # [K, 3]
    cost: torch.Tensor


def _mv(A, x):
    return torch.einsum("...ij,...j->...i", A, x)


def _rotation_between_down_and(d: torch.Tensor) -> torch.Tensor:
    """The rotation taking (0, 0, -1) onto the unit direction d [3]."""
    gI = torch.tensor([0.0, 0.0, -1.0], dtype=d.dtype, device=d.device)
    v = torch.linalg.cross(gI, d)
    nv = torch.linalg.norm(v)
    ang = torch.atan2(nv, torch.dot(gI, d))
    return so3.exp(v / torch.clamp(nv, min=1e-9) * ang)


def _lstsq_min_norm(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The minimum-norm least-squares solution through the SVD, singular
    values below float32 eps * max(M, N) * s_max cut as ``jnp.linalg.lstsq``
    cuts them (padded velocity columns are zero): the card's
    ``torch.linalg.lstsq`` takes full-rank systems only."""
    U, S, Vh = torch.linalg.svd(A, full_matrices=False)
    cut = torch.finfo(torch.float32).eps * max(A.shape) * S[0]
    inv = torch.where(S > cut, 1.0 / torch.where(S > cut, S, 1.0), 0.0)
    return Vh.T @ (inv * (U.T @ b))


def initial_gravity_estimate(R_wb: torch.Tensor, pres: Preintegrated,
                             edge_valid=None) -> torch.Tensor:
    """Gravity direction from the mean of -R dV (reference:
    LocalMapping::InitializeIMU, LocalMapping.cc:1583-1620). pres: [K-1]
    windows; edge_valid [K-1] masks padded edges."""
    terms = torch.einsum("kij,kj->ki", R_wb[:-1], pres.dV)
    if edge_valid is not None:
        terms = terms * edge_valid[:, None].to(terms.dtype)
    dirG = -torch.sum(terms, dim=0)
    dirG = dirG / torch.clamp(torch.linalg.norm(dirG), min=1e-9)
    return _rotation_between_down_and(dirG)


def estimate_gyro_bias(R_wb: torch.Tensor, pres: Preintegrated,
                       iters: int = 4, edge_valid=None) -> torch.Tensor:
    """Gyro bias from the rotation-only alignment of the windows to the
    visual rotations: min_bg sum ||Log(dR(bg)^T R_i^T R_j)||^2 (stage 1 of
    the reference's IMU init)."""
    K = R_wb.shape[0]
    rel = R_wb[:-1].transpose(-1, -2) @ R_wb[1:]
    mask = (torch.ones(K - 1, dtype=R_wb.dtype, device=R_wb.device)
            if edge_valid is None else edge_valid.to(R_wb.dtype))

    def residuals(bg):
        dR = pre_mod.delta_rotation(pres, bg[..., None, :])
        r = so3.log(dR.transpose(-1, -2) @ rel) * mask[:, None]
        return r.reshape(*bg.shape[:-1], -1)

    bg = torch.zeros(3, dtype=R_wb.dtype, device=R_wb.device)
    eye = torch.eye(3, dtype=R_wb.dtype, device=R_wb.device)
    for _ in range(iters):
        r, J = jacobian_fwd(residuals, bg)
        bg = bg - torch.linalg.solve(J.T @ J + 1e-8 * eye, J.T @ r)
    return bg


def inertial_optimization(R_wb: torch.Tensor, p_w: torch.Tensor,
                          pres: Preintegrated, R_wg0: torch.Tensor,
                          prior_gyro: float = 1e2, prior_acc: float = 1e10,
                          iters: int = 20, fix_scale: bool = False,
                          edge_valid=None) -> InertialInitResult:
    """R_wb [K, 3, 3], p_w [K, 3] (visual, up to scale); pres: [K-1]
    windows between consecutive keyframes; priors as the reference's
    schedule (priorG / priorA, LocalMapping.cc:236-244). edge_valid [K-1]:
    padded edges give no residual and their velocities are pinned. R_wg0
    is overridden by the least-squares seed, as in the JAX code."""
    out_dtype = R_wb.dtype
    f64 = lambda x: x.to(torch.float64)
    R_wb, p_w = f64(R_wb), f64(p_w)
    pres = Preintegrated(*[f64(x) for x in pres])
    dev = R_wb.device
    K = R_wb.shape[0]
    ev = (torch.ones(K - 1, dtype=torch.float64, device=dev)
          if edge_valid is None else f64(edge_valid))
    state_valid = (torch.cat([torch.ones(1, dtype=torch.float64, device=dev),
                              torch.maximum(ev[1:], ev[:-1]), ev[-1:]])
                   if K > 1 else torch.ones(K, dtype=torch.float64,
                                            device=dev))
    down = torch.tensor([0.0, 0.0, -9.81], dtype=torch.float64, device=dev)
    zero1 = torch.zeros(1, dtype=torch.float64, device=dev)
    info = factors.information_9(pres)                          # [K-1, 9, 9]
    L = torch.linalg.cholesky(
        info + 1e-8 * torch.eye(9, dtype=torch.float64, device=dev))
    LT = L.transpose(-1, -2)
    sq_g, sq_a = float(prior_gyro) ** 0.5, float(prior_acc) ** 0.5

    def unpack(theta, R_base):
        rwg = theta[..., 0:2]
        R_wg = R_base @ so3.exp(torch.cat(
            [rwg, zero1.expand(*rwg.shape[:-1], 1)], -1))
        s = (torch.ones_like(theta[..., 2]) if fix_scale
             else torch.exp(theta[..., 2]))
        v = theta[..., 9:].reshape(*theta.shape[:-1], K, 3)
        return R_wg, s, theta[..., 3:6], theta[..., 6:9], v

    def residuals(theta, R_base):
        R_wg, s, bg, ba, v = unpack(theta, R_base)
        g_w = _mv(R_wg, down)                                  # [..., 3]
        p = s[..., None, None] * p_w                          # [..., K, 3]
        r = factors.inertial_residual(
            R_wb[:-1], p[..., :-1, :], v[..., :-1, :], R_wb[1:],
            p[..., 1:, :], v[..., 1:, :], bg[..., None, :], ba[..., None, :],
            pres, g_w[..., None, :])
        rs = (_mv(LT, r) * ev[:, None]).reshape(*theta.shape[:-1], -1)
        pin = (10.0 * (1.0 - state_valid)[:, None] * v).reshape(
            *theta.shape[:-1], -1)
        return torch.cat([rs, sq_g * bg, sq_a * ba, pin], -1)

    # ---- stage 1: gyro bias from the rotation-only alignment ------------
    bg_est = estimate_gyro_bias(R_wb, pres, edge_valid=ev)

    # ---- stage 2: linear least squares for (s, g_w, v_k) ----------------
    nx = 4 + 3 * K
    dts = torch.clamp(pres.dT, min=1e-3)
    zero3 = torch.zeros(3, dtype=torch.float64, device=dev)
    Ri_T = R_wb[:-1].transpose(-1, -2)                         # [K-1, 3, 3]
    A = torch.zeros((K - 1, 6, nx), dtype=torch.float64, device=dev)
    ar = torch.arange(K - 1, device=dev)
    A[:, 0:3, 1:4] = -Ri_T * dts[:, None, None]
    A[:, 3:6, 0] = _mv(Ri_T, p_w[1:] - p_w[:-1])
    A[:, 3:6, 1:4] = -0.5 * Ri_T * (dts * dts)[:, None, None]
    cols = 4 + 3 * ar[:, None] + torch.arange(3, device=dev)[None, :]
    Av = A[:, 0:3].clone()
    Ap = A[:, 3:6].clone()
    # velocity columns of edge i: -R_i^T at state i, R_i^T at state i + 1
    Av.scatter_(2, cols[:, None, :].expand(-1, 3, -1), -Ri_T)
    Av.scatter_(2, (cols + 3)[:, None, :].expand(-1, 3, -1), Ri_T)
    Ap.scatter_(2, cols[:, None, :].expand(-1, 3, -1),
                -Ri_T * dts[:, None, None])
    bv = pre_mod.delta_velocity(pres, bg_est, zero3)
    bp = pre_mod.delta_position(pres, bg_est, zero3)
    A = (torch.cat([Av, Ap], 1) * ev[:, None, None]).reshape(-1, nx)
    b = (torch.cat([bv, bp], 1) * ev[:, None]).reshape(-1)
    x = _lstsq_min_norm(A, b)
    s_init = torch.clamp(x[0], 0.05, 50.0)
    g_init = x[1:4]
    R_wg0 = _rotation_between_down_and(
        g_init / torch.clamp(torch.linalg.norm(g_init), min=1e-9))

    n_var = 9 + 3 * K
    theta = torch.zeros(n_var, dtype=torch.float64, device=dev)
    if not fix_scale:
        theta[2] = torch.log(s_init)
    theta[3:6] = bg_est
    theta[9:] = x[4:]

    lam = torch.full((), 1e-3, dtype=torch.float64, device=dev)
    zeros_n = torch.zeros(n_var, dtype=torch.float64, device=dev)
    for _ in range(iters):
        # the damped step by QR of the stacked [J; sqrt(lam) diag] system
        # (the JAX code's form: the whitened Jacobian spans ~1e4 in scale)
        r, J = jacobian_fwd(lambda th: residuals(th, R_wg0), theta)
        col_norm = torch.clamp(torch.linalg.norm(J, dim=0), min=1e-6)
        J_aug = torch.cat([J, torch.sqrt(lam) * torch.diag(col_norm)], 0)
        r_aug = torch.cat([r, zeros_n], 0)
        q, R_ = torch.linalg.qr(J_aug)
        d = torch.linalg.solve_triangular(R_, (q.T @ r_aug)[:, None],
                                          upper=True)[:, 0]
        dn = torch.linalg.norm(d)
        d = d * torch.clamp(50.0 / torch.clamp(dn, min=1e-9), max=1.0)
        theta_new = theta - d
        c_new = torch.sum(residuals(theta_new, R_wg0) ** 2)
        better = (c_new < torch.sum(r * r)) & torch.isfinite(c_new)
        theta = torch.where(better, theta_new, theta)
        lam = torch.where(better, torch.clamp(lam * 0.3, min=1e-8),
                          torch.clamp(lam * 5.0, max=1e6))
    R_wg, s, bg, ba, v = unpack(theta, R_wg0)
    cost = torch.sum(residuals(theta, R_wg0) ** 2)
    o = lambda t: t.to(out_dtype)
    return InertialInitResult(o(R_wg), o(s), o(bg), o(ba), o(v), o(cost))
